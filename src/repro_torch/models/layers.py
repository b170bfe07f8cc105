"""Foundational layers: norms, RoPE, GQA attention, FFNs, embeddings.

A port of the JAX package's ``models/layers.py`` with its conventions:

* Params are plain nested dicts of tensors, stored in ``cfg.param_dtype``
  and cast to ``cfg.compute_dtype`` at use sites.
* Sequence tensors are ``[batch, seq, ...]``; attention heads stay a
  separate axis ``[B, S, H, Dh]`` until the output projection.
* Softmax and norm statistics run in float32.
* KV caches are fixed-shape ring buffers ``{"k": [B, W, Hkv, Dh], "v": ...}``
  in the compute dtype, or with ``kv_cache_dtype="int8"`` symmetric int8
  rows ``k_q``/``v_q`` with a bf16 scale per position and head
  (``k_s``/``v_s`` ``[B, W, Hkv]``).
* Positions are ``[B, S]``, or ``[B, 3, S]`` (t, h, w) under M-RoPE
  (``cfg.mrope_sections``, the vlm family).

Under a mesh (``shard_ctx``) each product states the Megatron layout
(``shard_ctx.column_product`` / ``row_product``: the weight gathered over
the FSDP axes where the batch shards over them, its ``tp`` dim kept): the
column-parallel outputs (q, k, v, the FFN hidden) stay on ``("batch", ...,
"tp")`` and the row-parallel ones (``wo``, ``wd``, ``w2``) are all-reduced
into the residual's layout before they join it.  ``_project_qkv`` pins tensor
parallelism to the head axis where the heads divide; where ``tp`` does not
divide the heads, q, k and v gather their columns over ``tp`` and every
``tp`` rank computes the attention core of its batch rows over all heads,
as the reference does (its ``constrain_strict`` leaves them unconstrained).
Prefill attention goes through K3 when ``use_flash`` is set on a causal
layer with no ``seg_mask``, as in the reference; decode
attention always goes through K4, on the dequantized cache when it is int8
(the JAX package computes the same masked softmax in plain XLA there).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention import ops as flash_ops
from ..kernels.flash_decode import ops as decode_ops
from ..launch import op_cost
from . import shard_ctx

Params = dict
NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def pdtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def _normal(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ArchConfig, d: int, device) -> Params:
    p = {"scale": torch.ones((d,), dtype=pdtype(cfg), device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros((d,), dtype=pdtype(cfg), device=device)
    return p


def norm(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * params["scale"].float()
    return y.to(x.dtype)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: tuple[int, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables ``[B, S, Dh/2]`` for ``positions [B, S]``, or for
    ``[B, 3, S]`` under M-RoPE: the frequencies are split into
    ``mrope_sections`` and section ``i`` takes its angles from axis ``i``
    (t, h, w) of the positions."""
    half = head_dim // 2
    inv = (theta ** (-np.arange(0, half) * 2.0 / head_dim)).astype(np.float32)
    inv = torch.from_numpy(inv).to(positions.device)
    angles = positions[..., None].float() * inv  # [B, S, half] or [B, 3, S, half]
    if mrope_sections:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs [B, 3, S] positions, got {tuple(positions.shape)}")
        parts, start = [], 0
        for axis, sec in enumerate(mrope_sections):
            parts.append(angles[:, axis, :, start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. ``x``: [B, S, H, Dh]; cos/sin: [B, S, Dh/2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    h, hk = cfg.num_heads, cfg.num_kv_heads
    dt = pdtype(cfg)
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(h * dh)
    p: Params = {
        "wq": _normal(gen, (d, h * dh), dt, device) * scale_in,
        "wk": _normal(gen, (d, hk * dh), dt, device) * scale_in,
        "wv": _normal(gen, (d, hk * dh), dt, device) * scale_in,
        "wo": _normal(gen, (h * dh, d), dt, device) * scale_out,
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", hk * dh), ("bv", hk * dh)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dt, device=device)
    return p


def _project_qkv(params: Params, x: torch.Tensor, cfg: ArchConfig):
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    h, hk = cfg.num_heads, cfg.num_kv_heads
    ct = x.dtype
    q = shard_ctx.column_product(x, params["wq"].to(ct))
    k = shard_ctx.column_product(x, params["wk"].to(ct))
    v = shard_ctx.column_product(x, params["wv"].to(ct))
    if cfg.qkv_bias:
        q = q + params["bq"].to(ct)
        k = k + params["bk"].to(ct)
        v = v + params["bv"].to(ct)
    # Under a mesh whose tp axis does not divide the heads, the projection's
    # columns gather first: DTensor's view cannot split a sharded dim.
    q, k, v = (t if shard_ctx.divides("tp", n) else shard_ctx.constrain(t, ("batch", None, None))
               for t, n in ((q, h), (k, hk), (v, hk)))
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hk, dh)
    v = v.reshape(b, s, hk, dh)
    # Pin TP to the HEAD axis (when divisible), not Dh: a Dh-sharded
    # contraction turns every score block into an all-reduce.
    q = shard_ctx.constrain_strict(q, ("batch", None, "tp", None))
    k = shard_ctx.constrain_strict(k, ("batch", None, "tp", None))
    v = shard_ctx.constrain_strict(v, ("batch", None, "tp", None))
    if cfg.qk_norm:
        q = rms_norm_simple(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm_simple(k, params["k_norm"], cfg.norm_eps)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,S,H,Dh], k: [B,T,Hkv,Dh] -> scores [B,Hkv,G,S,T] (f32)."""
    b, s, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(b, s, hk, h // hk, dh)
    # Products of the compute dtype summed in f32 (preferred_element_type).
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) / np.sqrt(dh)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,Hkv,G,S,T] (f32), v: [B,T,Hkv,Dh] -> [B,S,H*Dh]."""
    b, hk, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hk * g * v.shape[-1])


def attention(params: Params, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, *, seg_mask: torch.Tensor | None = None,
              use_flash: bool = False) -> torch.Tensor:
    """Full-sequence attention (train and prefill); ``positions`` [B, S] or
    [B, 3, S] (M-RoPE).  Causality comes from ``cfg.causal``; ``seg_mask``
    ([B, S] bool, True where valid) masks padded keys.  With ``use_flash``
    a causal layer without ``seg_mask`` runs K3, the reference's rule."""
    q, k, v = _project_qkv(params, x, cfg)

    def core(q, k, v, positions, seg_mask):
        b, s = q.shape[:2]
        cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        with op_cost.scope("attn_core"):
            if use_flash and cfg.causal and seg_mask is None:
                return flash_ops.flash_attention(q, k, v, causal=True).reshape(b, s, -1)
            return _blocked_attention(q, k, v, causal=cfg.causal, seg_mask=seg_mask,
                                      q_chunk=cfg.attn_q_chunk)

    # Under a mesh the core runs on each rank's batch rows and heads: the
    # plain tensors it makes (RoPE tables, causal masks) have no DTensor form.
    tp = "tp" if shard_ctx.divides("tp", cfg.num_heads, cfg.num_kv_heads) else None
    heads = ("batch", None, tp, None)
    rows = ("batch",) + (None,) * (positions.dim() - 1)
    out = shard_ctx.local(core, [heads, heads, heads, rows, ("batch", None)],
                          ("batch", None, tp), q, k, v,
                          shard_ctx.replicate_like(positions, q),
                          None if seg_mask is None else shard_ctx.replicate_like(seg_mask, q))
    return shard_ctx.row_product(out, params["wo"].to(x.dtype))


def _blocked_attention(q, k, v, *, causal: bool, seg_mask: torch.Tensor | None,
                       q_chunk: int) -> torch.Tensor:
    """Row-blocked attention in plain PyTorch: static query chunks, so one
    ``[B, H, q_chunk, T]`` score block is live at a time; each query row
    still sees its whole softmax.  A row whose keys are all masked gets
    the uniform softmax over ``NEG_INF``, as in the reference."""
    b, s, h, dh = q.shape
    t = k.shape[1]
    qc = q_chunk
    while qc > 1 and s % qc:
        qc //= 2
    outs = []
    for i in range(s // qc):
        scores = _gqa_scores(q[:, i * qc:(i + 1) * qc], k)  # [B,Hkv,G,qc,T]
        if causal:
            rows = i * qc + torch.arange(qc, device=q.device)
            cmask = rows[:, None] >= torch.arange(t, device=q.device)[None, :]
            scores = torch.where(cmask, scores, NEG_INF)
        if seg_mask is not None:
            scores = torch.where(seg_mask[:, None, None, None, :], scores, NEG_INF)
        outs.append(_gqa_out(torch.softmax(scores, dim=-1), v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def init_kv_cache(cfg: ArchConfig, batch: int, window: int, dtype, device) -> Params:
    shape = (batch, window, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        # Symmetric int8 with a bf16 scale per (position, head).
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [..., Dh] -> (int8 values, bf16 scale over the last dim)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1) + 1e-8
    scale = (amax / 127.0).to(torch.bfloat16)
    # torch.round, like jnp.round, rounds half to even.
    q = torch.clamp(torch.round(xf / scale.float()[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """In the compute dtype directly, as the reference does (``|q| <= 127``
    converts exactly)."""
    return q.to(dtype) * scale.to(dtype)[..., None]


def attention_decode(params: Params, x: torch.Tensor, cfg: ArchConfig,
                     cache: Params, position: torch.Tensor
                     ) -> tuple[torch.Tensor, Params]:
    """One decode step against a ring cache.  x: [B, 1, d]; position: [B]
    absolute position of the new token.  Returns (out [B, 1, d], new cache).

    The new token's K/V go into ring slot ``position % W`` of a new cache
    (the cache passed in is not written), quantized first when the cache is
    int8; the attention core is one K4 call over the ``min(position + 1,
    W)`` slots written so far (of the dequantized cache when int8).  Under
    M-RoPE the token's position is the same on all three axes.  Under a
    mesh the core runs on each rank's batch rows and heads, as prefill's
    does: a cache placed otherwise (``cache_shardings`` puts ``model`` on
    the window) is redistributed to that layout first."""
    quantized = "k_q" in cache
    names = ("k_q", "k_s", "v_q", "v_s") if quantized else ("k", "v")
    q, k_new, v_new = _project_qkv(params, x, cfg)  # S = 1

    def core(q, k_new, v_new, position, *leaves):
        b, window = q.shape[0], leaves[0].shape[1]
        pos_rope = position[:, None]
        if cfg.mrope_sections:
            pos_rope = pos_rope[:, None].expand(b, 3, 1)
        cos, sin = rope_angles(pos_rope, cfg.resolved_head_dim, cfg.rope_theta,
                               cfg.mrope_sections)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        slot = (position % window).long()
        bidx = torch.arange(b, device=q.device)
        old = dict(zip(names, leaves))

        def write(name: str, row: torch.Tensor) -> torch.Tensor:
            return old[name].index_put((bidx, slot), row[:, 0])

        if quantized:
            (kq, ks), (vq, vs) = _quantize_kv(k_new), _quantize_kv(v_new)
            new = {"k_q": write("k_q", kq), "k_s": write("k_s", ks),
                   "v_q": write("v_q", vq), "v_s": write("v_s", vs)}
            k_cache = _dequantize_kv(new["k_q"], new["k_s"], q.dtype)
            v_cache = _dequantize_kv(new["v_q"], new["v_s"], q.dtype)
        else:
            k_cache, v_cache = write("k", k_new), write("v", v_new)
            new = {"k": k_cache, "v": v_cache}
        count = torch.clamp(position + 1, max=window).to(torch.int32)
        with op_cost.scope("attn_core"):
            out = decode_ops.decode_attention(q[:, 0], k_cache, v_cache, count)  # [B,H,Dh]
        return (out.reshape(b, 1, -1),) + tuple(new[n] for n in names)

    tp = "tp" if shard_ctx.divides("tp", cfg.num_heads, cfg.num_kv_heads) else None
    # The cache's batch rows may shard over fewer axes than the activations'
    # (``cache_batch``: ``data`` alone on a multi-pod mesh, as
    # ``cache_shardings`` places them); the core follows the cache.
    rules = shard_ctx.current_rules()
    heads = ("cache_batch" if rules and "cache_batch" in rules else "batch", None, tp, None)
    leaves = [cache[n] for n in names]
    cache_lg = [heads[:x.dim()] for x in leaves]
    outs = shard_ctx.local(core, [heads, heads, heads, heads[:1]] + cache_lg,
                           [(heads[0], None, tp)] + cache_lg, q, k_new, v_new,
                           shard_ctx.replicate_like(position, q), *leaves)
    # (the core's rows follow the cache's; the product's take the batch's)
    out = shard_ctx.row_product(shard_ctx.hidden(outs[0]), params["wo"].to(x.dtype))
    return out, dict(zip(names, outs[1:]))


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------


def init_swiglu(gen: torch.Generator, cfg: ArchConfig, d: int, d_ff: int, device) -> Params:
    dt = pdtype(cfg)
    return {
        "wg": _normal(gen, (d, d_ff), dt, device) / np.sqrt(d),
        "wu": _normal(gen, (d, d_ff), dt, device) / np.sqrt(d),
        "wd": _normal(gen, (d_ff, d), dt, device) / np.sqrt(d_ff),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    ct = x.dtype
    g = F.silu(shard_ctx.column_product(x, params["wg"].to(ct)))
    u = shard_ctx.column_product(x, params["wu"].to(ct))
    return shard_ctx.row_product(g * u, params["wd"].to(ct))


def init_gelu_mlp(gen: torch.Generator, cfg: ArchConfig, d: int, d_ff: int, device) -> Params:
    dt = pdtype(cfg)
    return {
        "w1": _normal(gen, (d, d_ff), dt, device) / np.sqrt(d),
        "b1": torch.zeros((d_ff,), dtype=dt, device=device),
        "w2": _normal(gen, (d_ff, d), dt, device) / np.sqrt(d_ff),
        "b2": torch.zeros((d,), dtype=dt, device=device),
    }


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    ct = x.dtype
    # jax.nn.gelu defaults to the tanh approximation.
    h = shard_ctx.column_product(x, params["w1"].to(ct))
    h = F.gelu(h + params["b1"].to(ct), approximate="tanh")
    return shard_ctx.row_product(h, params["w2"].to(ct)) + params["b2"].to(ct)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    dt = pdtype(cfg)
    p = {"embedding": _normal(gen, (cfg.vocab_size, cfg.d_model), dt, device) * 0.02}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_size), dt, device) / np.sqrt(cfg.d_model)
    return p


def embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return shard_ctx.lookup(params["embedding"].to(cdtype(cfg)), tokens)


def unembed(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = params["embedding"].to(x.dtype).T
    else:
        w = params["lm_head"].to(x.dtype)
    return x @ w
