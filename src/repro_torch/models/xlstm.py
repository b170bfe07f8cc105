"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential) — arXiv:2405.04517; a port of the JAX package's
``models/xlstm.py``.

The mLSTM recurrence takes the same chunked-parallel form as SSD: the
terms inside a chunk are masked ``[L, L]`` products, and the state
``(C, n, m)`` between chunks is carried by a Python loop over chunks; the
exponential gating is max-stabilized in log space (float32).  The sLSTM
mixes its hidden state into the gates, so it runs as a Python loop over
time with block-diagonal per-head recurrent weights, one cell a token, as
the reference's ``lax.scan`` over time does.

Maxima are ``torch.amax``/``torch.maximum``, whose gradients split ties
evenly, as ``jnp.max``/``jnp.maximum``'s do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import shard_ctx
from .layers import Params, _normal, pdtype, rms_norm_simple

M_FLOOR = -1e30  # the stabilizer's value before any input


def mlstm_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.num_heads
    return d_in, h, d_in // h


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, then SiLU.  x: [B, S, C]."""
    # F.pad has no DTensor strategy in torch 2.11: under a mesh each rank
    # convolves its rows and channels.
    ch = ("batch", None, "tp")
    return shard_ctx.local(_causal_conv_local, [ch, (None, "tp"), ("tp",)], ch, x, w, b)


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    width = w.shape[0]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return F.silu(sum(pad[:, i:i + x.shape[1]] * w[i] for i in range(width)) + b)


def _conv_step(hist: torch.Tensor, params: Params, dtype) -> torch.Tensor:
    """The causal conv's output for the newest row of ``hist [B, W, C]``."""
    w = params["conv_w"].to(dtype)
    return F.silu(torch.einsum("bwc,wc->bc", hist, w) + params["conv_b"].to(dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    d_in, h, _ = mlstm_dims(cfg)
    dt = pdtype(cfg)
    return {
        "w_up": _normal(gen, (d, 2 * d_in), dt, device) / np.sqrt(d),
        "conv_w": _normal(gen, (cfg.ssm_conv_width, d_in), dt, device)
        / np.sqrt(cfg.ssm_conv_width),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=device),
        "wq": _normal(gen, (d_in, d_in), dt, device) / np.sqrt(d_in),
        "wk": _normal(gen, (d_in, d_in), dt, device) / np.sqrt(d_in),
        "wv": _normal(gen, (d_in, d_in), dt, device) / np.sqrt(d_in),
        "w_if": _normal(gen, (d_in, 2 * h), dt, device) / np.sqrt(d_in),
        # bias init: forget gates start open (+3), input gates mild (-1)
        "b_if": torch.cat([torch.full((h,), -1.0), torch.full((h,), 3.0)]).to(
            device=device, dtype=dt),
        "head_norm": torch.ones((d_in,), dtype=dt, device=device),
        "w_down": _normal(gen, (d_in, d), dt, device) / np.sqrt(d_in),
    }


def _split_heads(t: torch.Tensor, shape: tuple, h: int) -> torch.Tensor:
    """``t`` reshaped to ``shape``, its last dim split into ``h`` heads.
    Under a mesh whose tp axis does not divide the heads the projection's
    columns gather first, as in ``layers._project_qkv``: DTensor's view
    cannot split a sharded dim."""
    if not shard_ctx.divides("tp", h):
        t = shard_ctx.constrain(t, ("batch",) + (None,) * (t.dim() - 1))
    return t.reshape(shape)


def _mlstm_qkv_gates(params: Params, x: torch.Tensor, cfg: ArchConfig):
    d_in, h, p = mlstm_dims(cfg)
    bsz, s, _ = x.shape
    ct = x.dtype
    up = x @ params["w_up"].to(ct)
    x_part, z_part = up[..., :d_in], up[..., d_in:]
    x_conv = _causal_conv(x_part, params["conv_w"].to(ct), params["conv_b"].to(ct))
    q = _split_heads(x_conv @ params["wq"].to(ct), (bsz, s, h, p), h)
    k = _split_heads(x_conv @ params["wk"].to(ct), (bsz, s, h, p), h) / np.sqrt(p)
    v = _split_heads(x_part @ params["wv"].to(ct), (bsz, s, h, p), h)
    if_pre = (x_conv @ params["w_if"].to(ct) + params["b_if"].to(ct)).float()
    return q, k, v, z_part, if_pre[..., :h], _log_sigmoid(if_pre[..., h:]), x_conv


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """Stabilized chunk-parallel mLSTM.  q, k, v [B, S, H, P]; log_i/log_f
    [B, S, H] (float32).  Returns (h_out [B, S, H, P],
    state = (C [B, H, P, P], n [B, H, P], m [B, H]))."""
    bsz, s, h, p = q.shape
    nc = s // chunk
    assert nc * chunk == s
    dev = q.device
    if state is None:
        state = (torch.zeros((bsz, h, p, p), dtype=torch.float32, device=dev),
                 torch.zeros((bsz, h, p), dtype=torch.float32, device=dev),
                 torch.full((bsz, h), M_FLOOR, dtype=torch.float32, device=dev))
    c_prev, n_prev, m_prev = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    hs = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        q32, k32, v32 = (t[:, rows].float() for t in (q, k, v))
        li, lf = log_i[:, rows], log_f[:, rows]
        fcum = torch.cumsum(lf, dim=1)  # [B,L,H] inclusive
        # b[l,j] = Fcum_l - Fcum_j + log i_j   (j <= l)
        bmat = fcum[:, :, None, :] - fcum[:, None, :, :] + li[:, None, :, :]
        bmat = torch.where(tri[None, :, :, None], bmat, -torch.inf)
        m_inter = fcum + m_prev[:, None, :]
        m = torch.maximum(torch.amax(bmat, dim=2), m_inter)  # [B,L,H]
        m = torch.maximum(m, m.new_tensor(M_FLOOR))  # keep finite
        # intra-chunk attention-like term; exp(-inf) is 0 above the diagonal
        qkt = torch.einsum("blhp,bjhp->blhj", q32, k32)
        w_ = qkt * torch.exp(bmat.transpose(2, 3) - m[..., None])  # [B,l,h,j]
        num_intra = torch.einsum("blhj,bjhp->blhp", w_, v32)
        den_intra = w_.sum(dim=-1)  # [B,l,h]
        # inter-chunk contribution
        scale_inter = torch.exp(m_inter - m)  # [B,L,H]
        num_inter = torch.einsum("blhp,bhpq->blhq", q32, c_prev) * scale_inter[..., None]
        den_inter = torch.einsum("blhp,bhp->blh", q32, n_prev) * scale_inter
        den = den_intra + den_inter
        hs.append(((num_intra + num_inter)
                   / torch.maximum(den.abs(), torch.exp(-m))[..., None]).to(q.dtype))
        # ---- state update at the chunk's end ----
        f_tail = fcum[:, -1:, :] - fcum + li  # [B,L,H] log weight per j
        m_new = torch.maximum(torch.amax(f_tail, dim=1), fcum[:, -1] + m_prev)  # [B,H]
        w_state = torch.exp(f_tail - m_new[:, None, :])[..., None]  # [B,L,H,1]
        carry = torch.exp(fcum[:, -1] + m_prev - m_new)  # [B,H]
        c_prev = (carry[:, :, None, None] * c_prev
                  + torch.einsum("blhp,blhq->bhpq", k32 * w_state, v32))
        n_prev = carry[:, :, None] * n_prev + (k32 * w_state).sum(dim=1)
        m_prev = m_new
    return torch.cat(hs, dim=1), (c_prev, n_prev, m_prev)


def mlstm_forward(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    d_in, _, _ = mlstm_dims(cfg)
    bsz, s, _ = x.shape
    q, k, v, z_part, log_i, log_f, _ = _mlstm_qkv_gates(params, x, cfg)
    # Under a mesh the scan runs on each rank's rows and heads: its causal
    # mask and initial state are plain tensors with no DTensor form.
    h = q.shape[2]
    tp = "tp" if shard_ctx.divides("tp", h) else None
    heads, gates = ("batch", None, tp, None), ("batch", None, tp)
    h_out = shard_ctx.local(lambda *args: _mlstm_chunked(*args, cfg.ssm_chunk)[0],
                            [heads, heads, heads, gates, gates], heads,
                            q, k, v, log_i, log_f)
    y = rms_norm_simple(h_out.reshape(bsz, s, d_in), params["head_norm"], cfg.norm_eps)
    return (y * F.silu(z_part)) @ params["w_down"].to(x.dtype)


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d_in, h, p = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in), dtype=dtype, device=device),
        "c": torch.zeros((batch, h, p, p), **f32),
        "n": torch.zeros((batch, h, p), **f32),
        "m": torch.full((batch, h), M_FLOOR, **f32),
    }


def mlstm_decode_step(params: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params
                      ) -> tuple[torch.Tensor, Params]:
    """x: [B, 1, d] -> (y [B, 1, d], new cache). O(1) per token."""
    d_in, h, p = mlstm_dims(cfg)
    bsz = x.shape[0]
    ct = x.dtype
    up = x @ params["w_up"].to(ct)
    x_part, z_part = up[..., :d_in], up[..., d_in:]
    hist = torch.cat([cache["conv"], x_part], dim=1)
    x_conv = _conv_step(hist, params, ct)
    q = _split_heads(x_conv @ params["wq"].to(ct), (bsz, h, p), h).float()
    k = (_split_heads(x_conv @ params["wk"].to(ct), (bsz, h, p), h) / np.sqrt(p)).float()
    v = _split_heads(x_part[:, 0] @ params["wv"].to(ct), (bsz, h, p), h).float()
    if_pre = (x_conv @ params["w_if"].to(ct) + params["b_if"].to(ct)).float()
    log_i, log_f = if_pre[..., :h], _log_sigmoid(if_pre[..., h:])
    m_new = torch.maximum(log_f + cache["m"], log_i)  # [B,H]
    f_s = torch.exp(log_f + cache["m"] - m_new)[..., None]
    i_s = torch.exp(log_i - m_new)[..., None]
    c_new = f_s[..., None] * cache["c"] + i_s[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = f_s * cache["n"] + i_s * k
    num = torch.einsum("bhp,bhpq->bhq", q, c_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", q, n_new).abs(), torch.exp(-m_new))
    h_out = (num / den[..., None]).to(ct).reshape(bsz, 1, d_in)
    y = rms_norm_simple(h_out, params["head_norm"], cfg.norm_eps) * F.silu(z_part)
    return y @ params["w_down"].to(ct), {"conv": hist[:, 1:], "c": c_new, "n": n_new,
                                         "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    hidden = int(round(4.0 / 3.0 * d))
    dt = pdtype(cfg)
    return {
        "conv_w": _normal(gen, (cfg.ssm_conv_width, d), dt, device)
        / np.sqrt(cfg.ssm_conv_width),
        "conv_b": torch.zeros((d,), dtype=dt, device=device),
        # gate input projections: z, i, f, o stacked
        "w_gates": _normal(gen, (d, 4 * d), dt, device) / np.sqrt(d),
        "b_gates": torch.cat([torch.zeros((2 * d,)), torch.full((d,), 3.0),
                              torch.zeros((d,))]).to(device=device, dtype=dt),
        # block-diagonal recurrent weights per head: [4, H, Dh, Dh]
        "r_gates": _normal(gen, (4, h, dh, dh), dt, device) / np.sqrt(dh),
        "head_norm": torch.ones((d,), dtype=dt, device=device),
        "w_up": _normal(gen, (d, 2 * hidden), dt, device) / np.sqrt(d),
        "w_down": _normal(gen, (hidden, d), dt, device) / np.sqrt(hidden),
    }


def _slstm_cell(params: Params, cfg: ArchConfig, x_t, x_conv_t, state):
    """One sLSTM step.  x_t, x_conv_t: [B, d]; state (c, n, h, m), each
    [B, d] float32.  Returns (new state, hidden [B, d])."""
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    c, n, hid, m = state
    ct = x_t.dtype
    wg = params["w_gates"].to(ct)
    bg = params["b_gates"].to(ct)
    # recurrent block-diagonal contribution from the previous hidden state
    rec = torch.einsum("bhp,ghpq->gbhq", hid.reshape(-1, h, dh).to(ct),
                       params["r_gates"].to(ct)).reshape(4, -1, d)
    # z/o read the raw input; i/f read the conv-smoothed input (per paper)
    z_pre = x_t @ wg[:, :d] + bg[:d] + rec[0]
    i_pre = x_conv_t @ wg[:, d:2 * d] + bg[d:2 * d] + rec[1]
    f_pre = x_conv_t @ wg[:, 2 * d:3 * d] + bg[2 * d:3 * d] + rec[2]
    o_pre = x_t @ wg[:, 3 * d:] + bg[3 * d:] + rec[3]
    z = torch.tanh(z_pre.float())
    log_i = i_pre.float()
    log_f = _log_sigmoid(f_pre.float())
    o = torch.sigmoid(o_pre.float())
    m_new = torch.maximum(log_f + m, log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = f_s * n + i_s
    hid_new = o * (c_new / torch.maximum(n_new, n_new.new_tensor(1.0)))
    return (c_new, n_new, hid_new, m_new), hid_new


def _slstm_out(params: Params, hid: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """Head norm and the GeGLU up/down projection (factor 4/3)."""
    y = rms_norm_simple(hid.to(dtype), params["head_norm"], cfg.norm_eps)
    up = y @ params["w_up"].to(dtype)
    half = up.shape[-1] // 2
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return y @ params["w_down"].to(dtype)


def slstm_forward(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    bsz, s, _ = x.shape
    x_conv = _causal_conv(x, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))

    def scan(x, x_conv, w_gates, b_gates, r_gates):
        cell = {"w_gates": w_gates, "b_gates": b_gates, "r_gates": r_gates}
        state = init_slstm_state(cfg, x.shape[0], x.device)
        hs = []
        for t in range(s):
            state, hid = _slstm_cell(cell, cfg, x[:, t], x_conv[:, t], state)
            hs.append(hid)
        return torch.stack(hs, dim=1)

    # Under a mesh the recurrence runs on each rank's rows with whole
    # weights: its state starts as plain tensors with no DTensor form.
    rows = ("batch", None, None)
    hid = shard_ctx.local(scan, [rows, rows, (None, None), (None,), (None,) * 4], rows,
                          x, x_conv, params["w_gates"], params["b_gates"], params["r_gates"])
    return _slstm_out(params, hid, cfg, x.dtype)


def init_slstm_state(cfg: ArchConfig, batch: int, device):
    """(c, n, h, m), each [B, d] float32."""
    shape = (batch, cfg.d_model)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(shape, **f32), torch.zeros(shape, **f32), torch.zeros(shape, **f32),
            torch.full(shape, M_FLOOR, **f32))


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    c, n, hid, m = init_slstm_state(cfg, batch, device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, cfg.d_model), dtype=dtype,
                            device=device),
        "c": c, "n": n, "h": hid, "m": m,
    }


def slstm_decode_step(params: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params
                      ) -> tuple[torch.Tensor, Params]:
    """x: [B, 1, d] -> (y [B, 1, d], new cache)."""
    hist = torch.cat([cache["conv"], x], dim=1)

    def cell(x_t, x_conv_t, c, n, hid, m, w_gates, b_gates, r_gates):
        weights = {"w_gates": w_gates, "b_gates": b_gates, "r_gates": r_gates}
        return _slstm_cell(weights, cfg, x_t, x_conv_t, (c, n, hid, m))[0]

    # Under a mesh the cell runs on each rank's rows with whole weights, as
    # the forward's recurrence does.
    rows = ("batch", None)
    c, n, hid, m = shard_ctx.local(
        cell, [rows] * 6 + [(None, None), (None,), (None,) * 4], [rows] * 4,
        x[:, 0], _conv_step(hist, params, x.dtype), cache["c"], cache["n"], cache["h"],
        cache["m"], params["w_gates"], params["b_gates"], params["r_gates"])
    y = _slstm_out(params, hid[:, None, :], cfg, x.dtype)
    return y, {"conv": hist[:, 1:], "c": c, "n": n, "h": hid, "m": m}
