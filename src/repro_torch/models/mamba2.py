"""Mamba2 (SSD) layer: chunked-parallel scan for full sequences and an O(1)
decode step, a port of the JAX package's ``models/mamba2.py``.

The chunked state-space-dual form: the work inside a chunk is dense
``[L, L]`` products, and the state between chunks is carried by a Python
loop over ``S / chunk`` chunks (``lax.scan`` in the reference).  All
statistics are float32.

Recurrence (per head h, state ``[P, N]``):
    h_t = exp(A_h * dt_t) * h_{t-1} + dt_t * x_t ⊗ B_t
    y_t = h_t C_t + D_h * x_t

Under a mesh the projections state their layouts
(``shard_ctx.column_product`` / ``row_product``), the scan runs on each
rank's rows and heads, and the out-projection's partial sums are reduced
into the residual's layout.  The projection's z/xBC/dt split and the conv's
x/B/C split do not fall on ``tp``'s shard boundaries, so those activations
gather over ``tp`` before the split.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import shard_ctx
from .layers import Params, _normal, pdtype, rms_norm_simple


def dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    return d_in, d_in // p, p, cfg.ssm_state


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d = cfg.d_model
    d_in, h, p, n = dims(cfg)
    conv_dim = d_in + 2 * n
    dt = pdtype(cfg)
    # dt_bias so that softplus(dt_bias) spans [1e-3, 1e-1] (standard init).
    u = torch.rand((h,), generator=gen, device=gen.device, dtype=torch.float32)
    dt_init = torch.exp(u * (np.log(0.1) - np.log(1e-3)) + np.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))  # inverse softplus
    return {
        "w_in": _normal(gen, (d, 2 * d_in + 2 * n + h), dt, device) / np.sqrt(d),
        "conv_w": _normal(gen, (cfg.ssm_conv_width, conv_dim), dt, device)
        / np.sqrt(cfg.ssm_conv_width),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "dt_bias": dt_bias.to(device=device, dtype=dt),
        "a_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32)).to(device=device, dtype=dt),
        "d_skip": torch.ones((h,), dtype=dt, device=device),
        "gate_norm": torch.ones((d_in,), dtype=dt, device=device),
        "w_out": _normal(gen, (d_in, d), dt, device) / np.sqrt(d_in),
    }


def _split_proj(params: Params, x: torch.Tensor, cfg: ArchConfig):
    d_in, h, p, n = dims(cfg)
    zxbcdt = shard_ctx.column_product(x, params["w_in"].to(x.dtype))
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., 2 * d_in + 2 * n:])


def _causal_conv(xbc: torch.Tensor, params: Params, cfg: ArchConfig) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: [B, S, C]."""
    # F.pad has no DTensor strategy in torch 2.11: under a mesh each rank
    # convolves its rows and channels.
    ch = ("batch", None, "tp")
    return shard_ctx.local(_causal_conv_local, [ch, (None, "tp"), ("tp",)], ch, xbc,
                           params["conv_w"].to(xbc.dtype), params["conv_b"].to(xbc.dtype))


def _causal_conv_local(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1]] * w[i] for i in range(width))
    return F.silu(out + b)


def _ssd_chunked(x: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
                 dt: torch.Tensor, a: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None = None):
    """Chunked SSD scan.  x [B, S, H, P], b_in/c_in [B, S, N], dt [B, S, H]
    (float32, after softplus), a [H] (float32, negative), h0 [B, H, P, N]
    initial state.  Returns (y [B, S, H, P], h_final [B, H, P, N])."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, f"seq {s} not divisible by chunk {chunk}"
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        rows = slice(c * chunk, (c + 1) * chunk)
        xk, bk, ck, dtk = (t[:, rows].float() for t in (x, b_in, c_in, dt))
        s_cum = torch.cumsum(dtk * a, dim=1)  # [B,L,H] inclusive log decay
        # intra-chunk: G[b,l,j,h] = (C_l . B_j) exp(s_l - s_j) dt_j, j <= l
        cb = torch.einsum("bln,bjn->blj", ck, bk)
        decay = s_cum[:, :, None, :] - s_cum[:, None, :, :]  # [B,l,j,H]
        # exp of -inf above the diagonal: zeros with a finite gradient
        gate = torch.exp(torch.where(tri[None, :, :, None], decay, -torch.inf))
        g = cb[..., None] * gate * dtk[:, None, :, :]
        y_intra = torch.einsum("bljh,bjhp->blhp", g, xk)
        # inter-chunk: y_l += exp(s_l) * C_l . h_prev
        y_inter = torch.einsum("bln,bhpn->blhp", ck, h_prev) * torch.exp(s_cum)[..., None]
        # state: h = exp(s_L) h_prev + sum_j exp(s_L - s_j) dt_j x_j B_j
        tail = torch.exp(s_cum[:, -1:, :] - s_cum)  # [B,L,H]
        dx = (tail * dtk)[..., None] * xk
        h_prev = (torch.einsum("blhp,bln->bhpn", dx, bk)
                  + torch.exp(s_cum[:, -1])[:, :, None, None] * h_prev)
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), h_prev


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence forward. x: [B, S, d] -> [B, S, d]."""
    d_in, h, p, n = dims(cfg)
    bsz, s, _ = x.shape
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc = _causal_conv(xbc, params, cfg)
    xs = xbc[..., :d_in].reshape(bsz, s, h, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    # Under a mesh the scan runs on each rank's rows and heads: its causal
    # mask and zero state are plain tensors with no DTensor form.
    tp = "tp" if shard_ctx.divides("tp", h) else None
    heads = ("batch", None, tp, None)
    rows = ("batch", None, None)
    y = shard_ctx.local(lambda *args: _ssd_chunked(*args, cfg.ssm_chunk)[0],
                        [heads, rows, rows, ("batch", None, tp), (tp,)], heads,
                        xs, xbc[..., d_in:d_in + n], xbc[..., d_in + n:], dt, a)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = rms_norm_simple(y.reshape(bsz, s, d_in) * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return shard_ctx.row_product(y, params["w_out"].to(x.dtype))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_mamba2_cache(cfg: ArchConfig, batch: int, dtype, device) -> Params:
    d_in, h, p, n = dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * n), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
    }


def mamba2_decode_step(params: Params, x: torch.Tensor, cfg: ArchConfig, cache: Params
                       ) -> tuple[torch.Tensor, Params]:
    """x: [B, 1, d] -> (y [B, 1, d], new cache). O(1) in context length."""
    d_in, h, p, n = dims(cfg)
    bsz = x.shape[0]
    z, xbc, dt_raw = _split_proj(params, x, cfg)  # [B,1,*]
    # conv over the cached window and this step
    hist = torch.cat([cache["conv"], xbc], dim=1)  # [B, W, C]
    w = params["conv_w"].to(x.dtype)
    xbc_t = F.silu(torch.einsum("bwc,wc->bc", hist, w) + params["conv_b"].to(x.dtype))
    xs = xbc_t[..., :d_in].reshape(bsz, h, p).float()
    b_in = xbc_t[..., d_in:d_in + n].float()
    c_in = xbc_t[..., d_in + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # [B, H]
    a = -torch.exp(params["a_log"].float())

    def ssm(xs, b_in, c_in, dt, a, state):
        upd = (dt[..., None] * xs)[..., None] * b_in[:, None, None, :]
        h_new = torch.exp(dt * a)[:, :, None, None] * state + upd
        return torch.einsum("bhpn,bn->bhp", h_new, c_in), h_new

    # Under a mesh the state update runs on each rank's rows and heads, as
    # the forward's scan does.
    tp = "tp" if shard_ctx.divides("tp", h) else None
    heads, rows = ("batch", tp, None), ("batch", None)
    y, h_new = shard_ctx.local(ssm, [heads, rows, rows, ("batch", tp), (tp,), heads + (None,)],
                               [heads, heads + (None,)], xs, b_in, c_in, dt, a, cache["ssm"])
    y = y + params["d_skip"].float()[None, :, None] * xs
    y = y.reshape(bsz, 1, d_in).to(x.dtype)
    y = rms_norm_simple(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    out = shard_ctx.row_product(y, params["w_out"].to(x.dtype))
    return out, {"conv": hist[:, 1:], "ssm": h_new}
