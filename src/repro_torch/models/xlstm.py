"""xLSTM blocks: mLSTM (matrix memory, chunk-parallel) and sLSTM (scalar
memory, sequential) — arXiv:2405.04517; a port of the JAX package's
``models/xlstm.py``.

The mLSTM recurrence takes the same chunked-parallel form as SSD: the
terms inside a chunk are masked ``[L, L]`` products, and the state
``(C, n, m)`` between chunks is carried by a Python loop over chunks; the
exponential gating is max-stabilized in log space (float32).  The sLSTM
mixes its hidden state into the gates, so it runs as a Python loop over
time with block-diagonal per-head recurrent weights, one cell a token, as
the reference's ``lax.scan`` over time does; the gates' input products
and the weights' casts, which do not depend on the recurrence, are made
once before the loop.  On fake tensors (the dry-run) the loop is counted
per trip, as the reference's HLO counter counts a ``while`` loop
(:func:`_scan_per_trip`).

Maxima are ``torch.amax``/``torch.maximum``, whose gradients split ties
evenly, as ``jnp.max``/``jnp.maximum``'s do.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import fake
from ..configs.base import ArchConfig
from ..launch import op_cost
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


def _slstm_inputs(wg: torch.Tensor, bg: torch.Tensor, x: torch.Tensor, x_conv: torch.Tensor,
                  d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The gates' input pre-activations ``x @ W + b`` of every position at
    once (they do not depend on the recurrence): z/o read the raw input and
    i/f the conv-smoothed one (per paper), one ``[..., d] x [d, 2d]``
    product each.  Returns ``(zo, if_)``, each ``[..., 2, d]``."""
    zo = x @ torch.cat([wg[:, :d], wg[:, 3 * d:]], dim=1) + torch.cat([bg[:d], bg[3 * d:]])
    if_ = x_conv @ wg[:, d:3 * d] + bg[d:3 * d]
    return zo.unflatten(-1, (2, d)), if_.unflatten(-1, (2, d))


def _slstm_step(zo_t: torch.Tensor, if_t: torch.Tensor, r: torch.Tensor, state, cfg: ArchConfig):
    """One step of the recurrence from its input pre-activations ``zo_t``,
    ``if_t`` ``[B, 2, d]`` and the recurrent weights ``r`` ``[4, H, Dh, Dh]``
    (all in the compute dtype); state (c, n, h, m), each ``[B, d]``
    float32.  Returns the new state."""
    d = cfg.d_model
    h = cfg.num_heads
    c, n, hid, m = state
    # recurrent block-diagonal contribution from the previous hidden state
    rec = torch.einsum("bhp,ghpq->gbhq", hid.reshape(-1, h, d // h).to(r.dtype),
                       r).reshape(4, -1, d)
    r_z, r_i, r_f, r_o = rec.unbind(0)
    z_in, o_in = zo_t.unbind(-2)
    i_in, f_in = if_t.unbind(-2)
    # (x @ W + b) + rec, the reference's order of the sums; the rest in float32
    z_pre, i_pre, f_pre, o_pre = z_in + r_z, i_in + r_i, f_in + r_f, o_in + r_o
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
    return c_new, n_new, hid_new, m_new


def _slstm_cell(params: Params, cfg: ArchConfig, x_t, x_conv_t, state):
    """One sLSTM step (the decode step's).  x_t, x_conv_t: [B, d]; state
    (c, n, h, m), each [B, d] float32.  Returns (new state, hidden [B, d])."""
    wg, bg, r = (params[k].to(x_t.dtype) for k in ("w_gates", "b_gates", "r_gates"))
    zo, if_ = _slstm_inputs(wg, bg, x_t, x_conv_t, cfg.d_model)
    new = _slstm_step(zo, if_, r, state, cfg)
    return new, new[2]


def _slstm_out(params: Params, hid: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """Head norm and the GeGLU up/down projection (factor 4/3)."""
    y = rms_norm_simple(hid.to(dtype), params["head_norm"], cfg.norm_eps)
    up = y @ params["w_up"].to(dtype)
    half = up.shape[-1] // 2
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return y @ params["w_down"].to(dtype)


def _slstm_scan(x, x_conv, w_gates, b_gates, r_gates, cfg: ArchConfig) -> torch.Tensor:
    """The recurrence over time: hidden states ``[B, S, d]`` float32.  The
    weights' casts and the input products are made once, before the loop;
    each step runs the recurrent product and the elementwise cell."""
    s = x.shape[1]
    wg, bg, r = (w.to(x.dtype) for w in (w_gates, b_gates, r_gates))
    zo, if_ = _slstm_inputs(wg, bg, x, x_conv, cfg.d_model)
    zo_s, if_s = zo.unbind(1), if_.unbind(1)
    state = init_slstm_state(cfg, x.shape[0], x.device)
    if s >= 3 and fake.is_fake(x):
        return _scan_per_trip(zo_s, if_s, r, state, cfg)
    return _scan_steps(zo_s, if_s, r, state, cfg)


def _scan_steps(zo_s, if_s, r, state, cfg: ArchConfig) -> torch.Tensor:
    """Every step of the recurrence in turn: hidden states ``[B, S, d]``
    float32."""
    hs = []
    for zo_t, if_t in zip(zo_s, if_s):
        state = _slstm_step(zo_t, if_t, r, state, cfg)
        hs.append(state[2])
    return torch.stack(hs, dim=1)


def _scan_per_trip(zo_s, if_s, r, state, cfg: ArchConfig) -> torch.Tensor:
    """The scan's shape rule and trip count on fake tensors, as the
    reference's ``hlo_cost.py`` counts a ``while`` loop: the first and the
    last step run as they are (their backward differs: the first state
    takes no gradient, the last state feeds no next step), and one middle
    step, fed and read through :class:`_Tie` and :class:`_Fan`, stands for
    the ``S - 2`` others under :func:`op_cost.trips` (its ops, and its
    backward's, count ``S - 2`` times; what it leaves live, the hidden
    state and under autograd its saved tensors, counts ``S - 2`` times
    from the loop's end until freed).  The stack and the unbinds' backward
    see ``S`` distinct tensors, as in the real loop."""
    s = len(zo_s)
    state = _slstm_step(zo_s[0], if_s[0], r, state, cfg)
    hs = [state[2]]
    with op_cost.trips(s - 2) as trip:
        state = _slstm_step(_Tie.apply(*zo_s[1:-1]), _Tie.apply(*if_s[1:-1]), r, state, cfg)
    hs.append(state[2])
    state = _slstm_step(zo_s[-1], if_s[-1], r, state, cfg)
    trip.hold()
    return torch.stack([hs[0], *_Fan.apply(hs[1], s - 2), state[2]], dim=1)


class _Tie(torch.autograd.Function):
    """``xs[0]`` standing for every one of ``xs``; each gets the gradient
    (as an alias of its own).  Nothing it does is counted."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.n = len(xs)
        with op_cost.uncounted():
            return xs[0].view_as(xs[0])

    @staticmethod
    def backward(ctx, g):
        with op_cost.uncounted():
            return tuple(g.view_as(g) for _ in range(ctx.n))


class _Fan(torch.autograd.Function):
    """``n`` aliases of ``x``; the first one's gradient is ``x``'s.
    Nothing it does is counted."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.set_materialize_grads(False)
        with op_cost.uncounted():
            return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        return gs[0], None


def slstm_forward(params: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x_conv = _causal_conv(x, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype))
    # Under a mesh the recurrence runs on each rank's rows with whole
    # weights: its state starts as plain tensors with no DTensor form.
    rows = ("batch", None, None)
    hid = shard_ctx.local(lambda *a: _slstm_scan(*a, cfg),
                          [rows, rows, (None, None), (None,), (None,) * 4], rows,
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
