"""Mixture-of-experts FFN: shared + routed top-k experts (fine-grained), a
port of the JAX package's ``models/moe.py``.

Dispatch is sort-based with a static per-expert capacity: assignments are
sorted by expert id (a stable sort, as ``jnp.argsort``), positioned within
their expert's segment, scattered into an ``[E, C, d]`` buffer, pushed
through batched expert GEMMs, and added back to their tokens with their
combine weights.  Every shape is fixed by the input's shape: the capacity
is host arithmetic, so no read from the device enters a decode step.
Assignments past an expert's capacity are dropped, exactly those the
reference drops, and reported as ``moe_dropped_frac``.

The reference's expert-parallel ``shard_map`` path (``_moe_ep_shardmap``)
is ROADMAP item 14: the port runs on one device, and every entry point that
takes a mesh refuses it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import Params, _normal, init_swiglu, pdtype, swiglu


def init_moe(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = pdtype(cfg)
    p: Params = {
        "router": _normal(gen, (d, e), dt, device) / np.sqrt(d),
        "wg": _normal(gen, (e, d, ff), dt, device) / np.sqrt(d),
        "wu": _normal(gen, (e, d, ff), dt, device) / np.sqrt(d),
        "wd": _normal(gen, (e, ff, d), dt, device) / np.sqrt(ff),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_swiglu(gen, cfg, d, ff * cfg.num_shared_experts, device)
    return p


def router_probs(params: Params, x: torch.Tensor, cfg: ArchConfig):
    """x: [T, d] -> (weights [T, k], expert ids [T, k], aux metrics)."""
    logits = x.float() @ params["router"].float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # A stable descending sort puts the lower expert first among equal
    # probabilities, as ``jax.lax.top_k`` does (``torch.topk`` does not).
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]  # [T, k]
    if cfg.moe_renorm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    e = cfg.num_experts
    me = probs.mean(dim=0)  # mean router prob per expert
    experts = torch.arange(e, device=x.device)
    fe = (top_e[:, :1] == experts).float().mean(dim=0)  # top-1 share per expert
    return top_p, top_e, {"moe_aux_loss": e * (me * fe).sum()}


def expert_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Assignments each expert takes from ``tokens`` tokens."""
    return max(math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 4)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, d] -> (y [B, S, d], aux: ``moe_aux_loss``,
    ``moe_dropped_frac``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    top_p, top_e, aux = router_probs(params, xf, cfg)
    return _dispatch_compute_combine(params, x, xf, top_p, top_e, aux,
                                     expert_capacity(b * s, cfg), cfg)


def _dispatch_compute_combine(params, x, xf, top_p, top_e, aux, capacity, cfg):
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    e = cfg.num_experts
    dev = x.device
    # ---- sort assignments by expert id ----
    flat_e = top_e.reshape(t * k)  # assignment -> expert
    flat_w = top_p.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # position of each assignment within its expert's segment: the segment
    # of expert j starts after every assignment to a lower id
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < capacity
    # ---- scatter tokens into [E, C, d]; row E takes the dropped ones ----
    dst_e = torch.where(keep, sorted_e, e)
    dst_c = torch.where(keep, pos_in_e, 0)
    src_tok = order // k  # assignment i belongs to token i // k
    buf = x.new_zeros((e + 1, capacity, d)).index_put((dst_e, dst_c), xf[src_tok])[:e]
    # ---- batched expert GEMMs (SwiGLU) ----
    ct = x.dtype
    g = F.silu(torch.bmm(buf, params["wg"].to(ct)))
    u = torch.bmm(buf, params["wu"].to(ct))
    out_buf = torch.bmm(g * u, params["wd"].to(ct))
    # ---- gather back + combine ----
    y_assign = out_buf[dst_e.clamp(max=e - 1), dst_c]  # [T*k, d]
    y_assign = torch.where(keep[:, None], y_assign, 0.0)
    y_assign = y_assign * flat_w[order][:, None].to(ct)
    y = torch.zeros((t, d), dtype=ct, device=dev).index_add(0, src_tok, y_assign)

    aux = dict(aux, moe_dropped_frac=(~keep).float().sum() / (t * k))
    if cfg.num_shared_experts:
        y = y + swiglu(params["shared"], xf)
    return y.reshape(b, s, d), aux
