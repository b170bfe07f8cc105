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

Under a mesh whose ``model`` axis divides the experts, the expert-parallel
path (:func:`_moe_ep`, the reference's ``_moe_ep_shardmap``) runs each
rank's local experts on its batch rows (``local_map``) and combines the
partial outputs with one all-reduce over ``model``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import shard_ctx
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
    # The stable sort has no DTensor strategy: each rank routes its rows.
    probs, top_p, top_e = shard_ctx.local(
        lambda x, w: _route(x, w, cfg), [("batch", None), (None, None)],
        [("batch", None)] * 3, x, params["router"])
    # Switch-style load-balance loss: E * sum_e f_e * p_e.
    e = cfg.num_experts
    me = probs.mean(dim=0)  # mean router prob per expert
    top1 = shard_ctx.local(lambda te: (te[:, :1] == torch.arange(e, device=te.device)).float(),
                           [("batch", None)], ("batch", None), top_e)
    fe = top1.mean(dim=0)  # top-1 share per expert
    return top_p, top_e, {"moe_aux_loss": e * (me * fe).sum()}


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ArchConfig):
    """(probs [T, E], top-k weights [T, k], top-k expert ids [T, k])."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)  # [T, E]
    # A stable descending sort puts the lower expert first among equal
    # probabilities, as ``jax.lax.top_k`` does (``torch.topk`` does not).
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]  # [T, k]
    if cfg.moe_renorm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def expert_capacity(tokens: int, cfg: ArchConfig) -> int:
    """Assignments each expert takes from ``tokens`` tokens."""
    return max(math.ceil(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts), 4)


def moe_ffn(params: Params, x: torch.Tensor, cfg: ArchConfig
            ) -> tuple[torch.Tensor, dict]:
    """x: [B, S, d] -> (y [B, S, d], aux: ``moe_aux_loss``,
    ``moe_dropped_frac``).

    Two strategies, as in the reference:

    * **expert-parallel** (under a mesh whose ``ep`` axis has more than one
      rank and divides the experts): each model rank dispatches and
      computes only its local experts' tokens from its batch rows, with a
      capacity sized from those rows, and the partial outputs sum over the
      ``ep`` axis; ``moe_dropped_frac`` is -1 (not tracked there);
    * **global**: one sort-and-scatter dispatch over every token.
    """
    b, s, d = x.shape
    rules = shard_ctx.current_rules()
    ep_axis = n_shards = None
    if rules is not None and rules.get("mesh") is not None:
        ep_axis = rules.get("ep") or rules.get("tp")
        n_shards = rules["sizes"].get(ep_axis, 0) if ep_axis else 0
    expert_parallel = bool(n_shards and n_shards > 1 and cfg.num_experts % n_shards == 0)
    if expert_parallel:
        # The router splits the b·s token rows over the batch's axes and
        # the path below places b rows there: the axes must divide b.
        daxes, dp = _batch_ranks(rules)
        if b % dp:
            raise ValueError(f"the expert-parallel MoE needs the batch ({b}) to divide over "
                             f"{daxes} ({dp} ranks)")
    xf = x.reshape(b * s, d)
    top_p, top_e, aux = router_probs(params, xf, cfg)
    if expert_parallel:
        k = cfg.top_k
        y = _moe_ep(params, x, top_p.reshape(b, s, k), top_e.reshape(b, s, k), cfg, rules,
                    ep_axis)
        aux = dict(aux, moe_dropped_frac=torch.tensor(-1.0))  # not tracked on this path
        if cfg.num_shared_experts:
            y = y + swiglu(params["shared"], x)
        return y, aux
    capacity = expert_capacity(b * s, cfg)
    return _dispatch_compute_combine(params, x, xf, top_p, top_e, aux, capacity, cfg)


def _batch_ranks(rules: dict) -> tuple[tuple, int]:
    """The mesh axes the rules' ``"batch"`` names (``launch.mesh.batch_axes``)
    and their product: the ranks the batch rows spread over."""
    sizes = rules["sizes"]
    batch = rules.get("batch", ())
    daxes = tuple(a for a in ((batch,) if isinstance(batch, str) else batch) if a in sizes)
    return daxes, int(np.prod([sizes[a] for a in daxes]))


def _moe_ep(params, x, top_p, top_e, cfg, rules, ep_axis):
    """Expert-parallel MoE (``local_map``): local dispatch on each rank,
    its partial output summed over ``ep_axis`` by DTensor (``Partial`` ->
    ``Replicate``), whose backward is right by construction."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..launch.sharding import placements

    mesh = rules["mesh"]
    daxes, dp = _batch_ranks(rules)
    n_shards = rules["sizes"][ep_axis]
    e = cfg.num_experts
    e_loc = e // n_shards
    k = cfg.top_k
    b, s, d = x.shape
    t_loc = max(1, b // dp) * s
    capacity = max(4, math.ceil(t_loc * k * cfg.capacity_factor / e))
    ep_dim = mesh.mesh_dim_names.index(ep_axis)
    bspec = ((daxes if len(daxes) > 1 else daxes[0]) if daxes else None,)
    rows = placements(bspec, mesh)  # batch over the data axes, replicated on ep
    experts = [Shard(0) if i == ep_dim else Replicate() for i in range(mesh.ndim)]
    out = [Partial() if i == ep_dim else q for i, q in enumerate(rows)]

    def per_shard(wg, wu, wd, x_loc, p_loc, e_idx_loc):
        my_first = mesh.get_local_rank(ep_axis) * e_loc
        return _experts(wg, wu, wd, x_loc, p_loc, e_idx_loc, my_first, e_loc, capacity, k)[0]

    y = shard_ctx.local_placed(per_shard, mesh, [experts] * 3 + [rows] * 3, out,
                               params["wg"], params["wu"], params["wd"], x, top_p, top_e)
    return y.redistribute(mesh, rows)


def _experts(wg, wu, wd, x, top_p, top_e, first, e_loc, capacity, k):
    """Experts ``first .. first + e_loc - 1`` on the tokens of ``x [B, S,
    d]``: assignments sorted by expert (a stable sort, as ``jnp.argsort``),
    positioned within their expert's segment, scattered into an ``[e_loc,
    C, d]`` buffer, pushed through the SwiGLU GEMMs and added back to their
    tokens with their weights.  Assignments to other experts go to the drop
    bucket ``e_loc``, as do those past an expert's capacity.  Returns (y
    [B, S, d], keep [T * k] in sorted order)."""
    b, s, d = x.shape
    t = b * s
    dev = x.device
    xt = x.reshape(t, d)
    local_e = top_e.reshape(t * k) - first
    bucket = torch.where((local_e >= 0) & (local_e < e_loc), local_e, e_loc)
    order = torch.argsort(bucket, stable=True)
    sorted_b = bucket[order]
    # the segment of bucket j starts after every assignment to a lower one
    starts = torch.searchsorted(sorted_b, torch.arange(e_loc + 1, device=dev))
    pos = torch.arange(t * k, device=dev) - starts[sorted_b]
    keep = (sorted_b < e_loc) & (pos < capacity)
    # ---- scatter tokens into [e_loc, C, d]; row e_loc takes the dropped ----
    dst_e = torch.where(keep, sorted_b, e_loc)
    dst_c = torch.where(keep, pos, 0)
    src_tok = order // k  # assignment i belongs to token i // k
    buf = x.new_zeros((e_loc + 1, capacity, d)).index_put((dst_e, dst_c), xt[src_tok])[:e_loc]
    # ---- batched expert GEMMs (SwiGLU) ----
    ct = x.dtype
    g = F.silu(torch.bmm(buf, wg.to(ct)))
    u = torch.bmm(buf, wu.to(ct))
    out_buf = torch.bmm(g * u, wd.to(ct))
    # ---- gather back + combine ----
    ya = out_buf[dst_e.clamp(max=e_loc - 1), dst_c]  # [T*k, d]
    ya = torch.where(keep[:, None], ya, 0.0)
    ya = ya * top_p.reshape(t * k)[order][:, None].to(ct)
    y = torch.zeros((t, d), dtype=ct, device=dev).index_add(0, src_tok, ya)
    return y.reshape(b, s, d), keep


def _dispatch_compute_combine(params, x, xf, top_p, top_e, aux, capacity, cfg):
    """The global path: every expert over every token.  Its dispatch
    (argsort, searchsorted, index_put) has no DTensor strategy, so under a
    mesh every rank runs it on the whole batch."""
    b, s, _ = x.shape
    k, e = cfg.top_k, cfg.num_experts

    def whole(x, top_p, top_e, wg, wu, wd):
        y, keep = _experts(wg, wu, wd, x, top_p, top_e, 0, e, capacity, k)
        return y, (~keep).float().sum() / (b * s * k)

    args = (x, top_p, top_e, params["wg"], params["wu"], params["wd"])
    y, dropped = shard_ctx.local(whole, [(None,) * t.dim() for t in args], [(None,) * 3, ()],
                                 *args)
    y = shard_ctx.constrain(y, ("batch", None, None))
    if cfg.num_shared_experts:
        y = y + swiglu(params["shared"], x)
    return y, dict(aux, moe_dropped_frac=dropped)
