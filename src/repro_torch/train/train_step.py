"""The train step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation and remat policies (a port of the JAX package's
``train/train_step.py``).

The step differentiates the compute copy of the weights
(``Model.cast_for_compute``: bf16 matmul weights when the model computes in
bf16) with autograd and lets AdamW update the float32 masters; the
gradient of a cast is a cast, so the two agree.  Microbatches run one
after another with one live activation set, and their gradients sum in
float32.  Metrics come back as tensors on the device: the caller decides
when to read them.

Under a mesh (``launch.train.build_trainer(mesh=)``) the parameters,
optimizer state and batch are DTensors: the same code runs on them, each
gradient is placed as its parameter is, and the metrics come back as the
plain replicated values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from ..core.tree import tree_flatten, tree_unflatten
from ..models.transformer import Model
from . import optimizer as opt

PyTree = Any


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    remat: str = "dots"  # none | full | dots
    opt: opt.OptimizerConfig = field(default_factory=opt.OptimizerConfig)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``[B, ...]`` -> ``n`` batches of ``[B/n, ...]`` along the batch axis:
    microbatch ``i`` holds rows ``[i B/n, (i+1) B/n)``, as the reference's
    ``reshape`` makes them (:func:`_microbatches`)."""
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not split into "
                             f"{n} microbatches")
    chunks = {name: _microbatches(x, n) for name, x in batch.items()}
    return [{name: c[i] for name, c in chunks.items()} for i in range(n)]


def _microbatches(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x [B, ...]`` as ``n`` microbatches of ``B/n`` rows.  A DTensor whose
    rows shard over ``dp`` ranks (the data axes) keeps them sharded: each
    microbatch is placed as ``x`` is, each rank holding ``B/(n dp)`` of its
    rows.  Rank ``r`` holds blocks ``r n .. r n + n - 1`` of ``m = B/(n dp)``
    rows, and block ``f`` belongs to microbatch ``f // dp`` on rank ``f %
    dp``: one all-to-all over the data axes moves every block there (a
    rank's rows for the whole step, never a whole microbatch; ``chunk``
    would gather it).  Rows that do not divide so raise ``ValueError``."""
    from torch.distributed.tensor import DTensor, Shard

    rows = ([d for d, p in enumerate(x.placements) if p == Shard(0)]
            if isinstance(x, DTensor) else [])
    if n == 1 or not rows:
        return list(x.chunk(n))
    mesh = x.device_mesh
    dp = math.prod(mesh.size(d) for d in rows)
    if x.shape[0] % (n * dp):
        raise ValueError(f"{x.shape[0]} rows over {dp} data ranks do not split into {n} "
                         f"microbatches of whole rows a rank")
    import torch.distributed._functional_collectives as fc

    names = [mesh.mesh_dim_names[d] for d in rows]
    me = 0
    for name in names:  # this rank among the dp ranks, the outer axis first
        me = me * mesh.size(mesh.mesh_dim_names.index(name)) + mesh.get_local_rank(name)
    group = mesh[names[0]] if len(names) == 1 else mesh[tuple(names)]._flatten()
    m = x.shape[0] // (n * dp)
    local = x.to_local()
    send = sorted(range(n), key=lambda t: ((me * n + t) % dp, t))  # blocks by destination
    sent = [sum((me * n + t) % dp == r for t in range(n)) * m for r in range(dp)]
    got = [sum((src * n + t) % dp == me for t in range(n)) * m for src in range(dp)]
    blocks = local.reshape((n, m) + tuple(local.shape[1:]))[send].flatten(0, 1)
    out = fc.all_to_all_single(blocks, got, sent, group)
    out = out.wait() if isinstance(out, fc.AsyncCollectiveTensor) else out
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(out[i * m:(i + 1) * m], mesh, x.placements, run_check=False,
                               shape=shape, stride=stride) for i in range(n)]


def make_loss_fn(model: Model, cfg: TrainConfig) -> Callable:
    def loss_fn(params: PyTree, batch: dict):
        return model.loss(params, batch, remat=cfg.remat)

    return loss_fn


def _value_and_grad(loss_fn: Callable, params: PyTree, batch: dict):
    """``((loss, aux), grads)`` of ``loss_fn`` at ``params`` by autograd on
    detached leaves (the caller's tensors are not marked); loss and aux
    are detached."""
    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    aux = {k: v.detach() for k, v in aux.items()}
    return (loss.detach(), aux), tree_unflatten(treedef, [
        _placed_as(g, x) for g, x in zip(grads, leaves)])


def _placed_as(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient on its parameter's placements (a partial sum is
    reduced there); a plain one as it is."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and tuple(g.placements) != tuple(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def _plain(x):
    """A replicated DTensor metric as the plain tensor every rank holds."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(model: Model, cfg: TrainConfig) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the inputs are not written."""
    loss_fn = make_loss_fn(model, cfg)

    def step(params_master: PyTree, opt_state: PyTree, batch: dict):
        params = model.cast_for_compute(params_master)
        if cfg.microbatches > 1:
            gsum = None
            lsum = 0.0
            for mb in _split_microbatches(batch, cfg.microbatches):
                (loss, aux), g = _value_and_grad(loss_fn, params, mb)
                g32 = [x.to(torch.float32) for x in tree_flatten(g)[0]]
                gsum = g32 if gsum is None else [a + b for a, b in zip(gsum, g32)]
                lsum = lsum + loss
            treedef = tree_flatten(params)[1]
            grads = tree_unflatten(treedef, [g / cfg.microbatches for g in gsum])
            loss = lsum / cfg.microbatches
        else:
            (loss, aux), grads = _value_and_grad(loss_fn, params, batch)
        new_params, opt_state, metrics = opt.apply_updates(params_master, grads, opt_state,
                                                           cfg.opt)
        metrics = dict(metrics, loss=loss, **aux)
        return new_params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return step


def make_eval_step(model: Model, cfg: TrainConfig) -> Callable:
    loss_fn = make_loss_fn(model, cfg)

    def step(params: PyTree, batch: dict):
        with torch.no_grad():
            loss, aux = loss_fn(params, batch)
        return dict(aux, loss=loss)

    return step
