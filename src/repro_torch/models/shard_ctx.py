"""Activation-sharding context (a port of the JAX package's
``models/shard_ctx.py``): lets leaf modules (MoE dispatch, attention heads)
place activations without threading the launcher's configuration through
every call signature.

The launcher-facing entry is ``Model.axis_rules``; ``Model.forward``,
``loss`` and ``decode_step`` install it here for the duration of the call.
Rules::

    {"batch": ("pod", "data") | ("data",),   # launch.mesh.batch_axes
     "tp": "model", "ep": "model",
     "sizes": {axis: size}, "mesh": DeviceMesh}

``constrain(x, ("batch", None, "tp"))`` maps logical names to mesh axes,
drops entries whose dimension does not divide, and redistributes a DTensor
``x`` to those placements (``with_sharding_constraint``), its gradient
too; with no rules, or on a plain tensor, it returns ``x`` unchanged.
:func:`local` runs a leaf function on each rank's shards (``local_map``)
where an op has no DTensor sharding strategy.

Where the reference's specs fix a layout, the layers state it before the
product rather than leave it to DTensor's strategy choice, which may
replicate the batch and the weight (XLA's GSPMD does not):
:func:`column_product` and :func:`row_product` put the weight in its
product's layout (gathered over the FSDP axes, its ``tp`` dim kept), keep
a column-parallel output on ``("batch", ..., "tp")`` (:func:`hidden`) and
reduce a row-parallel output into the residual's ``("batch", None,
None)`` before it joins the residual (:func:`residual`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence

import torch

_RULES: contextvars.ContextVar = contextvars.ContextVar("repro_torch_axis_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: Optional[dict]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


def current_rules() -> Optional[dict]:
    return _RULES.get()


def _axes(rules: dict, name: str) -> Optional[tuple]:
    axes = rules.get(name)
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _divides(rules: dict, axes: tuple, size: int) -> bool:
    total = 1
    for a in axes:
        total *= rules["sizes"][a]
    return size % total == 0 and size >= total


def divides(name: str, *sizes: int) -> bool:
    """Whether the mesh axes of logical ``name`` divide every size (False
    with no rules or no such axis)."""
    rules = _RULES.get()
    axes = None if rules is None else _axes(rules, name)
    return axes is not None and all(_divides(rules, axes, n) for n in sizes)


def spec(shape: Sequence[int], logical: tuple, rules: dict) -> tuple:
    """The mesh spec of ``logical`` for ``shape``: each name's mesh axes
    where they divide the dimension, else ``None``."""
    out = []
    for dim, name in enumerate(logical):
        axes = None if name is None else _axes(rules, name)
        if axes is None or not _divides(rules, axes, shape[dim]):
            out.append(None)
        else:
            out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A plain tensor ``x`` that every rank holds whole, as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor (so that the two may
    meet in one op, forward and backward); else ``x``."""
    if not _is_dtensor(ref) or _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def constrain_strict(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """All-or-nothing constraint: apply only if EVERY named axis divides
    its dimension; otherwise leave ``x`` as it is (a partial constraint
    would pin the remaining dims to replicated)."""
    rules = _RULES.get()
    if rules is None:
        return x
    for dim, name in enumerate(logical):
        if name is None:
            continue
        axes = _axes(rules, name)
        if axes is None or not _divides(rules, axes, x.shape[dim]):
            return x
    return constrain(x, logical)


def constrain(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    rules = _RULES.get()
    if rules is None or not _is_dtensor(x):
        return x
    from ..launch.sharding import placements

    mesh = rules["mesh"]
    target = placements(spec(x.shape, logical, rules), mesh)
    y = x.redistribute(mesh, target)
    if tuple(x.placements) != tuple(y.placements):
        # The gradient takes the constrained layout too, as the cotangent of
        # with_sharding_constraint does: a redistribute's backward sends it
        # to the input's layout, where a partial sum stays partial, and a
        # second one, a no-op forward, reduces it first.
        y = y.redistribute(mesh, target)
    return y


def column_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a column-parallel weight ``[..., n]`` (it makes a
    hidden), pinned to ``("batch", ..., "tp")`` (:func:`hidden`).  Where the
    batch of ``x [B, ...]`` shards over the data axes, ``w`` takes its
    product's layout first: its columns over ``tp``, gathered over the FSDP
    axes (ZeRO-3's gather; its gradient reduce-scatters back), so the
    product keeps the batch's rows and the weight's columns with no
    collective and DTensor has no layout to choose.  Where the batch does
    not shard (one sequence), the FSDP shards stay: each data rank takes
    its slice of the contraction and the partial sums are reduced, as
    GSPMD does for an activation that small."""
    if divides("batch", x.shape[0]):
        w = constrain(w, (None,) * (w.dim() - 1) + ("tp",))
    return hidden(x @ w)


def row_product(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a row-parallel weight ``[n, ...]`` (a hidden's output
    projection), in the residual stream's layout (:func:`residual`).  Where
    the batch of ``h`` shards over the data axes, ``w`` takes its rows over
    ``tp``, gathered over the FSDP axes, first (see
    :func:`column_product`); the product is a partial sum over ``tp``."""
    if divides("batch", h.shape[0]):
        w = constrain(w, ("tp",) + (None,) * (w.dim() - 1))
    return residual(h @ w)


def split_contraction(x: torch.Tensor) -> torch.Tensor:
    """``x [B, ..., d]`` whose batch does not shard over the data axes (one
    sequence) with its last dim over them instead, so that its product
    with a weight the data axes do not shard (a decode step's unembedding)
    splits the contraction there, partial sums reduced after, rather than
    repeat on every data rank; else ``x``.  (A prefill's logits are too
    large to hold as partial sums.)"""
    if _RULES.get() is None or divides("batch", x.shape[0]):
        return x
    return constrain(x, (None,) * (x.dim() - 1) + ("batch",))


def hidden(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel product's output ``[B, ..., n]`` pinned to
    ``("batch", ..., "tp")``."""
    return constrain(x, ("batch",) + (None,) * (x.dim() - 2) + ("tp",))


def residual(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output ``[B, ..., d]`` in the residual
    stream's layout, ``("batch", None, ...)``: its partial sums over
    ``tp`` all-reduced before it joins the residual (Megatron's reduction
    after the row-parallel product), so no partial sum reaches a norm or
    the next product."""
    return constrain(x, ("batch",) + (None,) * (x.dim() - 1))


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding).  Under rules, with the table's rows
    (the vocabulary) over ``tp``, each rank looks up the ids in its rows
    and zeros the rest, and the ranks' outputs sum over ``tp``
    (``Partial``): DTensor's own lookup marks its output ``MaskPartial``,
    which a ``Partial`` gradient cannot be redistributed back to."""
    import torch.nn.functional as F

    rules = _RULES.get()
    if rules is None or not _is_dtensor(table):
        return F.embedding(ids.long(), table)
    from torch.distributed.tensor import Partial

    from ..launch.sharding import placements

    mesh = rules["mesh"]
    tspec = spec(table.shape, ("tp", None), rules)
    ispec = spec(ids.shape, ("batch",) + (None,) * (ids.dim() - 1), rules)
    vocab = tspec[0]
    if isinstance(vocab, tuple):
        raise ValueError(f"the embedding's rows shard over one mesh axis, got {vocab}")
    out = [Partial() if name == vocab else p
           for name, p in zip(mesh.mesh_dim_names, placements(ispec + (None,), mesh))]
    rows = table.shape[0] // (rules["sizes"][vocab] if vocab else 1)

    def fn(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        j = i.long() - (mesh.get_local_rank(vocab) * rows if vocab else 0)
        mine = (j >= 0) & (j < t.shape[0])
        return F.embedding(j.clamp(0, t.shape[0] - 1), t) * mine[..., None].to(t.dtype)

    return local_placed(fn, mesh, [placements(tspec, mesh), placements(ispec, mesh)], out,
                        table, ids)


def _nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    gold = torch.take_along_dim(logits, tgt[..., None], dim=-1)[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def token_nll(logits: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[tgt]`` per position in float32 (logits
    ``[B, S, V]``, targets ``[B, S]``).  Under rules, with the vocabulary
    over ``tp``, no rank gathers the logits: each rank reduces its own
    columns to a log-sum-exp and to the gold logit where the target falls
    in them (zero elsewhere); the log-sum-exps, ``[B, S, n]`` floats, are
    all-gathered over ``tp`` and the gold logits summed (``Partial``)."""
    rules = _RULES.get()
    if rules is None or not _is_dtensor(logits):
        return _nll(logits, tgt)
    from torch.distributed.tensor import Partial, Shard

    from ..launch.sharding import placements

    mesh = rules["mesh"]
    lspec = spec(logits.shape, ("batch", None, "tp"), rules)
    vocab, rows = lspec[-1], ("batch", None)
    if vocab is None:  # the vocabulary is whole on every rank
        return local(_nll, [("batch", None, None), rows], rows, logits, tgt)
    if isinstance(vocab, tuple):
        raise ValueError(f"the logits' vocabulary shards over one mesh axis, got {vocab}")
    rows_p = placements(lspec[:-1], mesh)
    vdim = mesh.mesh_dim_names.index(vocab)
    width = logits.shape[-1] // rules["sizes"][vocab]

    def part(lg: torch.Tensor, t: torch.Tensor):
        lg = lg.float()
        j = t.long() - mesh.get_local_rank(vocab) * width
        mine = (j >= 0) & (j < width)
        gold = torch.take_along_dim(lg, j.clamp(0, width - 1)[..., None], dim=-1)[..., 0]
        return torch.logsumexp(lg, dim=-1, keepdim=True), gold * mine

    lse, gold = local_placed(part, mesh, [placements(lspec, mesh), rows_p],
                             ([Shard(2) if d == vdim else q for d, q in enumerate(rows_p)],
                              [Partial() if d == vdim else q for d, q in enumerate(rows_p)]),
                             logits, tgt)
    # Each rank reduces its rows' n log-sum-exps, gathered over ``tp``.
    lse = local(lambda v: torch.logsumexp(v, dim=-1), [("batch", None, None)], rows, lse)
    return lse - gold.redistribute(mesh, rows_p)


def local(fn: Callable, in_logical: Sequence[Optional[tuple]], out_logical, *args):
    """``fn(*args)`` run on each rank's local shards: each DTensor argument
    is redistributed to its logical spec in ``in_logical`` (``None`` for an
    argument that is not a DTensor) and the result comes back as DTensors
    of ``out_logical``, one logical spec or a list of them for a tuple
    result.  An output dim is sharded over a mesh axis only where some
    input is, so a dimension that did not divide stays whole.  Without
    rules, or when no argument is a DTensor, it is ``fn(*args)``."""
    rules = _RULES.get()
    if rules is None or not any(_is_dtensor(a) for a in args):
        return fn(*args)
    from ..launch.sharding import placements

    mesh = rules["mesh"]
    in_p, used = [], set()
    for lg, a in zip(in_logical, args):
        if lg is None or not _is_dtensor(a):
            in_p.append(None)
            continue
        sp = spec(a.shape, lg, rules)
        used.update(ax for e in sp if e is not None for ax in ((e,) if isinstance(e, str) else e))
        in_p.append(placements(sp, mesh))

    def out_spec(lg: tuple) -> list:
        sp = []
        for name in lg:
            axes = None if name is None else _axes(rules, name)
            ok = axes is not None and all(ax in used for ax in axes)
            sp.append((axes if len(axes) > 1 else axes[0]) if ok else None)
        return placements(tuple(sp), mesh)

    out_p = (tuple(out_spec(lg) for lg in out_logical) if isinstance(out_logical, list)
             else out_spec(out_logical))
    return local_placed(fn, mesh, in_p, out_p, *args)


def local_placed(fn: Callable, mesh, in_placements: Sequence, out_placements, *args):
    """``local_map`` of ``fn`` with explicit placements, and the gradient
    placements that make its backward right: an input replicated over a
    mesh dim that another input is sharded over gets a ``Partial`` gradient
    there (each rank saw only its shard's contribution); elsewhere the
    gradient is placed as the input is (every rank computed the same)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    sharded = {d for p in in_placements if p is not None
               for d, q in enumerate(p) if not isinstance(q, Replicate)}
    grad_p = tuple(None if p is None else
                   [Partial() if isinstance(q, Replicate) and d in sharded else q
                    for d, q in enumerate(p)]
                   for p in in_placements)
    return local_map(fn, out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=grad_p, redistribute_inputs=True,
                     device_mesh=mesh)(*args)
