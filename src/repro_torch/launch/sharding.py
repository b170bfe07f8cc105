"""Sharding rules of the port: where each array lives on a device mesh (a
port of the JAX package's ``launch/sharding.py``).

Scheme (Megatron-style TP x FSDP, EP for MoE, pure DP across pods):

* logical axis ``tp``   -> mesh ``model``: attention head / FFN column /
  expert-hidden dimensions;
* logical axis ``fsdp`` -> mesh ``data`` (and ``pod``): every parameter's
  long non-TP dimension (ZeRO-3: params and optimizer state shard here);
* logical axis ``ep``   -> mesh ``model``: the expert axis of MoE weights;
* batch dims            -> ``("pod", "data")`` when multi-pod else
  ``("data",)``; on a mesh whose pods and data ranks together do not
  divide a batch, ``("data",)`` where it divides
  (:func:`~.mesh.batch_axes`);
* decode caches         -> the batch axis over ``data``, the largest other
  dim that divides over ``model``.

Rules are regex -> logical template, right-aligned onto the trailing dims
of each leaf (stacked layer axes lead and stay replicated); an axis that
does not divide its dimension is dropped (replicated).

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry a
tensor dim: ``None``, a mesh dim name, or a tuple of names.  The rules read
only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a stand-in of any size
answers them without starting ranks; :class:`NamedSharding` turns a spec
into DTensor placements on a real ``DeviceMesh`` (:func:`placements`), and
:func:`distribute` places a tree by its shardings.  :func:`lane_shardings`
places the VM's lane state.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.tree import tree_flatten, tree_flatten_with_path, tree_map, tree_unflatten
from .mesh import axis_sizes, batch_axes

PyTree = Any
Spec = tuple

# logical -> mesh axes (axes missing from the mesh are dropped, so "fsdp"
# is ZeRO across pods when the pod axis exists)
LOGICAL = {"tp": ("model",), "fsdp": ("pod", "data"), "ep": ("model",)}

# (regex over the flattened path, right-aligned logical template): the
# reference's rules, in its order.
PARAM_RULES: list[tuple[str, tuple]] = [
    # Embedding/unembedding shard the vocab dim only (sharding d_model over
    # `data` would conflict with the batch-sharded gather indices).
    (r"embed/embedding$", ("tp", None)),
    (r"embed/lm_head$", (None, "tp")),
    (r"^lm_head$", (None, "tp")),  # audio head
    # attention
    (r"attn/w[qkv]$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    (r"attn/[qk]_norm$", (None,)),
    # dense FFN (swiglu / gelu)
    (r"mlp/w[gu1]$", ("fsdp", "tp")),
    (r"mlp/w[d2]$", ("tp", "fsdp")),
    (r"mlp/b1$", ("tp",)),
    (r"mlp/b2$", (None,)),
    # MoE
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w[gu]$", ("ep", "fsdp", None)),
    (r"moe/wd$", ("ep", None, "fsdp")),
    (r"moe/shared/w[gu]$", ("fsdp", "tp")),
    (r"moe/shared/wd$", ("tp", "fsdp")),
    # mamba2
    (r"mamba/w_in$", ("fsdp", "tp")),
    (r"mamba/w_out$", ("tp", "fsdp")),
    (r"mamba/conv_w$", (None, "tp")),
    (r"mamba/conv_b$", ("tp",)),
    (r"mamba/(dt_bias|a_log|d_skip)$", ("tp",)),
    (r"mamba/gate_norm$", ("tp",)),
    # xlstm mLSTM
    (r"cell/w_up$", ("fsdp", "tp")),
    (r"cell/w[qkv]$", (None, "tp")),
    (r"cell/w_if$", (None, "tp")),
    (r"cell/b_if$", ("tp",)),
    (r"cell/conv_w$", (None, "tp")),
    (r"cell/conv_b$", ("tp",)),
    (r"cell/head_norm$", ("tp",)),
    (r"cell/w_down$", ("tp", "fsdp")),
    # xlstm sLSTM
    (r"cell/w_gates$", ("fsdp", "tp")),
    (r"cell/b_gates$", ("tp",)),
    (r"cell/r_gates$", (None, None, None, None)),
    # norms
    (r"(ln1|ln2|ln|final_norm)/(scale|bias)$", (None,)),
    # audio stub head adapter
    (r"head/w[12]$", ("fsdp", "tp")),
    (r"head/b[12]$", (None,)),
]


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: each mesh dim that a
    tensor dim names gets ``Shard(that dim)`` (a tuple of names shards the
    dim over each, in mesh order, so ``pod`` is the outer one), every other
    mesh dim ``Replicate()``.  A mesh dim of one rank holds the tensor whole
    whatever the spec names, so it stays ``Replicate()``: DTensor's views
    cannot carry a shard on a tensor dim of size 1, which a batch of one
    row over one data rank would be."""
    from torch.distributed.tensor import Replicate, Shard

    names, sizes = mesh.mesh_dim_names, axis_sizes(mesh)
    out = [Replicate() for _ in names]
    named: set = set()
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else entry or ()):
            if axis in named:
                raise ValueError(f"spec {spec} names mesh dim {axis!r} twice")
            named.add(axis)
            if sizes[axis] > 1:
                out[names.index(axis)] = Shard(dim)
    return out


def _path_str(path: tuple) -> str:
    """A leaf's path as the reference joins it: dict keys and sequence
    indices (``core.tree``'s ``[i]``) by ``/``."""
    return "/".join(p[1:-1] if p.startswith("[") and p.endswith("]") else p for p in path)


def _fit(template: tuple, shape: tuple, mesh) -> Spec:
    """Right-align the logical template onto the trailing dims; drop axes
    that do not divide the corresponding dim."""
    sizes = axis_sizes(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    k = len(template)
    if k > ndim:
        template = template[k - ndim:]
        k = ndim
    for i, logical in enumerate(template):
        dim = ndim - k + i
        if logical is None:
            continue
        axes = tuple(a for a in LOGICAL[logical] if a in sizes)
        if not axes:
            continue
        total = int(np.prod([sizes[a] for a in axes]))
        if shape[dim] % total == 0 and shape[dim] >= total:
            spec[dim] = axes if len(axes) > 1 else axes[0]
    return tuple(spec)


def param_spec(path_str: str, shape: tuple, mesh) -> Spec:
    for pattern, template in PARAM_RULES:
        if re.search(pattern, path_str):
            return _fit(template, shape, mesh)
    # default: FSDP-shard the largest dim if divisible
    if shape:
        sizes = axis_sizes(mesh)
        big = int(np.argmax(shape))
        if shape[big] % sizes["data"] == 0 and shape[big] >= sizes["data"]:
            spec: list = [None] * len(shape)
            spec[big] = "data"
            return tuple(spec)
    return ()


def param_shardings(params: PyTree, mesh) -> PyTree:
    """A :class:`NamedSharding` for each leaf of a parameter tree (of
    tensors, or of anything with a ``shape``)."""
    flat, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [
        NamedSharding(mesh, param_spec(_path_str(path), tuple(leaf.shape), mesh))
        for path, leaf in flat])


def opt_state_shardings(opt_state: PyTree, params: PyTree, mesh) -> PyTree:
    """ZeRO: ``mu``/``nu``/``error`` follow the parameters; ``step`` is
    replicated."""
    pshard = param_shardings(params, mesh)
    out = {"step": replicated(mesh)}
    for key in opt_state:
        if key != "step":
            out[key] = pshard
    return out


def batch_shardings(batch: PyTree, mesh) -> PyTree:
    """Shard the leading (batch) dim of every input over the axes
    :func:`~.mesh.batch_axes` gives its rows: (pod, data) where they
    divide, else data alone where it does, else replicated."""
    sizes = axis_sizes(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        if shape:
            axes = batch_axes(mesh, shape[0])
            total = int(np.prod([sizes[a] for a in axes]))
            if shape[0] % total == 0 and shape[0] >= total:
                entry = axes if len(axes) > 1 else axes[0]
                return NamedSharding(mesh, (entry,) + (None,) * (len(shape) - 1))
        return replicated(mesh)

    return tree_map(one, batch)


def cache_shardings(cache: PyTree, batch_size: int, mesh) -> PyTree:
    """Decode caches: the batch axis (found by its size) -> ``data``, the
    largest remaining dim that divides -> ``model``."""
    sizes = axis_sizes(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        for i, s in enumerate(shape):
            if s == batch_size and batch_size % sizes["data"] == 0 \
                    and batch_size >= sizes["data"]:
                spec[i] = "data"
                break
        cand, best = None, 0
        for i, s in enumerate(shape):
            if spec[i] is None and s % sizes["model"] == 0 and s >= sizes["model"] \
                    and s > best:
                cand, best = i, s
        if cand is not None:
            spec[cand] = "model"
        return NamedSharding(mesh, tuple(spec))

    return tree_map(one, cache)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def distribute(tree: PyTree, shardings: PyTree) -> PyTree:
    """Each tensor leaf of ``tree`` as a DTensor placed by the matching
    :class:`NamedSharding`.  Every rank holds the same logical array (the
    seeded weights, the deterministic stream, one checkpoint file), so each
    keeps its own shard and nothing is sent (``src_data_rank=None``).  A
    DTensor leaf is redistributed instead."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    leaves, treedef = tree_flatten(tree)
    shards = tree_flatten(shardings)[0]
    if len(shards) != len(leaves):
        raise ValueError(f"{len(shards)} shardings for {len(leaves)} leaves")
    out = []
    for x, sh in zip(leaves, shards):
        if isinstance(x, DTensor):
            x = x.redistribute(sh.mesh, sh.placements)
        elif isinstance(x, torch.Tensor):
            x = distribute_tensor(x, sh.mesh, sh.placements, src_data_rank=None)
        out.append(x)
    return tree_unflatten(treedef, out)


def lane_shardings(mesh) -> tuple:
    """``(lane, stack, replicated)`` placements of the pc VM's state on a
    1-D ``DeviceMesh``: ``[batch, ...]`` tops, pointers and masks shard
    their leading axis, ``[depth, batch, ...]`` stacks axis 1 (a depth is
    addressed per lane, never across lanes), and scalars and
    ``[num_blocks]`` counters replicate.  Each is a one-element list, as
    ``DTensor.from_local`` takes it."""
    from torch.distributed.tensor import Replicate, Shard

    if mesh.ndim != 1:
        raise ValueError(f"lane_shardings needs a 1-D mesh, got dims "
                         f"{mesh.mesh_dim_names or mesh.ndim}")
    return [Shard(0)], [Shard(1)], [Replicate()]
