"""Model meshes: a 2-D or 3-D ``DeviceMesh`` over ranks (a port of the JAX
package's ``launch/mesh.py``).

A model mesh has the dims ``("data", "model")``, or ``("pod", "data",
"model")``: ``model`` carries tensor and expert parallelism, ``data``
FSDP and data parallelism, and a leading ``pod`` extends data parallelism.
One process a rank, as for the VM's lanes (``repro_torch.distributed``):
the caller starts the ranks and every rank runs the same program.  The
mesh's collectives use the default group's backend as the caller set it
(NCCL for one card a rank, ``gloo`` when ranks share a card).

:func:`make_production_mesh` is the deployment the dry-run models, on H100
nodes of 8 cards: ``(data 32, model 8)`` over 256 cards, or ``(pod 2,
data 32, model 8)`` over 512.  ``model`` is the 8 cards of one NVLink node
(tensor and expert parallelism stay inside a node); ``data`` and ``pod``
cross nodes over InfiniBand.  The card counts are the reference's (a TPU
v5e pod of 16 x 16 chips, and two pods), so per-card figures compare.

:func:`batch_axes` picks the data axes a batch shards over, and
:func:`axis_rules` gives a model its rules on a mesh.

Nothing here opens a group at import.
"""
from __future__ import annotations

import functools
import math

import numpy as np

from ..distributed import _world_id


@functools.lru_cache(maxsize=None)
def _make_mesh(shape: tuple, axes: tuple, device_type: str, world: int):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, np.arange(math.prod(shape)).reshape(shape).tolist(),
                      mesh_dim_names=axes)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``shape`` over ranks ``0..prod(shape)-1`` in
    row-major order, its dims named ``axes`` (made once per process group;
    every rank of the default group makes it together)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match its axes {axes}")
    return _make_mesh(shape, axes, device_type, _world_id())


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh on the default group the caller opened (the
    ``"fake"`` backend for a dry-run, NCCL on real nodes), which must have
    256 ranks, or 512 with ``multi_pod`` (a larger group lends its first
    ranks).  Like every mesh here it is cached per default group, so it
    never outlives the group it was made in."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def axis_sizes(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` or of a stand-in with
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes a global batch can shard over (the reference's rule shards it
    over all of them or none: :func:`batch_axes` picks)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def batch_axes(mesh, rows: int) -> tuple[str, ...]:
    """Axes a batch of ``rows`` rows shards over: the data axes
    (:func:`data_axes`) where their product divides ``rows``, else ``data``
    alone where it does, else the data axes again, which then divide
    nothing and leave the batch replicated (a rule never names an empty
    tuple: ``shard_ctx`` would take its product of 1 as dividing
    everything).

    The reference replicates a batch that the whole tuple does not divide.
    Its meshes (16 x 16, 2 x 16 x 16) never meet one at a shape's global
    batch, but the port's 2 x 32 x 8 does: 32 sequences over 64 data
    ranks.  There each pod holds every row and each data rank one, rather
    than every rank all 32.  Pods alone are never chosen: a batch over them
    would still be whole on each of a pod's data ranks, and the reference
    places such a batch whole at shapes it reaches (4 rows on 2 x 16 x 16).
    For every shape's global batch on the reference's meshes, and wherever
    the whole tuple divides, this is :func:`data_axes`."""
    sizes = axis_sizes(mesh)
    for axes in (data_axes(mesh), ("data",)):
        total = math.prod(sizes[a] for a in axes)
        if rows % total == 0 and rows >= total:
            return axes
    return data_axes(mesh)


def axis_rules(mesh, rows: int) -> dict:
    """A model's ``axis_rules`` (``models/shard_ctx.py``) on ``mesh`` for a
    batch of ``rows`` rows: the batch over :func:`batch_axes`, tensor and
    expert parallelism over ``model``."""
    return {"batch": batch_axes(mesh, rows), "tp": "model", "ep": "model",
            "sizes": axis_sizes(mesh), "mesh": mesh}


def num_chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))
