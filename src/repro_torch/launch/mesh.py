"""Model meshes: a 2-D or 3-D ``DeviceMesh`` over ranks (a port of the JAX
package's ``launch/mesh.py``).

A model mesh has the dims ``("data", "model")``, or ``("pod", "data",
"model")``: ``model`` carries tensor and expert parallelism, ``data``
FSDP and data parallelism, and a leading ``pod`` extends data parallelism.
One process a rank, as for the VM's lanes (``repro_torch.distributed``):
the caller starts the ranks and every rank runs the same program.  The
mesh's collectives use the default group's backend as the caller set it
(NCCL for one card a rank, ``gloo`` when ranks share a card).

The reference's ``make_production_mesh`` models a TPU v5e pod (16 x 16
chips); its only caller is the dry-run, and it comes with that slice,
which fixes the H100 topology.

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


def axis_sizes(mesh) -> dict:
    """``{dim name: size}`` of a ``DeviceMesh`` or of a stand-in with
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple[str, ...]:
    """Axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def num_chips(mesh) -> int:
    return math.prod(tuple(mesh.shape))
