"""Sharding rules of the port: where each array lives on a device mesh.

For now only the VM's lane state (:func:`lane_shardings`); the parameter,
optimizer, batch and cache rules of the JAX package's ``launch/sharding.py``
come with model sharding (ROADMAP item 14).
"""
from __future__ import annotations


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
