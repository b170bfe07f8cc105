"""Ranks for the VM's lane sharding (``mesh=``), over ``torch.distributed``.

The JAX package shards the VM's lanes over a single-controller ``Mesh``:
one program drives every device.  The port's VM is a host loop that reads
one value a dispatch, so one Python process per device runs its own slice
of the lanes (SPMD by rank), and the ranks agree on every dispatch through
one small integer all-reduce on a CPU ``gloo`` group (:func:`host_group`).
The reductions are integer sums, so every rank takes the same decisions
whichever backend the default group uses, and two ranks may share one card.

The caller starts the ranks: ``torchrun --nproc-per-node N`` (each process
calls ``torch.distributed.init_process_group``), or :func:`spawn`, which
starts ``n`` local processes with a ``file://`` rendezvous in a directory
the caller names and runs a function in each.

Nothing here starts a process or opens a group at import.
"""
from __future__ import annotations

import functools
import os
import pickle
import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

#: The mesh dimension the lane (batch) axis shards over.
LANE_AXIS = "lanes"


def world_size() -> int:
    """Ranks of the default process group; 0 when there is none."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` (set by ``torchrun``
    and :func:`spawn`), else its global rank."""
    env = os.environ.get("LOCAL_RANK")
    if env is not None:
        return int(env)
    return dist.get_rank() if world_size() else 0


def rank_device(device: Any = None) -> torch.device:
    """A sharded run's device: the caller's ``device``, else the card
    ``cuda:{local_rank % device_count}``, so that ranks beyond the host's
    cards share them (two ranks on a one-card host both use ``cuda:0``).
    No CUDA and no device raises, as :func:`repro_torch.device.resolve_device`
    does."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by default — "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def _world_id() -> int:
    """Identifies the default group, so that cached meshes and groups
    never outlive the process group they were made in."""
    return id(dist.group.WORLD)


@functools.lru_cache(maxsize=None)
def _rank_mesh(n: int, device_type: str, world: int):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(LANE_AXIS,))


def rank_mesh(n: int, device_type: str):
    """The 1-D ``DeviceMesh`` over ranks ``0..n-1`` with its dim named
    :data:`LANE_AXIS` (made once per process group and device type)."""
    return _rank_mesh(n, device_type, _world_id())


def mesh_ranks(mesh) -> tuple[int, ...]:
    """The global ranks of a 1-D mesh, in lane order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


@functools.lru_cache(maxsize=None)
def _host_group(ranks: tuple[int, ...], world: int):
    return dist.new_group(ranks=list(ranks), backend="gloo")


def host_group(mesh):
    """The CPU ``gloo`` group over a mesh's ranks, for the VM's host
    reductions (made once per mesh; every rank of the default group must
    reach the first call, as ``new_group`` requires)."""
    return _host_group(mesh_ranks(mesh), _world_id())


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` (host) summed over the mesh's ranks, in place; returns it."""
    dist.all_reduce(x, group=host_group(mesh))
    return x


def broadcast_float(mesh, value: float) -> float:
    """The first rank's ``value``, on every rank of the mesh."""
    t = torch.tensor([value], dtype=torch.float64)
    dist.broadcast(t, src=mesh_ranks(mesh)[0], group=host_group(mesh))
    return float(t[0])


def host_lanes(x: torch.Tensor) -> torch.Tensor:
    """The whole batch of a per-lane tensor, on the host: a ``DTensor``
    sharded over the lanes is all-gathered over its mesh's host group (a
    collective: every rank calls it); a plain tensor is copied to the CPU."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x.cpu()
    (place,) = x.placements
    if not isinstance(place, Shard):
        raise ValueError(f"host_lanes needs a lane-sharded DTensor, got {x.placements}")
    mesh = x.device_mesh
    local = x.to_local().cpu().contiguous()
    parts = [torch.empty_like(local) for _ in mesh_ranks(mesh)]
    dist.all_gather(parts, local, group=host_group(mesh))
    return torch.cat(parts, dim=place.dim)


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def _rank_main(rank: int, n: int, init_file: str, backend: str, devices: list,
               out_dir: str, fn: Callable, args: tuple) -> None:
    """One rank: join the group, run ``fn(rank, device, *args)`` on one
    CPU thread, write its result for the caller, leave the group."""
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        if dev.index is None or dev.index >= torch.cuda.device_count():
            raise ValueError(f"rank {rank} was given {dev}, which this host does not have "
                             f"({torch.cuda.device_count()} cards)")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=n)
    try:
        result = fn(rank, dev, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *, rendezvous_dir, backend: str,
          devices: Optional[Sequence] = None, args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``n`` new processes that form one
    process group, and return each rank's result, in rank order.

    ``fn`` must be importable by name (a module-level function), since each
    process starts from a fresh interpreter (``spawn``) and imports it.
    The group meets through a ``file://`` rendezvous in ``rendezvous_dir``
    (no port is opened, so several callers on one host do not collide).
    ``backend`` is the default group's (``"gloo"``, or ``"nccl"`` with one
    card a rank); it is the caller's choice, never switched here.  Rank
    ``r`` runs on ``devices[r]``, by default the card ``cuda:{r %
    device_count}``; each rank uses one CPU thread.  A rank that
    raises ends every rank and raises here with its traceback; so does a
    run past ``timeout`` seconds.
    """
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"spawn needs n >= 1 ranks, got {n}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n "
                               "to start ranks on the CPU")
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    base = Path(rendezvous_dir) / f"ranks-{uuid.uuid4().hex}"
    base.mkdir(parents=True)
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=n, join=False, start_method="spawn",
            args=(n, str(base / "rendezvous"), backend, [str(d) for d in devices],
                  str(base), fn, args))
        deadline = time.monotonic() + timeout
        try:
            # join() raises (and ends the other ranks) when a rank fails.
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} did not "
                                       f"finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        results = []
        for r in range(n):
            with open(base / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(base, ignore_errors=True)
