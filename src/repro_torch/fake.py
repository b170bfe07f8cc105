"""Fake tensors: shapes and dtypes without data.

Type inference and the verifier run each primitive on fake tensors
(:func:`fake_mode`), so a primitive is typed without being run — one
that would raise on zeros (an integer division by a zero-initialized
variable) types all the same.  A kernel wrapper that cannot take a fake
tensor (it launches through ``ctypes``) answers one with an empty tensor
of its output's shape (:func:`is_fake`).  The dry-run
(:mod:`repro_torch.launch.dryrun`) models the card's step on ``meta``
tensors (:func:`build_meta`) within :func:`modeling`, where they count as
fake: a fake ``cuda`` tensor cannot be indexed on a build of PyTorch
without CUDA, and DTensor's sharding propagation cannot run under a fake
mode everywhere.  Elsewhere a meta tensor is not fake (tests stand it in
for a card's).

:func:`open_fake_group` opens a process group of the ``"fake"`` backend:
one process stands for every rank of a large world, and its collectives
move nothing, so the dry-run builds a production ``DeviceMesh`` (256 or
512 ranks) in one process.

``torch._subclasses.fake_tensor`` and the fake process group's store
(``torch.testing._internal.distributed.fake_pg``) are private to PyTorch;
this module is the one place the port imports them.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode


def fake_mode() -> FakeTensorMode:
    """A mode in which new tensors are fake; real tensors a function
    closes over (weights, a data set) are faked where they are used."""
    return FakeTensorMode(allow_non_fake_inputs=True)


_MODELING = contextvars.ContextVar("repro_torch_modeling", default=False)


@contextlib.contextmanager
def modeling():
    """Within, a ``meta`` tensor counts as fake (:func:`is_fake`)."""
    token = _MODELING.set(True)
    try:
        yield
    finally:
        _MODELING.reset(token)


def is_fake(*xs: torch.Tensor) -> bool:
    """Whether any of ``xs`` is a fake tensor (within :func:`modeling`, or
    a meta tensor)."""
    if _MODELING.get():
        return any(isinstance(x, FakeTensor) or x.is_meta for x in xs)
    return any(isinstance(x, FakeTensor) for x in xs)


def build_meta(make):
    """What ``make()`` builds (a parameter tree, a cache) with each tensor
    leaf as a meta tensor of its shape, strides and dtype: ``make`` runs
    under :func:`fake_mode`, so seeded draws allocate and compute nothing."""
    from .core.tree import tree_map

    with fake_mode():
        tree = make()
    return tree_map(lambda x: torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                                  dtype=x.dtype, device="meta")
                    if isinstance(x, torch.Tensor) else x, tree)


def open_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``world_size``-rank default
    group on the ``"fake"`` backend (nothing is sent; collectives answer at
    once).  A default group that is already open raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
