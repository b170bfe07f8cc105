"""Fake tensors: shapes and dtypes without data.

Type inference and the verifier run each primitive on fake tensors
(:func:`fake_mode`), so a primitive is typed without being run — one
that would raise on zeros (an integer division by a zero-initialized
variable) types all the same.  A kernel wrapper that cannot take a fake
tensor (it launches through ``ctypes``) answers one with an empty tensor
of its output's shape (:func:`is_fake`).

``torch._subclasses.fake_tensor`` is private to PyTorch; this module is
the one place the port imports it.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode


def fake_mode() -> FakeTensorMode:
    """A mode in which new tensors are fake; real tensors a function
    closes over (weights, a data set) are faked where they are used."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def is_fake(*xs: torch.Tensor) -> bool:
    """Whether any of ``xs`` is a fake tensor."""
    return any(isinstance(x, FakeTensor) for x in xs)
