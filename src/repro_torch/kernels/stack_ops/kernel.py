"""ctypes binding of the hand-written CUDA stack kernels (``csrc/stack_ops.cu``).

``masked_push`` replaces the Pallas TPU kernel
``src/repro/kernels/stack_ops/kernel.py:masked_push`` and ``masked_peek``
replaces ``masked_peek`` of the same file.  Both take flattened
``[D, Z, F]`` stacks; :mod:`.ops` flattens feature shapes, validates
arguments and counts launches.  The library is built with ``nvcc`` at the
first launch (see :mod:`repro_torch.kernels._build`), never at import.
Before any launch, a failed build raises from :func:`library`, and a tensor
not on a CUDA device raises at the stream lookup.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "stack_ops.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on the first call)."""
    lib = _build.load("stack_ops", SOURCES)
    lib.stack_ops_push.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.stack_ops_push.restype = _I
    lib.stack_ops_peek.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.stack_ops_peek.restype = _I
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {code}")


def masked_push(stack: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor) -> None:
    """In place: ``stack[ptr[z], z] = val[z]`` where ``mask[z]`` and
    ``0 <= ptr[z] < D``.  stack ``[D, Z, F]``; val ``[Z, F]``; ptr int32
    and mask bool ``[Z]``; all contiguous CUDA tensors of one device."""
    d, z, f = stack.shape
    code = library().stack_ops_push(
        stack.data_ptr(), ptr.data_ptr(), mask.data_ptr(), val.data_ptr(),
        d, z, f, stack.element_size(),
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    _check(code, "stack_ops_push")


def masked_peek(stack: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``out[z] = stack[clamp(ptr[z], 0, D - 1), z]``: stack ``[D, Z, F]``,
    ptr int32 ``[Z]`` -> a new ``[Z, F]`` tensor."""
    d, z, f = stack.shape
    out = torch.empty((z, f), dtype=stack.dtype, device=stack.device)
    code = library().stack_ops_peek(
        out.data_ptr(), stack.data_ptr(), ptr.data_ptr(),
        d, z, f, stack.element_size(),
        torch.cuda.current_stream(stack.device).cuda_stream,
    )
    _check(code, "stack_ops_peek")
    return out
