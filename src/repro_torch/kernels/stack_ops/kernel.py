"""ctypes binding of the hand-written CUDA stack kernels (``csrc/stack_ops.cu``).

``stack_ops_push`` replaces the Pallas TPU kernel
``src/repro/kernels/stack_ops/kernel.py:masked_push`` and ``stack_ops_pop``
replaces ``masked_peek`` of the same file.  Each launch takes a table of up
to :data:`MAX_ENTRIES` stacks (:data:`WORDS` int64 words each, named by
:data:`FIELDS`) and fuses the VM's pointer, overflow and select arithmetic around the
stack access; :func:`push` and :func:`pop` split a longer table into
several launches.  :func:`masked_push` and :func:`masked_peek`, the TPU
functions, are groups of one without those extras.  :mod:`.ops` validates
arguments and counts launches.

The library is built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels._build`), never at import.  Before any launch, a
failed build raises from :func:`library`, and a tensor not on a CUDA
device raises at the stream lookup.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from pathlib import Path
from typing import Optional

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "stack_ops.cu",)
MAX_ENTRIES = 16  # entries of one launch's table (kMaxEntries)
# The int64 words of one table entry, in the order of ``struct Entry``:
# device addresses (0 skips that part), the stack's depth, and sizes and
# lane strides in bytes.
FIELDS = ("stack", "ptr", "new_ptr", "top", "new_top", "src", "depth", "row_bytes",
          "top_stride", "src_stride")
WORDS = len(FIELDS)
STACK, PTR, NEW_PTR, TOP, NEW_TOP, SRC, DEPTH, ROW_BYTES, TOP_STRIDE, SRC_STRIDE = range(WORDS)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on the first call)."""
    lib = _build.load("stack_ops", SOURCES)
    lib.stack_ops_push.argtypes = [_P, _I, _P, _P, _I, _I, _P]
    lib.stack_ops_push.restype = _I
    lib.stack_ops_pop.argtypes = [_P, _I, _P, _I, _P]
    lib.stack_ops_pop.restype = _I
    return lib


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {code}")


def _launch(fn, words: list[int], *args) -> int:
    """Launch ``fn`` over the table ``words`` (WORDS ints an entry), in
    slices of MAX_ENTRIES entries; returns the number of launches."""
    table = struct.pack(f"<{len(words)}q", *words)
    step = 8 * WORDS * MAX_ENTRIES
    for off in range(0, len(table), step):
        part = table[off:off + step]
        _check(fn(part, len(part) // (8 * WORDS), *args), fn.__name__)
    return -(-len(table) // step)


def push(words: list[int], mask: int, overflow: int, max_depth: int, lanes: int,
         device: torch.device) -> int:
    """Push entries: ``stack[ptr, z] = top[z]`` where ``mask`` and ``0 <= ptr
    < D``, and where given ``new_top = where(mask, src, top)``, ``new_ptr =
    ptr + mask`` and ``overflow[z] = 1`` where ``mask & (ptr >= max_depth)``.
    Returns the number of launches."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    return _launch(lib.stack_ops_push, words, mask, overflow or None, max_depth, lanes, stream)


def pop(words: list[int], mask: Optional[int], lanes: int, device: torch.device) -> int:
    """Pop entries: ``new_ptr = ptr - mask`` and ``new_top = where(mask,
    stack[clamp(new_ptr)], top)``; with no mask every lane reads
    ``stack[clamp(ptr)]`` (masked_peek).  Returns the number of launches."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    return _launch(lib.stack_ops_pop, words, mask, lanes, stream)


def masked_push(stack: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor) -> int:
    """In place: ``stack[ptr[z], z] = val[z]`` where ``mask[z]`` and
    ``0 <= ptr[z] < D``.  stack ``[D, Z, F]``; val ``[Z, F]``; ptr int32
    and mask bool ``[Z]``; all contiguous CUDA tensors of one device."""
    library()
    d, z, f = stack.shape
    row = f * stack.element_size()
    words = [stack.data_ptr(), ptr.data_ptr(), 0, val.data_ptr(), 0, 0, d, row, row, 0]
    return push(words, mask.data_ptr(), 0, 0, z, stack.device)


def masked_peek(stack: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``out[z] = stack[clamp(ptr[z], 0, D - 1), z]``: stack ``[D, Z, F]``,
    ptr int32 ``[Z]`` -> a new ``[Z, F]`` tensor."""
    library()
    d, z, f = stack.shape
    out = torch.empty((z, f), dtype=stack.dtype, device=stack.device)
    row = f * stack.element_size()
    pop([stack.data_ptr(), ptr.data_ptr(), 0, 0, out.data_ptr(), 0, d, row, 0, 0], None, z,
        stack.device)
    return out
