"""ctypes binding of the hand-written CUDA decode attention
(``csrc/flash_decode.cu``), which replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode/kernel.py:decode_attention``.

It takes ``q [B, H, Dh]`` and the cache as it lies, ``k, v [B, W, Hkv,
Dh]``, read through their batch, row and head strides; :mod:`.ops`
validates arguments and counts launches.  The kernel splits the window
into chunks of :data:`CHUNK` rows, one CTA each (bf16 on the tensor
cores, float32 on the CUDA cores), and a second kernel combines the
chunks' partial softmax states (:func:`split_plan`).  The library is
built with ``nvcc`` at the first launch (see
:mod:`repro_torch.kernels._build`), never at import; a failed build raises
from :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
MAX_GROUP = 16  # query heads per KV head
CHUNK = 64  # cache rows per CTA; the kernel's kChunk

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on the first call)."""
    lib = _build.load("flash_decode", SOURCES)
    lib.flash_decode_fwd.argtypes = (
        [_P] * 6 + [_L] * 6 + [_I] * 7 + [ctypes.c_float, _I, _P]
    )
    lib.flash_decode_fwd.restype = _I
    return lib


class SplitPlan(NamedTuple):
    """How the window is cut: ``splits`` chunks of ``chunk`` rows; the
    kernel's grid is ``(kv_heads, batch, splits)``."""
    splits: int
    chunk: int
    grid: tuple


def split_plan(batch: int, kv_heads: int, window: int) -> SplitPlan:
    """The split of a ``window``-row cache: fixed by ``window`` alone, since
    ``count`` stays on the device; chunks past ``count`` exit at once, and
    one split needs no combine."""
    splits = -(-window // CHUNK)
    return SplitPlan(splits, CHUNK, (kv_heads, batch, splits))


def buffers(q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """What a launch allocates: the output ``[B, H, Dh]`` and the float32
    partials (acc[G, Dh], m, l) per (b, hk, split) for the combine (empty
    with one split).  A fake call allocates the same, so a step counted on
    fake tensors holds what the card holds."""
    b, h, dh = q.shape
    w, hk = k.shape[1], k.shape[2]
    splits = split_plan(b, hk, w).splits
    return torch.empty_like(q), torch.empty(
        b * hk * splits * (h // hk) * (dh + 2) if splits > 1 else 0, dtype=torch.float32,
        device=q.device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     count: torch.Tensor) -> torch.Tensor:
    """q contiguous ``[B, H, Dh]``; k, v ``[B, W, Hkv, Dh]`` with a
    contiguous last axis; count int32 ``[B]``; one CUDA device, one dtype
    in :data:`DTYPES`; base pointers and strides multiples of 16 bytes ->
    a new contiguous ``[B, H, Dh]``."""
    b, h, dh = q.shape
    w, hk = k.shape[1], k.shape[2]
    plan = split_plan(b, hk, w)
    out, part = buffers(q, k)
    code = library().flash_decode_fwd(
        out.data_ptr(), part.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        count.data_ptr(), *k.stride()[:3], *v.stride()[:3],
        b, w, h, hk, dh, plan.splits, plan.chunk, 1.0 / math.sqrt(dh), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"flash_decode_fwd launch failed with CUDA error {code}")
    return out
