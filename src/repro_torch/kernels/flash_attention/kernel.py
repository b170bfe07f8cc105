"""ctypes bindings of the hand-written CUDA flash attention, which
replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention``.

Two kernels, chosen by :func:`route` from the dtype alone:
``csrc/flash_attention_sm90.cu`` (bf16 at every head dim in
:data:`HEAD_DIMS`: TMA loads and ``wgmma`` on the tensor cores; a head dim
that is not a multiple of 64 runs at its padded width, 64 or 128, with
TMA's zero fill in the extra columns) and ``csrc/flash_attention.cu``
(float32: float32 FMAs on the CUDA cores).  Both
take the model's ``[B, S, H, Dh]`` / ``[B, T, Hkv, Dh]`` layout and read each
operand through its strides; :mod:`.ops` validates arguments and counts
launches.  Each library is built with ``nvcc`` at its first launch (see
:mod:`repro_torch.kernels._build`), never at import; a failed build raises
from :func:`library` or :func:`library_sm90`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu",)
SM90_SOURCES = (_CSRC / "flash_attention_sm90.cu",)
DTYPES = (torch.float32, torch.bfloat16)  # float32 on the CUDA cores, bf16 on the tensor cores
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
BLOCK = 64  # query and key rows per tile

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on the first call)."""
    lib = _build.load("flash_attention", SOURCES)
    lib.flash_attention_fwd.argtypes = (
        [_P] * 4 + [_L] * 9 + [_I] * 6 + [ctypes.c_float, _I, _P]
    )
    lib.flash_attention_fwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def library_sm90() -> ctypes.CDLL:
    """The built and loaded tensor-core kernel library (built on the first call)."""
    lib = _build.load("flash_attention_sm90", SM90_SOURCES)
    lib.flash_attention_sm90_fwd.argtypes = (
        [_P] * 4 + [_L] * 9 + [_I] * 6 + [ctypes.c_float, _I, _P]
    )
    lib.flash_attention_sm90_fwd.restype = _I
    return lib


def route(dtype: torch.dtype) -> str:
    """Which CUDA kernel takes operands of ``dtype``, at every head dim in
    :data:`HEAD_DIMS`: ``"sm90"`` (TMA + wgmma, bf16) or ``"cuda_cores"``
    (float32)."""
    return "sm90" if dtype == torch.bfloat16 else "cuda_cores"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """The CUDA-core kernel: q ``[B, S, H, Dh]``; k, v ``[B, T, Hkv, Dh]``,
    float32 on one CUDA device, last axis contiguous -> a new contiguous
    ``[B, S, H, Dh]``."""
    if q.dtype != torch.float32:
        raise TypeError(f"the CUDA-core kernel takes float32, got {q.dtype}")
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    code = library().flash_attention_fwd(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, s, t, h, hk, dh, 1.0 / math.sqrt(dh), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {code}")
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool) -> torch.Tensor:
    """The tensor-core kernel: q ``[B, S, H, Dh]``; k, v ``[B, T, Hkv, Dh]``,
    bf16 on one CUDA device with Dh in :data:`HEAD_DIMS`, base pointers
    and all strides but the last multiples of 16 bytes -> a new contiguous
    ``[B, S, H, Dh]``."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core kernel takes bfloat16, got {q.dtype}")
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    code = library_sm90().flash_attention_sm90_fwd(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, s, t, h, hk, dh, 1.0 / math.sqrt(dh), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code < 0:
        raise RuntimeError(f"flash_attention_sm90_fwd: cuTensorMapEncodeTiled failed "
                           f"with CUresult {-code}")
    if code != 0:
        raise RuntimeError(f"flash_attention_sm90_fwd launch failed with CUDA error {code}")
    return out
