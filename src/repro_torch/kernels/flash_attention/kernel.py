"""ctypes bindings of the hand-written CUDA flash attention, which
replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention``.

Two kernels, chosen by :func:`route` from the dtype and head dim alone:
``csrc/flash_attention_sm90.cu`` (bf16, Dh 64 or 128: TMA loads and
``wgmma`` on the tensor cores) and ``csrc/flash_attention.cu`` (float32,
and bf16 with Dh 16, 32, 80 or 112: float32 FMAs on the CUDA cores).  Both
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
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 112, 128)
SM90_HEAD_DIMS = (64, 128)
BLOCK = 64  # query and key rows per tile

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built and loaded kernel library (built on the first call)."""
    lib = _build.load("flash_attention", SOURCES)
    lib.flash_attention_fwd.argtypes = (
        [_P] * 4 + [_L] * 9 + [_I] * 6 + [ctypes.c_float, _I, _I, _P]
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


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which CUDA kernel takes these operands: ``"sm90"`` (TMA + wgmma,
    bf16 with Dh 64 or 128) or ``"cuda_cores"`` (everything else)."""
    return "sm90" if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS else "cuda_cores"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """q ``[B, S, H, Dh]``; k, v ``[B, T, Hkv, Dh]`` on one CUDA device, of
    one dtype in :data:`DTYPES`, last axis contiguous -> a new contiguous
    ``[B, S, H, Dh]``."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    code = library().flash_attention_fwd(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, s, t, h, hk, dh, 1.0 / math.sqrt(dh), int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed with CUDA error {code}")
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool) -> torch.Tensor:
    """The tensor-core kernel: q ``[B, S, H, Dh]``; k, v ``[B, T, Hkv, Dh]``,
    bf16 on one CUDA device with Dh in :data:`SM90_HEAD_DIMS`, base pointers
    and all strides but the last multiples of 16 bytes -> a new contiguous
    ``[B, S, H, Dh]``."""
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
