"""ctypes binding of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), which replaces the Pallas TPU kernel
``src/repro/kernels/flash_attention/kernel.py:flash_attention``.

It takes the model's ``[B, S, H, Dh]`` / ``[B, T, Hkv, Dh]`` layout and
reads each operand through its strides; :mod:`.ops` validates arguments
and counts launches.  The library is built with ``nvcc`` at the first
launch (see :mod:`repro_torch.kernels._build`), never at import; a failed
build raises from :func:`library`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from .. import _build

SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
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
