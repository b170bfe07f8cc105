"""Splittable counter-based random numbers: threefry-2x32 as tensor ops.

NUTS draws inside its primitives from splittable keys, as the JAX package
does with ``jax.random``.  This module reproduces JAX's default
implementation bit for bit — the ``threefry2x32`` hash with JAX's
*partitionable* counter layout (``jax_threefry_partitionable=True``, the
default of JAX 0.9) and its float transforms — so equal keys give equal
draws in both packages:

* ``split(key, n)[i] = threefry(key, (0, i))`` as a word pair;
* ``fold_in(key, d) = threefry(key, (0, d))`` for 32-bit data ``d``;
* ``random_bits(key, shape)[i] = w0 ^ w1`` of ``threefry(key, (0, i))``
  over the flat index ``i``;
* ``uniform``: the top 23 bits as the mantissa of a float in ``[1, 2)``,
  minus one, scaled, then ``max(minval, .)``; in bfloat16 (7 mantissa
  bits) JAX draws 8 bits, the low byte of the word, and keeps its top 7,
  and the arithmetic runs in bfloat16;
* ``bernoulli``: ``uniform < p``;
* ``randint``: higher and lower 32-bit words from the two halves of a
  split, folded into ``[minval, maxval)`` with JAX's span multiplier in
  unsigned 32-bit arithmetic;
* ``normal``: ``sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1))``, with
  XLA's float32 ``erfinv`` polynomial (``ErfInv32``) written as tensor ops;
  in bfloat16 the uniform draw is bfloat16 (see above), ``erfinv`` runs in
  float32 and is rounded to bfloat16, and the product is bfloat16's.

A key is a ``[2]`` tensor of **int32 bit patterns** (JAX keeps uint32; the
bits are the same).  Arithmetic runs in int64 masked to 32 bits.  Every
function is pure tensor code on one key, so ``torch.func.vmap`` maps it
over a batch of keys.  A float32 ``normal`` matches JAX to a few ulp, not
bit for bit: the polynomial is XLA's, but ``log1p`` is PyTorch's (and XLA
fuses the polynomial's steps into FMAs).  A bfloat16 ``normal`` is bit for
bit JAX's: its uniform draw takes one of 128 values, and each gives JAX's
bfloat16 after the float32 ``erfinv`` is rounded.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values, in int64."""
    return x.to(torch.int64) & _M32


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 -> the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under key
    ``(k1, k2)``; all unsigned 32-bit values held in int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    k = _u32(key)
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(tuple(shape))
    hi = torch.zeros_like(lo)
    return threefry2x32(k[0], k[1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, ``[num, 2]`` int32 (``jax.random.split``)."""
    b1, b2 = _hash_iota(key, (num,))
    return _as_i32(torch.stack([b1, b2], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """A new key from ``key`` and 32-bit ``data`` (``jax.random.fold_in``);
    ``data`` is an int or a scalar integer tensor, taken modulo 2**32."""
    k = _u32(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _M32
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return _as_i32(torch.stack([b1, b2]))


def random_bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """32 random bits per element as unsigned values in int64."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int] = (), minval=0.0,
            maxval=1.0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """float32 or bfloat16 uniform on ``[minval, maxval)``
    (``jax.random.uniform``)."""
    bits = random_bits(key, shape)
    if dtype == torch.float32:
        # bitcast(bits >> 9 | 0x3F800000) - 1 is exactly mantissa * 2**-23.
        floats = (bits >> 9).to(torch.float32) * (2.0**-23)
    elif dtype == torch.bfloat16:
        # JAX draws 8 bits for a type of fewer than 8 mantissa bits.
        floats = ((bits & 0xFF) >> 1).to(torch.bfloat16) * (2.0**-7)
    else:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    # Filled on the device (no host copy, so a CUDA graph can capture it).
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: float = 0.5) -> torch.Tensor:
    """A bool draw with probability ``p`` (``jax.random.bernoulli``)."""
    return uniform(key) < p


def _mul_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` for unsigned 32-bit values held in int64, in
    16-bit halves so that no product leaves int64."""
    return ((a & 0xFFFF) * b + (((a >> 16) * b) & 0xFFFF) * 65536) & _M32


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int
            ) -> torch.Tensor:
    """int32 integers in ``[minval, maxval)`` (``jax.random.randint`` with
    ``dtype=int32``, its modulo bias included); ``minval >= maxval`` gives
    ``minval``.  Bounds outside int32 raise, as JAX's do."""
    lo, hi = int(minval), int(maxval)
    if not (-2**31 <= lo < 2**31 and -2**31 <= hi < 2**31):
        raise OverflowError(f"randint bounds [{lo}, {hi}) leave the int32 range")
    span = hi - lo if hi > lo else 1
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    # JAX's multiplier, squared in uint32: it wraps to 0 once span > 2**16.
    mult = ((2**16 % span) ** 2 & _M32) % span
    offset = (_mul_u32(higher % span, torch.full_like(higher, mult)) + lower % span) & _M32
    return _as_i32((offset % span + lo) & _M32)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_LO_BF16 = -1.0 + 2.0**-8  # nextafter(-1, 0) in bfloat16
_SQRT2 = float(np.float32(np.sqrt(2.0)))


# XLA's ErfInv32 (xla/client/lib/math.cc): a degree-8 polynomial in
# w - 2.5 for w = -log1p(-x*x) < 5, else in sqrt(w) - 3, times x.
_ERFINV_SMALL_W = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_LARGE_W = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function with XLA's polynomial (``ErfInv32``),
    ``+-inf`` at ``|x| == 1``; within an ulp or two of ``jax.lax.erf_inv``."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_SMALL_W[0], _ERFINV_LARGE_W[0])
    for lo, hi in zip(_ERFINV_SMALL_W[1:], _ERFINV_LARGE_W[1:]):
        p = torch.where(small, lo, hi) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(key: torch.Tensor, shape: Sequence[int] = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """float32 or bfloat16 standard normals (``jax.random.normal``), via
    :func:`erfinv`."""
    if dtype == torch.bfloat16:
        u = uniform(key, shape, _NORMAL_LO_BF16, 1.0, dtype)
        return erfinv(u.float()).to(dtype) * torch.full((), _SQRT2, dtype=dtype,
                                                         device=key.device)
    u = uniform(key, shape, _NORMAL_LO, 1.0, dtype)
    return _SQRT2 * erfinv(u)


_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """float32 standard Gumbel draws, ``-log(-log(uniform(key, shape,
    tiny, 1)))`` (``jax.random.gumbel`` with its default ``mode="low"``):
    the uniform draws are bit-exact, each ``log`` within an ulp of XLA's."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """An index drawn from the softmax of float32 ``logits`` along the last
    axis (``jax.random.categorical``): the first argmax of logits plus
    Gumbel noise over the same shape; int64 of the batch shape."""
    return torch.argmax(logits + gumbel(key, tuple(logits.shape)), dim=-1)


def prng_key(seed: int) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes for ``0 <= seed < 2**31``."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int32)
