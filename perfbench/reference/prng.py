"""A frozen copy of the counter-based generator NUTS draws from:
threefry-2x32 (20 rounds) with JAX's partitionable counter layout, in NumPy
``uint32`` arithmetic, batched over keys.

A key is a pair of 32-bit words, held here as ``uint32`` ``[..., 2]``.

* ``split(keys, n)[..., i, :] = threefry(key, (0, i))``;
* ``uniform(keys)``: one float32 draw a key from the hash of counter
  ``(0, 0)``: the top 23 bits of ``w0 ^ w1`` as a mantissa, times
  ``2**-23``, scaled into ``[lo, hi)`` in float32;
* ``normal(keys, d)``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` over counters ``0..d-1``, with XLA's float32
  ``ErfInv32`` polynomial.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The hash of counters ``(x1, x2)`` under key ``(k1, k2)``; ``uint32``
    arrays that broadcast together."""
    with np.errstate(over="ignore"):
        ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
        a = x1 + ks[0]
        b = x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + _U32(i + 1)
    return a, b


def _hash_iota(keys: np.ndarray, n: int):
    k1 = keys[..., 0:1].astype(_U32)
    k2 = keys[..., 1:2].astype(_U32)
    lo = np.arange(n, dtype=_U32)
    return threefry2x32(k1, k2, np.zeros_like(lo), lo)


def as_keys(words) -> np.ndarray:
    """int32 (or any integer) key words ``[..., 2]`` as ``uint32``."""
    return np.asarray(words).astype(np.int64).astype(_U32)


def split(keys: np.ndarray, n: int) -> np.ndarray:
    """``[..., n, 2]``: ``n`` new keys from each key."""
    b1, b2 = _hash_iota(keys, n)
    return np.stack([b1, b2], axis=-1)


def _floats(keys: np.ndarray, n: int) -> np.ndarray:
    b1, b2 = _hash_iota(keys, n)
    return ((b1 ^ b2) >> _U32(9)).astype(np.float32) * np.float32(2.0**-23)


def uniform(keys: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """One float32 draw on ``[lo, hi)`` a key: ``[...]``."""
    return _scale(_floats(keys, 1)[..., 0], lo, hi)


def _scale(f: np.ndarray, lo: float, hi: float) -> np.ndarray:
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return np.maximum(lo32, f * (hi32 - lo32) + lo32)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = np.float32(np.sqrt(2.0))
_SMALL_W = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
            0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_LARGE_W = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
            0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function by XLA's ``ErfInv32`` polynomial."""
    x = x.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(small, np.float32(_SMALL_W[0]), np.float32(_LARGE_W[0]))
    for a, b in zip(_SMALL_W[1:], _LARGE_W[1:]):
        p = np.where(small, np.float32(a), np.float32(b)) + p * w
    return np.where(np.abs(x) == 1.0, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(keys: np.ndarray, d: int) -> np.ndarray:
    """``[..., d]`` float32 standard normals a key."""
    return _SQRT2 * erfinv(_scale(_floats(keys, d), _NORMAL_LO, 1.0))
