"""Wrapper for single-token decode attention (K4): ``q [B, H, Dh]``
against the cache as the model keeps it, ``k, v [B, W, Hkv, Dh]``, with
argument checks, device dispatch and a launch count.

A fake tensor (:mod:`repro_torch.fake`, as type inference and the
dry-run pass one) gets an empty tensor of the output's shape, dtype and
device, beside the partials a launch allocates (``kernel.buffers``): it
has no data, and the kernel launches through ``ctypes``, so
this is the shape rule, not a fallback.  Both a fake call and a launch
record the same cost with the active op counter
(:func:`repro_torch.launch.op_cost.record`, nothing when none is active):
the FLOPs its plain version's two products count over the whole window,
and the bytes of q and o, ``count`` and the k and v rows of the whole
window, as the plain version reads them.  A fake ``count`` has no values,
and a launch does not read it back (a host read inside a counted step),
so both charge the window (the steady state of a decode), and a step
counted on the card equals its dry-run.  A tensor on the CPU runs the
plain version in :mod:`.ref`; any other
tensor launches the CUDA kernel in :mod:`.kernel` (building it on first
use) or raises.  There is no fallback from the card to the plain version.
The kernel has no backward: on the card a call under autograd raises
rather than drop the gradient (on the CPU the plain version
differentiates, as the reference's plain-XLA decode attention does).
The cache is read where it lies, through its strides: the serving VM hands
over views whose batch axis is not the outermost, and no copy is made.
The kernel loads 16 bytes at a time, so a pointer or stride that is not a
multiple of 16 bytes raises.

``decode_attention.launches`` counts calls that launch the kernel, one
per layer of a decode step, whether or not the window needed the second,
combining kernel (CPU calls do not count); callers reset it by assigning
0.
"""
from __future__ import annotations

import torch

from ... import fake
from ...launch import op_cost
from .. import _layout
from . import kernel, ref


def cost(q: torch.Tensor, k: torch.Tensor, rows: int) -> tuple[float, float]:
    """``(flops, bytes)`` of one call over ``rows`` cache rows in all:
    ``4 B H W Dh`` (the plain version's two products over the window) and
    q, o, ``count`` and the rows of k and v."""
    b, h, dh = q.shape
    w, hk = k.shape[1], k.shape[2]
    s = q.element_size()
    return 4.0 * b * h * w * dh, float(2 * b * h * dh * s + 4 * b + 2 * rows * hk * dh * s)


def _record(q: torch.Tensor, k: torch.Tensor) -> None:
    """The call's cost over the whole window, on a launch and on a fake
    tensor alike."""
    if op_cost.active() is not None:
        flops, nbytes = cost(q, k, k.shape[0] * k.shape[1])
        op_cost.record("decode_attention", flops=flops, nbytes=nbytes)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           count: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q [B, H, Dh] and k, v [B, W, Hkv, Dh]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, dh = q.shape
    _, w, hk, dk = k.shape
    if k.shape[0] != b or dk != dh or hk == 0 or h % hk:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch or "
            "head dim, or H is not a multiple of Hkv"
        )
    if count.dtype != torch.int32 or count.shape != (b,):
        raise TypeError(f"count must be int32 [{b}], got {count.dtype} {tuple(count.shape)}")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device == count.device):
        raise ValueError(f"q, k, v, count on {q.device}, {k.device}, {v.device}, {count.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     count: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Dh]; k, v: [B, W, Hkv, Dh]; count: int32 [B] valid cache
    rows per sequence -> [B, H, Dh] in q's dtype (zeros where count is 0)."""
    _check(q, k, v, count)
    if fake.is_fake(q, k, v, count):
        _record(q, k)
        return kernel.buffers(q, k)[0]
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, count)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "decode_attention (K4) has no backward pass on the card: run decode "
            "steps under torch.no_grad() or on the CPU to differentiate them")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"the CUDA kernel takes {list(kernel.DTYPES)}, got {q.dtype}")
    if q.shape[-1] not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {kernel.HEAD_DIMS}")
    if q.shape[1] // k.shape[2] > kernel.MAX_GROUP:
        raise ValueError(f"more than {kernel.MAX_GROUP} query heads per KV head")
    if not q.is_contiguous() or not count.is_contiguous():
        raise ValueError("q and count must be contiguous")
    if any(x.stride(3) != 1 for x in (k, v)):
        raise ValueError("k and v need a contiguous last (head-dim) axis")
    _layout.check_aligned(q=q, k=k, v=v)
    out = kernel.decode_attention(q, k, v, count)
    decode_attention.launches += 1
    _record(q, k)
    return out


decode_attention.launches = 0
