"""Wrapper for causal GQA flash attention (K3): ``[B, S, H, Dh]`` layout in
and out, argument checks, device dispatch and a launch count.

A fake tensor (:mod:`repro_torch.fake`, as type inference and the
dry-run pass one) gets an empty tensor of the output's shape, dtype and
device, the shape rule of a kernel that launches through ``ctypes``, not a
fallback.  Both a fake call and a launch record their cost with the active
op counter (:func:`repro_torch.launch.op_cost.record`, nothing when none is
active): the FLOPs its plain version's two products count over the whole
``S x T`` score matrix, and the bytes of q, k and v read and o written.  A
tensor on the CPU runs the plain version in :mod:`.ref`; any other
tensor launches a CUDA kernel in :mod:`.kernel` (building it on first
use) or raises.  There is no fallback from the card to the plain version,
and none between the two kernels: :func:`.kernel.route` picks one from the
dtype and head dim, and operands the tensor-core kernel cannot load (a
pointer or stride that is not a multiple of 16 bytes) raise.

``flash_attention.launches`` counts kernel launches of either kernel and
``flash_attention.sm90_launches`` those of the tensor-core kernel (CPU
calls count in neither); callers reset them by assigning 0.
"""
from __future__ import annotations

import torch

from ... import fake
from ...launch import op_cost
from .. import _layout
from . import kernel, ref


def cost(q: torch.Tensor, k: torch.Tensor) -> tuple[float, float]:
    """``(flops, bytes)`` of one call: ``4 B H S T Dh`` (QK^T and PV, as
    the plain version computes them) and q, k, v in and o out."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    return 4.0 * b * h * s * t * dh, float((2 * b * s * h + 2 * b * t * hk) * dh * q.element_size())


def _record(q: torch.Tensor, k: torch.Tensor) -> None:
    if op_cost.active() is not None:
        flops, nbytes = cost(q, k)
        op_cost.record("flash_attention", flops=flops, nbytes=nbytes)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q [B, S, H, Dh] and k, v [B, T, Hkv, Dh]; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, s, h, dh = q.shape
    _, t, hk, dk = k.shape
    if k.shape[0] != b or dk != dh or hk == 0 or h % hk:
        raise ValueError(
            f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch or "
            "head dim, or H is not a multiple of Hkv"
        )
    if causal and s != t:
        raise ValueError(
            f"causal attention needs S == T (top-left mask, as the kernel "
            f"computes it), got S={s}, T={t}"
        )
    for name, n in (("S", s), ("T", t)):
        tile = min(kernel.BLOCK, n)
        if n % tile:
            raise ValueError(
                f"{name}={n} is not a multiple of the {tile}-row tile "
                f"(allowed: up to {kernel.BLOCK}, or a multiple of {kernel.BLOCK})"
            )
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, Dh]; k, v: [B, T, Hkv, Dh] -> [B, S, H, Dh] in q's dtype."""
    _check(q, k, v, causal)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention (K3) has no backward pass, as the reference's Pallas "
            "kernel has none: differentiate the model with use_flash=False")
    if fake.is_fake(q, k, v):
        _record(q, k)
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal)
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"the CUDA kernel takes {list(kernel.DTYPES)}, got {q.dtype}")
    if q.shape[-1] not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not in {kernel.HEAD_DIMS}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last (head-dim) axis")
    if kernel.route(q.dtype, q.shape[-1]) == "sm90":
        _layout.check_aligned(q=q, k=k, v=v)
        out = kernel.flash_attention_sm90(q, k, v, causal=causal)
        flash_attention.sm90_launches += 1
    else:
        out = kernel.flash_attention(q, k, v, causal=causal)
    flash_attention.launches += 1
    _record(q, k)
    return out


flash_attention.launches = 0
flash_attention.sm90_launches = 0
