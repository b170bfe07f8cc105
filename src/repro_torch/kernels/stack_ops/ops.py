"""Wrappers for the stack kernels: any feature shape, device dispatch,
argument checks and launch counts.

The wrappers flatten the feature shape to one axis ``F`` (the VM pushes
values of any rank) and dispatch on the tensor's device: a tensor on the
CPU runs the plain version in :mod:`.ref`; any other tensor launches the
CUDA kernel in :mod:`.kernel` (building it on first use) or raises.  There
is no fallback from the card to the plain version.

``masked_push`` writes the stack **in place** on both paths, as the TPU
kernel aliases its stack operand to its output, and returns it.

Each wrapper keeps a plain integer ``launches`` that counts kernel launches
(CPU calls do not count); callers reset it by assigning 0.
"""
from __future__ import annotations

import torch

from . import kernel, ref


def _flat(x: torch.Tensor, lead: int) -> torch.Tensor:
    f = 1
    for s in x.shape[lead:]:
        f *= s
    return x.view(x.shape[:lead] + (f,))


def _check_common(stack: torch.Tensor, ptr: torch.Tensor) -> None:
    if stack.dim() < 2:
        raise ValueError(f"stack must be [D, Z, ...], got {tuple(stack.shape)}")
    if not stack.is_contiguous():
        raise ValueError("stack must be contiguous")
    if ptr.dtype != torch.int32:
        raise TypeError(f"ptr must be int32, got {ptr.dtype}")
    if ptr.shape != stack.shape[1:2]:
        raise ValueError(
            f"ptr must be [Z] = {tuple(stack.shape[1:2])}, got {tuple(ptr.shape)}"
        )
    if not ptr.is_contiguous():
        raise ValueError("ptr must be contiguous")
    if ptr.device != stack.device:
        raise ValueError(f"ptr on {ptr.device}, stack on {stack.device}")


def masked_push(stack: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """In place: for lanes with ``mask`` and ``0 <= ptr < D`` write ``val``
    into ``stack[ptr, lane]``.  stack ``[D, Z, ...]``; ptr int32 and mask
    bool ``[Z]``; val ``[Z, ...]`` of the stack's dtype.  Returns stack."""
    _check_common(stack, ptr)
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.shape != ptr.shape or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous [Z] tensor")
    if val.dtype != stack.dtype:
        raise TypeError(f"val is {val.dtype}, stack is {stack.dtype}")
    if val.shape != stack.shape[1:]:
        raise ValueError(
            f"val must be {tuple(stack.shape[1:])}, got {tuple(val.shape)}"
        )
    if not val.is_contiguous():
        raise ValueError("val must be contiguous")
    if mask.device != stack.device or val.device != stack.device:
        raise ValueError("stack, ptr, val and mask must share one device")
    if stack.device.type == "cpu":
        stack.copy_(ref.masked_push(stack, ptr, val, mask))
        return stack
    kernel.masked_push(_flat(stack, 2), ptr, _flat(val, 1), mask)
    masked_push.launches += 1
    return stack


def masked_peek(stack: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``stack[clamp(ptr, 0, D - 1), lane]`` per lane: stack ``[D, Z, ...]``,
    ptr int32 ``[Z]`` -> a new ``[Z, ...]`` tensor."""
    _check_common(stack, ptr)
    if stack.device.type == "cpu":
        return ref.masked_peek(stack, ptr)
    out = kernel.masked_peek(_flat(stack, 2), ptr)
    masked_peek.launches += 1
    return out.view(stack.shape[1:])


masked_push.launches = 0
masked_peek.launches = 0

