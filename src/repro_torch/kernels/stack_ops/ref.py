"""Plain PyTorch versions of the batched stack operations (paper Alg. 2's
PUSH/POP data movement), with the semantics of
``src/repro/kernels/stack_ops/ref.py``, and the VM's runs of pushes and
pops around them (:func:`push_group`, :func:`pop_group`).  The CPU path of
:mod:`.ops` runs these; on the card only the kernel checks use them."""
from __future__ import annotations

from typing import Optional

import torch


def masked_push(stack: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """stack: [D, Z, F...]; ptr, mask: [Z]; val: [Z, F...] -> a new stack.

    For lanes z with ``mask[z]`` and ``0 <= ptr[z] < D``, write ``val[z]``
    at depth ``ptr[z]``; out-of-range (and negative) pointers are dropped.
    """
    d, z = stack.shape[:2]
    lanes = torch.arange(z, device=stack.device)
    ok = mask & (ptr >= 0) & (ptr < d)
    rows = ptr.clamp(0, d - 1).long()
    ok = ok.reshape((z,) + (1,) * (stack.dim() - 2))
    out = stack.clone()
    out[rows, lanes] = torch.where(ok, val.to(stack.dtype), stack[rows, lanes])
    return out


def masked_peek(stack: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """stack: [D, Z, F...]; ptr: [Z] -> [Z, F...] (stack[ptr[z], z])."""
    d, z = stack.shape[:2]
    lanes = torch.arange(z, device=stack.device)
    return stack[ptr.clamp(0, d - 1).long(), lanes]


def _where(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


def push_group(entries, mask: torch.Tensor, depth_exceeded: torch.Tensor,
               max_depth: int) -> tuple[list[torch.Tensor], list[Optional[torch.Tensor]]]:
    """A run of the VM's pushes, entry by entry.

    Each entry is ``(stack [D, Z, ...], ptr [Z] int32, old_top [Z, ...],
    src [Z, ...] or None)``.  Per entry: ``depth_exceeded |= mask & (ptr >=
    max_depth)`` (in place), ``old_top`` pushed onto ``stack`` where
    ``mask`` (in place, as :func:`masked_push`), ``new_ptr = ptr + mask``
    and ``new_top = where(mask, src, old_top)`` (None without a src).
    Returns the new pointers and tops, fresh tensors."""
    imask = mask.to(torch.int32)
    new_ptrs, new_tops = [], []
    for stack, ptr, old_top, src in entries:
        depth_exceeded |= mask & (ptr >= max_depth)
        stack.copy_(masked_push(stack, ptr, old_top, mask))
        new_ptrs.append(ptr + imask)
        new_tops.append(None if src is None else _where(mask, src, old_top))
    return new_ptrs, new_tops


def pop_group(entries, mask: torch.Tensor) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """A run of the VM's pops: each entry ``(stack, ptr, top)`` gives
    ``new_ptr = ptr - mask`` and ``new_top = where(mask, stack[clamp(new_ptr)],
    top)``.  Returns the new pointers and tops, fresh tensors."""
    imask = mask.to(torch.int32)
    new_ptrs, new_tops = [], []
    for stack, ptr, top in entries:
        new_ptr = ptr - imask
        new_ptrs.append(new_ptr)
        new_tops.append(_where(mask, masked_peek(stack, new_ptr), top))
    return new_ptrs, new_tops
