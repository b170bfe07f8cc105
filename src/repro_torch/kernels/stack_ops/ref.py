"""Plain PyTorch versions of the batched stack operations (paper Alg. 2's
PUSH/POP data movement), with the semantics of
``src/repro/kernels/stack_ops/ref.py``.  The CPU path of :mod:`.ops` runs
these; on the card only the kernel checks use them."""
from __future__ import annotations

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
