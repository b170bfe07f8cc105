"""Wrappers for the stack kernels: any feature shape, device dispatch,
argument checks and launch counts.

Two kinds of entry point:

- :func:`masked_push` and :func:`masked_peek`, the TPU kernels'
  functions, one stack per call, checked on every call;
- :class:`PushGroup` and :class:`PopGroup`, a run of the VM's pushes or
  pops with the pointer, overflow and select arithmetic around them fused
  in (:func:`ref.push_group`, :func:`ref.pop_group` define them).  Their
  layout is fixed and checked when the group is made, once per VM; a call
  checks only each top's and src's dtype, shape and strides, collects the
  data pointers and launches once per :data:`kernel.MAX_ENTRIES` entries.
  The table carries each top's and src's lane stride, so a constant src
  broadcast over the lanes (stride 0) goes to the kernel as it is; any
  other layout than dense rows is copied contiguous first.
  :func:`push_group` and :func:`pop_group` make a group from the tensors
  they are given and call it.

Every entry point dispatches on the tensor's device: a tensor on the CPU
runs the plain version in :mod:`.ref`; any other tensor launches the CUDA
kernel in :mod:`.kernel` (building it on first use) or raises.  There is no
fallback from the card to the plain version.

Pushes write the stack **in place** on both paths, as the TPU kernel
aliases its stack operand to its output; new pointers and tops are fresh
tensors (a top may be aliased by a temp of the VM).

``masked_push.launches`` counts every launch of the push kernel and
``masked_peek.launches`` every launch of the pop kernel, grouped or not
(CPU calls do not count); callers reset them by assigning 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

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


def _check_mask(mask: torch.Tensor, ptr: torch.Tensor) -> None:
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.shape != ptr.shape or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous [Z] tensor")
    if mask.device != ptr.device:
        raise ValueError(f"mask on {mask.device}, ptr on {ptr.device}")


def masked_push(stack: torch.Tensor, ptr: torch.Tensor, val: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """In place: for lanes with ``mask`` and ``0 <= ptr < D`` write ``val``
    into ``stack[ptr, lane]``.  stack ``[D, Z, ...]``; ptr int32 and mask
    bool ``[Z]``; val ``[Z, ...]`` of the stack's dtype.  Returns stack."""
    _check_common(stack, ptr)
    _check_mask(mask, ptr)
    if val.dtype != stack.dtype:
        raise TypeError(f"val is {val.dtype}, stack is {stack.dtype}")
    if val.shape != stack.shape[1:]:
        raise ValueError(
            f"val must be {tuple(stack.shape[1:])}, got {tuple(val.shape)}"
        )
    if not val.is_contiguous():
        raise ValueError("val must be contiguous")
    if val.device != stack.device:
        raise ValueError("stack, ptr, val and mask must share one device")
    if stack.device.type == "cpu":
        stack.copy_(ref.masked_push(stack, ptr, val, mask))
        return stack
    masked_push.launches += kernel.masked_push(_flat(stack, 2), ptr, _flat(val, 1), mask)
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


# ---------------------------------------------------------------------------
# Groups
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StackSpec:
    """One stack of a group: ``[depth, lanes, *shape]`` of ``dtype``."""

    depth: int
    shape: tuple[int, ...]
    dtype: torch.dtype


class _Row:
    """The layout of one entry's lane rows, worked out once."""

    __slots__ = ("depth", "full", "dtype", "strides", "elems", "itemsize", "nbytes")

    def __init__(self, spec: StackSpec, lanes: int):
        if spec.depth < 1:
            raise ValueError(f"a stack needs depth >= 1, got {spec.depth}")
        self.depth = spec.depth
        self.full = torch.Size((lanes,) + tuple(spec.shape))
        self.dtype = spec.dtype
        self.strides = torch.empty(self.full, dtype=spec.dtype, device="meta").stride()[1:]
        self.elems = self.full[1:].numel()
        self.itemsize = spec.dtype.itemsize
        self.nbytes = self.elems * self.itemsize

    def lanes_of(self, x: torch.Tensor, what: str) -> tuple[torch.Tensor, int]:
        """``x`` and the bytes between its lanes' rows: dense rows ``nbytes``
        or 0 (a broadcast constant) apart as they are, else a contiguous
        copy."""
        if x.dtype != self.dtype or x.shape != self.full:
            raise TypeError(
                f"{what} is {x.dtype} {tuple(x.shape)}, the stack holds "
                f"{self.dtype} {tuple(self.full)}"
            )
        st = x.stride()
        if st[1:] == self.strides and st[0] in (self.elems, 0):
            return x, st[0] * self.itemsize
        return x.contiguous(), self.nbytes


def _check_group(stacks: Sequence[torch.Tensor], ptrs: Sequence[torch.Tensor],
                 mask: torch.Tensor) -> list[StackSpec]:
    """Full checks of a group's stacks, pointers and mask; their specs."""
    if not stacks:
        raise ValueError("a group needs at least one stack")
    specs = []
    for stack, ptr in zip(stacks, ptrs):
        _check_common(stack, ptr)
        _check_mask(mask, ptr)
        specs.append(StackSpec(stack.shape[0], tuple(stack.shape[2:]), stack.dtype))
    return specs


class _Group:
    """What push and pop groups share: the rows' layouts, checked once, the
    table's fixed words, and fresh outputs — one int32 ``[n, Z]`` buffer
    for the new pointers and one buffer for each row shape and dtype among
    the new tops, so that a call allocates few tensors."""

    def __init__(self, specs: Sequence[StackSpec], new_top: Sequence[bool], lanes: int):
        if not specs or len(new_top) != len(specs):
            raise ValueError("a group needs at least one stack, and a flag for each")
        self.specs = tuple(specs)
        self.rows = [_Row(s, lanes) for s in specs]
        self.lanes = lanes
        self._template = []
        for row in self.rows:
            words = [0] * kernel.WORDS
            words[kernel.DEPTH], words[kernel.ROW_BYTES] = row.depth, row.nbytes
            self._template += words
        classes: dict = {}
        for i, (row, want) in enumerate(zip(self.rows, new_top)):
            if want:
                classes.setdefault((row.full, row.dtype), []).append(i)
        self._top_buffers = [
            (torch.Size((len(idx),) + full), dtype, idx, lanes * self.rows[idx[0]].nbytes)
            for (full, dtype), idx in classes.items()
        ]

    def __len__(self) -> int:
        return len(self.rows)

    def _outputs(self, device: torch.device, words: list[int]):
        """Fresh new pointers and tops (None where an entry has none), with
        their addresses written into the table ``words``."""
        n, w = len(self.rows), kernel.WORDS
        ptrs = torch.empty((n, self.lanes), dtype=torch.int32, device=device)
        base = ptrs.data_ptr()
        for i in range(n):
            words[w * i + kernel.NEW_PTR] = base + 4 * self.lanes * i
        tops = [None] * n
        for shape, dtype, idx, step in self._top_buffers:
            buf = torch.empty(shape, dtype=dtype, device=device)
            base = buf.data_ptr()
            for j, (i, top) in enumerate(zip(idx, buf.unbind(0))):
                tops[i] = top
                words[w * i + kernel.NEW_TOP] = base + step * j
        return list(ptrs.unbind(0)), tops


class PushGroup(_Group):
    """A run of pushes over stacks of fixed specs and ``lanes`` lanes;
    ``has_src[i]`` says whether entry ``i`` gives a src (and gets a new
    top).  Call it as :func:`ref.push_group`."""

    def __init__(self, specs: Sequence[StackSpec], has_src: Sequence[bool], lanes: int):
        super().__init__(specs, has_src, lanes)
        self.has_src = tuple(has_src)

    def __call__(self, entries, mask: torch.Tensor, depth_exceeded: torch.Tensor,
                 max_depth: int) -> tuple[list[torch.Tensor], list[Optional[torch.Tensor]]]:
        if len(entries) != len(self.rows):
            raise ValueError(f"{len(entries)} entries for a group of {len(self.rows)}")
        if mask.device.type == "cpu":
            return ref.push_group(entries, mask, depth_exceeded, max_depth)
        words = self._template.copy()
        new_ptrs, new_tops = self._outputs(mask.device, words)
        keep = []  # copies made here live until the launch is queued
        for i, ((stack, ptr, top, src), row, has_src) in enumerate(
                zip(entries, self.rows, self.has_src)):
            k = kernel.WORDS * i
            top, words[k + kernel.TOP_STRIDE] = row.lanes_of(top, "old_top")
            words[k + kernel.STACK] = stack.data_ptr()
            words[k + kernel.PTR] = ptr.data_ptr()
            words[k + kernel.TOP] = top.data_ptr()
            keep.append(top)
            if has_src:
                src, words[k + kernel.SRC_STRIDE] = row.lanes_of(src, "src")
                words[k + kernel.SRC] = src.data_ptr()
                keep.append(src)
        masked_push.launches += kernel.push(words, mask.data_ptr(), depth_exceeded.data_ptr(),
                                            max_depth, self.lanes, mask.device)
        return new_ptrs, new_tops


class PopGroup(_Group):
    """A run of pops over stacks of fixed specs and ``lanes`` lanes.  Call
    it as :func:`ref.pop_group`."""

    def __init__(self, specs: Sequence[StackSpec], lanes: int):
        super().__init__(specs, [True] * len(specs), lanes)

    def __call__(self, entries, mask: torch.Tensor
                 ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        if len(entries) != len(self.rows):
            raise ValueError(f"{len(entries)} entries for a group of {len(self.rows)}")
        if mask.device.type == "cpu":
            return ref.pop_group(entries, mask)
        words = self._template.copy()
        new_ptrs, new_tops = self._outputs(mask.device, words)
        keep = []
        for i, ((stack, ptr, top), row) in enumerate(zip(entries, self.rows)):
            k = kernel.WORDS * i
            top, words[k + kernel.TOP_STRIDE] = row.lanes_of(top, "top")
            words[k + kernel.STACK] = stack.data_ptr()
            words[k + kernel.PTR] = ptr.data_ptr()
            words[k + kernel.TOP] = top.data_ptr()
            keep.append(top)
        masked_peek.launches += kernel.pop(words, mask.data_ptr(), self.lanes, mask.device)
        return new_ptrs, new_tops


def push_group(entries, mask: torch.Tensor, depth_exceeded: torch.Tensor,
               max_depth: int) -> tuple[list[torch.Tensor], list[Optional[torch.Tensor]]]:
    """:func:`ref.push_group` on the entries' device, with every argument
    checked: the stacks contiguous, pointers int32, everything on the
    mask's device."""
    specs = _check_group([e[0] for e in entries], [e[1] for e in entries], mask)
    if depth_exceeded.dtype != torch.bool or depth_exceeded.shape != mask.shape \
            or not depth_exceeded.is_contiguous():
        raise ValueError("depth_exceeded must be a contiguous bool [Z] tensor")
    for stack, _, top, src in entries:
        for x in (top, src, depth_exceeded):
            if x is not None and x.device != mask.device:
                raise ValueError("a group's tensors must share one device")
    group = PushGroup(specs, [e[3] is not None for e in entries], mask.shape[0])
    return group(entries, mask, depth_exceeded, max_depth)


def pop_group(entries, mask: torch.Tensor) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """:func:`ref.pop_group` on the entries' device, with every argument
    checked as in :func:`push_group`."""
    specs = _check_group([e[0] for e in entries], [e[1] for e in entries], mask)
    if any(top.device != mask.device for _, _, top in entries):
        raise ValueError("a group's tensors must share one device")
    return PopGroup(specs, mask.shape[0])(entries, mask)
