"""Program-counter autobatching VM (paper Algorithm 2) on PyTorch.

The JAX package runs the whole batch as one compiled ``lax.while_loop``
whose body picks a block and dispatches it through ``lax.switch``.  PyTorch
eager has neither, so this VM drives the same loop from the host:

  1. compute the earliest live block on the device,
     ``min(where(live, pc_top, exit))`` (the paper's heuristic, the
     ``"earliest"`` schedule), and read that one index back — one host
     read per dispatch, which is also the liveness test;
  2. stop at ``exit_index`` or at ``max_steps``;
  3. otherwise run that block's Python body, which issues the block's
     tensor operations with every state update masked to the lanes whose
     pc-top selects the block.

Recursion is materialized into fixed-shape ``[depth, batch, ...]`` stacks,
so members at *different stack depths* batch together whenever their
pc-tops coincide.  All stack traffic — the variable stacks and the pc
stack — goes through :mod:`repro_torch.kernels.stack_ops`: on a CUDA
device the hand-written kernels (pushes write the stack in place), on the
CPU their plain versions.  No caller keeps a reference to an older stack,
so the in-place push is safe.

Pc, pointer and counter state is int32 as in the JAX VM, so overflow,
``steps`` and the statistics match it bit for bit.  Unbatched primitives
run under ``torch.func.vmap``; constants are evaluated once and broadcast.

The VM exposes one dispatch at a time (:meth:`ProgramCounterVM.pick` /
:meth:`ProgramCounterVM.dispatch`) as well as :meth:`ProgramCounterVM.run`,
so tests can replay the dispatch sequence against an independent oracle.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..kernels.stack_ops import ops as stack_ops
from . import ir

_I32 = torch.int32


class StackOverflow(RuntimeError):
    """A member's pc or variable stack exceeded ``max_depth``.

    Out-of-range pushes are dropped, so overflowing members produce invalid
    results while other members stay exact.  ``depth_exceeded`` is the
    ``[batch]`` bool overflow mask (host numpy) and ``lanes`` the sorted
    offending lane indices.
    """

    def __init__(
        self,
        message: str,
        *,
        depth_exceeded: Optional[np.ndarray] = None,
        lanes: Optional[np.ndarray] = None,
    ):
        super().__init__(message)
        self.depth_exceeded = depth_exceeded
        if lanes is None and depth_exceeded is not None:
            lanes = np.flatnonzero(np.asarray(depth_exceeded))
        self.lanes = lanes


@dataclass(frozen=True)
class VMConfig:
    batch_size: int
    max_depth: int = 32  # stack slots (usable call depth = max_depth - 1)
    max_steps: int = 1_000_000


@dataclass
class VMResult:
    outputs: dict[str, torch.Tensor]
    steps: int  # dispatches run
    converged: bool  # all members halted within max_steps
    block_exec: np.ndarray  # [num_blocks] int32: times each block ran
    block_active: np.ndarray  # [num_blocks] int32: total active members
    tag_stats: dict[str, tuple[int, int]]  # tag -> (execs, active)
    depth_exceeded: torch.Tensor  # [batch] bool: stack overflowed
    lane_steps: torch.Tensor  # [batch] int32 active-dispatch counts


def _bcast(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Broadcast a [Z] bool mask against a [Z, ...] value."""
    return mask.view(mask.shape + (1,) * (val.dim() - 1))


def _masked(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(_bcast(mask, new), new, old)


class ProgramCounterVM:
    """Host-driven batched executor for a :class:`ir.LoweredProgram`."""

    def __init__(self, lowered: ir.LoweredProgram, config: VMConfig, device):
        self.lowered = lowered
        self.config = config
        self.device = torch.device(device)
        self.num_blocks = len(lowered.blocks)
        self._state_vars = [
            v for v in sorted(lowered.var_specs) if v not in lowered.temp_vars
        ]
        # Constants are evaluated once, on the device (the JAX VM traces
        # them once into the loop body).
        self._consts: dict[int, tuple[torch.Tensor, ...]] = {}
        self._vmapped: dict[int, Callable] = {}
        for blk in lowered.blocks:
            for op in blk.ops:
                if not isinstance(op, ir.LPrim) or op.fn is ir.identity:
                    continue
                if not op.ins and not op.batched:
                    outs = op.fn()
                    outs = outs if isinstance(outs, tuple) else (outs,)
                    self._consts[id(op)] = tuple(
                        torch.as_tensor(o).to(self.device) for o in outs
                    )
                elif not op.batched:
                    self._vmapped[id(op)] = torch.func.vmap(op.fn)
        self._block_fns = [
            self._make_block_fn(i, blk) for i, blk in enumerate(lowered.blocks)
        ]
        # tag -> [(block_idx, multiplicity)] for post-run instrumentation.
        self._tag_blocks: dict[str, list[tuple[int, int]]] = {}
        for i, blk in enumerate(lowered.blocks):
            for op in blk.ops:
                if isinstance(op, ir.LPrim) and op.tag:
                    self._tag_blocks.setdefault(op.tag, []).append((i, 1))

    # ------------------------------------------------------------------
    # State
    # ------------------------------------------------------------------

    def init_state(self, inputs: dict[str, torch.Tensor]) -> dict[str, Any]:
        z, d = self.config.batch_size, self.config.max_depth
        lp, dev = self.lowered, self.device
        tops: dict[str, torch.Tensor] = {}
        stacks: dict[str, torch.Tensor] = {}
        ptrs: dict[str, torch.Tensor] = {}
        for v in self._state_vars:
            spec = lp.var_specs[v]
            tops[v] = torch.zeros((z,) + spec.shape, dtype=spec.dtype, device=dev)
            if v in lp.stack_vars:
                stacks[v] = torch.zeros(
                    (d, z) + spec.shape, dtype=spec.dtype, device=dev
                )
                ptrs[v] = torch.zeros((z,), dtype=_I32, device=dev)
        for p in lp.main_params:
            spec = lp.var_specs[p]
            x = torch.as_tensor(inputs[p])
            if tuple(x.shape) != (z,) + spec.shape:
                raise ValueError(
                    f"input {p!r}: expected batched shape "
                    f"{(z,) + spec.shape}, got {tuple(x.shape)}"
                )
            tops[p] = x.to(device=dev, dtype=spec.dtype).contiguous()
        return {
            "pc_top": torch.full((z,), lp.entry, dtype=_I32, device=dev),
            # Slot 0 holds the exit sentinel.
            "pc_stack": torch.full((d, z), lp.exit_index, dtype=_I32, device=dev),
            "pc_ptr": torch.ones((z,), dtype=_I32, device=dev),
            "tops": tops,
            "stacks": stacks,
            "ptrs": ptrs,
            "steps": 0,
            # Per-member overflow flag: set when a push would land at or
            # beyond max_depth (the push drops it, invalidating the member).
            "depth_exceeded": torch.zeros((z,), dtype=torch.bool, device=dev),
            "lane_steps": torch.zeros((z,), dtype=_I32, device=dev),
            "block_exec": np.zeros((self.num_blocks,), np.int32),
            "block_active": torch.zeros((self.num_blocks,), dtype=_I32, device=dev),
        }

    # ------------------------------------------------------------------
    # Block bodies
    # ------------------------------------------------------------------

    def _make_block_fn(self, bidx: int, blk: ir.LBlock) -> Callable:
        temp_vars = self.lowered.temp_vars
        max_depth = self.config.max_depth
        consts, vmapped = self._consts, self._vmapped
        t = blk.term
        branch_targets = None
        if isinstance(t, ir.LBranch):
            branch_targets = (
                torch.tensor(t.true, dtype=_I32, device=self.device),
                torch.tensor(t.false, dtype=_I32, device=self.device),
            )

        def run(state: dict[str, Any], mask: torch.Tensor) -> None:
            imask = mask.to(_I32)
            z = mask.shape[0]
            tops, stacks, ptrs = state["tops"], state["stacks"], state["ptrs"]
            temps: dict[str, torch.Tensor] = {}

            def read(v: str) -> torch.Tensor:
                return temps[v] if v in temp_vars else tops[v]

            def write(v: str, val: torch.Tensor) -> None:
                if v in temp_vars:
                    temps[v] = val
                else:
                    tops[v] = _masked(mask, val.to(tops[v].dtype), tops[v])

            def overflow(ptr: torch.Tensor) -> None:
                state["depth_exceeded"] = state["depth_exceeded"] | (
                    mask & (ptr >= max_depth)
                )

            for op in blk.ops:
                if isinstance(op, ir.LPrim):
                    if op.fn is ir.identity:
                        outs = (read(op.ins[0]),)
                    elif id(op) in consts:
                        # Nullary primitive (constant): broadcast to the batch.
                        outs = tuple(c.expand((z,) + c.shape) for c in consts[id(op)])
                    else:
                        fn = op.fn if op.batched else vmapped[id(op)]
                        outs = fn(*[read(i) for i in op.ins])
                        if len(op.outs) == 1:
                            outs = (outs,)
                    for name, val in zip(op.outs, outs):
                        write(name, val)
                elif isinstance(op, ir.LPush):
                    old_top = tops[op.var]
                    overflow(ptrs[op.var])
                    stack_ops.masked_push(
                        stacks[op.var], ptrs[op.var], old_top.contiguous(), mask
                    )
                    ptrs[op.var] = ptrs[op.var] + imask
                    tops[op.var] = _masked(mask, read(op.src), old_top)
                elif isinstance(op, ir.LPop):
                    new_ptr = ptrs[op.var] - imask
                    restored = stack_ops.masked_peek(stacks[op.var], new_ptr)
                    tops[op.var] = _masked(mask, restored, tops[op.var])
                    ptrs[op.var] = new_ptr
                else:  # pragma: no cover
                    raise AssertionError(op)

            pc_top, pc_ptr = state["pc_top"], state["pc_ptr"]
            if isinstance(t, ir.LJump):
                pc_top = pc_top.masked_fill(mask, t.target)
            elif isinstance(t, ir.LBranch):
                cond = read(t.var)
                cond = cond if cond.dtype == torch.bool else cond != 0
                chosen = torch.where(cond, *branch_targets)
                pc_top = torch.where(mask, chosen, pc_top)
            elif isinstance(t, ir.LPushJump):
                # Bury the return address; jump to the callee entry.
                overflow(pc_ptr)
                ret = torch.full((z,), t.ret, dtype=_I32, device=mask.device)
                stack_ops.masked_push(state["pc_stack"], pc_ptr, ret, mask)
                pc_ptr = pc_ptr + imask
                pc_top = pc_top.masked_fill(mask, t.target)
            elif isinstance(t, ir.LReturn):
                pc_ptr = pc_ptr - imask
                restored = stack_ops.masked_peek(state["pc_stack"], pc_ptr)
                pc_top = torch.where(mask, restored, pc_top)
            else:  # pragma: no cover
                raise AssertionError(t)
            state["pc_top"], state["pc_ptr"] = pc_top, pc_ptr
            state["lane_steps"] = state["lane_steps"] + imask

        return run

    # ------------------------------------------------------------------
    # The loop
    # ------------------------------------------------------------------

    def pick(self, state: dict[str, Any]) -> int:
        """The earliest live block (``exit_index`` once every lane halted).

        Halted lanes hold ``pc_top == exit_index``, so the minimum over all
        lanes is ``min(where(live, pc_top, exit))``; reading it back is the
        one host synchronisation of a dispatch."""
        return int(state["pc_top"].min())

    def dispatch(self, state: dict[str, Any], b: int) -> None:
        """Run block ``b`` once over the lanes resting there (in place)."""
        mask = state["pc_top"] == b
        state["block_exec"][b] += 1
        state["block_active"][b] += mask.sum(dtype=_I32)
        self._block_fns[b](state, mask)
        state["steps"] += 1

    def run(self, inputs: dict[str, torch.Tensor]) -> VMResult:
        """Execute the batched program to completion (or ``max_steps``)."""
        state = self.init_state(inputs)
        exit_idx = self.lowered.exit_index
        while state["steps"] < self.config.max_steps:
            b = self.pick(state)
            if b >= exit_idx:
                break
            self.dispatch(state, b)
        return self.result(state)

    def result(self, state: dict[str, Any]) -> VMResult:
        lp = self.lowered
        be = state["block_exec"].copy()
        ba = state["block_active"].cpu().numpy()
        tag_stats = {
            tag: (
                sum(int(be[b]) * m for b, m in entries),
                sum(int(ba[b]) * m for b, m in entries),
            )
            for tag, entries in self._tag_blocks.items()
        }
        return VMResult(
            outputs={o: state["tops"][o] for o in lp.main_outputs},
            steps=state["steps"],
            converged=bool((state["pc_top"] >= lp.exit_index).all()),
            block_exec=be,
            block_active=ba,
            tag_stats=tag_stats,
            depth_exceeded=state["depth_exceeded"],
            lane_steps=state["lane_steps"],
        )
