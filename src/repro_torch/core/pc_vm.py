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
stack — goes through :mod:`repro_torch.kernels.stack_ops` in groups
(:class:`StackGroup`, fixed when the VM is made): each maximal run of a
block's pushes, or of its pops, with the pointer, overflow and select
arithmetic around them, is one call — on a CUDA device one kernel launch
per 16 stacks (pushes write the stack in place), on the CPU the plain
versions.  A ``LPushJump``'s pc push joins the block's last push run and a
``LReturn``'s pc pop its last pop run (no primitive touches the pc state).
No caller keeps a reference to an older stack, so the in-place push is
safe.

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


@dataclass(frozen=True)
class StackGroup:
    """A run of a block's pushes (``kind == "push"``) or pops that runs as one
    stack-ops call: ``vars`` in order (``srcs``: each push's source), then
    the pc stack if ``pc``.  ``call`` is the :class:`stack_ops.PushGroup` or
    :class:`stack_ops.PopGroup` made for it."""

    kind: str
    vars: tuple[str, ...]
    srcs: tuple[str, ...]
    pc: bool
    call: Any

    def __len__(self) -> int:
        return len(self.vars) + self.pc


def stack_runs(blk: ir.LBlock) -> list:
    """The block's ops with each run of pushes or pops gathered into a
    ``(kind, [ops], pc)`` triple.  A run is split where a push's ``src``
    names a variable pushed earlier in it (that push must read the new top)
    or where a variable repeats; the terminator's pc push or pop joins the
    last run of its kind, or ends the block as a run of its own."""
    items: list = []
    for op in blk.ops:
        kind = "push" if isinstance(op, ir.LPush) else "pop" if isinstance(op, ir.LPop) else None
        if kind is None:
            items.append(op)
            continue
        run = items[-1] if items and isinstance(items[-1], list) and items[-1][0] == kind else None
        if run is not None:
            seen = {o.var for o in run[1]}
            if op.var in seen or (kind == "push" and op.src in seen):
                run = None
        if run is None:
            items.append([kind, [op], False])
        else:
            run[1].append(op)
    pc_kind = {ir.LPushJump: "push", ir.LReturn: "pop"}.get(type(blk.term))
    if pc_kind is not None:
        runs = [it for it in items if isinstance(it, list) and it[0] == pc_kind]
        if runs:
            runs[-1][2] = True
        else:
            items.append([pc_kind, [], True])
    return [tuple(it) if isinstance(it, list) else it for it in items]


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
        # Per block, its stack groups in order (see stack_runs).
        self.stack_groups: list[list[StackGroup]] = []
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

    def _stack_group(self, kind: str, ops: list, pc: bool) -> StackGroup:
        lp, cfg = self.lowered, self.config
        specs, srcs = [], []
        for op in ops:
            spec = lp.var_specs[op.var]
            if kind == "push":
                src = lp.var_specs[op.src]
                if (src.shape, src.dtype) != (spec.shape, spec.dtype):
                    raise TypeError(
                        f"push {op.var} <- {op.src}: the source is {src.dtype} "
                        f"{src.shape}, the variable {spec.dtype} {spec.shape}"
                    )
                srcs.append(op.src)
            specs.append(stack_ops.StackSpec(cfg.max_depth, spec.shape, spec.dtype))
        if pc:
            specs.append(stack_ops.StackSpec(cfg.max_depth, (), _I32))
        if kind == "push":
            call = stack_ops.PushGroup(specs, [True] * len(ops) + [False] * pc,
                                       cfg.batch_size)
        else:
            call = stack_ops.PopGroup(specs, cfg.batch_size)
        return StackGroup(kind, tuple(op.var for op in ops), tuple(srcs), pc, call)

    def _make_block_fn(self, bidx: int, blk: ir.LBlock) -> Callable:
        temp_vars = self.lowered.temp_vars
        max_depth = self.config.max_depth
        consts, vmapped = self._consts, self._vmapped
        t = blk.term
        items = [
            it if isinstance(it, ir.LPrim) else self._stack_group(*it)
            for it in stack_runs(blk)
        ]
        self.stack_groups.append([it for it in items if isinstance(it, StackGroup)])
        branch_targets = ret_top = None
        if isinstance(t, ir.LBranch):
            branch_targets = (
                torch.tensor(t.true, dtype=_I32, device=self.device),
                torch.tensor(t.false, dtype=_I32, device=self.device),
            )
        elif isinstance(t, ir.LPushJump):
            # The return address, the pc push's old top.
            ret_top = torch.full((self.config.batch_size,), t.ret, dtype=_I32,
                                 device=self.device)

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

            for op in items:
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
                elif op.kind == "push":
                    entries = [(stacks[v], ptrs[v], tops[v], read(s))
                               for v, s in zip(op.vars, op.srcs)]
                    if op.pc:
                        entries.append((state["pc_stack"], state["pc_ptr"], ret_top, None))
                    new_ptrs, new_tops = op.call(entries, mask, state["depth_exceeded"],
                                                 max_depth)
                    for v, p, top in zip(op.vars, new_ptrs, new_tops):
                        ptrs[v], tops[v] = p, top
                    if op.pc:
                        state["pc_ptr"] = new_ptrs[-1]
                else:
                    entries = [(stacks[v], ptrs[v], tops[v]) for v in op.vars]
                    if op.pc:
                        entries.append((state["pc_stack"], state["pc_ptr"], state["pc_top"]))
                    new_ptrs, new_tops = op.call(entries, mask)
                    for v, p, top in zip(op.vars, new_ptrs, new_tops):
                        ptrs[v], tops[v] = p, top
                    if op.pc:
                        state["pc_ptr"], state["pc_top"] = new_ptrs[-1], new_tops[-1]

            # The pc stack's push or pop already ran in its group.
            pc_top = state["pc_top"]
            if isinstance(t, (ir.LJump, ir.LPushJump)):
                pc_top = pc_top.masked_fill(mask, t.target)
            elif isinstance(t, ir.LBranch):
                cond = read(t.var)
                cond = cond if cond.dtype == torch.bool else cond != 0
                chosen = torch.where(cond, *branch_targets)
                pc_top = torch.where(mask, chosen, pc_top)
            elif not isinstance(t, ir.LReturn):  # pragma: no cover
                raise AssertionError(t)
            state["pc_top"] = pc_top
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
