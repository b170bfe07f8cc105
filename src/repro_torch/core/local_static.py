"""Local static autobatching (paper Algorithm 1 / Section 2) on PyTorch.

A non-standard interpreter of the *source* IR: data and an active-set mask
live on the device, control flow and recursion on the host (each ``Call``
recurses through the Python stack, as in the paper's Figure 1).  Within
one function invocation the interpreter repeatedly runs the earliest
basic block any locally active member waits at, with every update masked.

Two modes, the paper's two arms:

* ``jit_blocks=True`` (the ``local`` backend, the "hybrid" arm): the host
  drives control, and each block segment — a maximal run of primitives,
  with the block's terminator after the last — runs as one replay of a
  ``torch.cuda.CUDAGraph``, the counterpart of the JAX package's
  ``jax.jit`` per segment.  A segment is captured at its first use, once
  per (function, block, segment): it warms up on a side stream, its inputs
  are copied into static buffers before each replay and its outputs copied
  out after it (the next replay overwrites them).  All of a batcher's
  graphs share one memory pool.  A capture that fails raises.  On the CPU
  (only when asked for) segments run eagerly, as in ``local_eager``.
* ``jit_blocks=False`` (``local_eager``): every primitive is issued one by
  one.

Both modes compute the same tensors with the same kernels.  The limitation
the paper points at is structural: because recursion is carried by the
host stack, members at different recursion depths never batch together —
each ``Call`` runs a fresh interpreter for its locally active subset only.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import analysis, ir

_I32 = torch.int32
#: The pc of a member that returned from the current invocation.
DONE_PC = int(np.iinfo(np.int32).max)


def _masked(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)


@dataclass
class LocalStats:
    block_execs: int = 0
    primitive_execs: int = 0
    tag_execs: dict[str, int] = field(default_factory=dict)
    tag_active: dict[str, int] = field(default_factory=dict)


class _Segment:
    """A maximal run of primitives (and the block's terminator after the
    last run): ``(env, pc, mask) -> (env, pc)``, eager."""

    def __init__(self, ops: list[ir.Prim], term: Optional[ir.Terminator],
                 batch_size: int, device: torch.device):
        self.ops = ops
        self.term = term
        self.batch_size = batch_size
        # Constants are made once, on the device (a tuple of outputs);
        # unbatched prims run under vmap.
        self._fns: list[Any] = []
        for op in ops:
            if not op.ins and not op.batched:
                outs = op.fn()
                outs = outs if isinstance(outs, tuple) else (outs,)
                self._fns.append(tuple(torch.as_tensor(o).to(device) for o in outs))
            else:
                self._fns.append(op.fn if op.batched else torch.func.vmap(op.fn))
        self._targets = None
        if isinstance(term, ir.Branch):
            self._targets = (torch.tensor(term.true, dtype=_I32, device=device),
                             torch.tensor(term.false, dtype=_I32, device=device))
        # The variables a run reads: every input, every output (a masked
        # write reads the old value) and the branch condition.
        names = [n for op in ops for n in (*op.ins, *op.outs)]
        if isinstance(term, ir.Branch):
            names.append(term.var)
        self.names = tuple(dict.fromkeys(names))
        self.writes = tuple(dict.fromkeys(n for op in ops for n in op.outs))

    def __call__(self, env: dict[str, torch.Tensor], pc: torch.Tensor,
                 mask: torch.Tensor) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        env = dict(env)
        z = self.batch_size
        for op, fn in zip(self.ops, self._fns):
            if isinstance(fn, tuple):  # a constant, broadcast to the batch
                outs = tuple(c.expand((z,) + c.shape) for c in fn)
            else:
                outs = fn(*[env[i] for i in op.ins])
                if len(op.outs) == 1:
                    outs = (outs,)
            for name, val in zip(op.outs, outs):
                if name in env:
                    env[name] = _masked(mask, val.to(env[name].dtype), env[name])
                else:
                    env[name] = val  # first definition; junk rows masked later
        t = self.term
        if isinstance(t, ir.Jump):
            pc = pc.masked_fill(mask, t.target)
        elif isinstance(t, ir.Branch):
            cond = env[t.var]
            cond = cond if cond.dtype == torch.bool else cond != 0
            pc = torch.where(mask, torch.where(cond, *self._targets), pc)
        elif isinstance(t, ir.Return):
            pc = pc.masked_fill(mask, DONE_PC)
        elif t is not None:  # pragma: no cover
            raise AssertionError(t)
        return env, pc


class _GraphSegment:
    """A :class:`_Segment` replayed from a CUDA graph captured at first
    use; the same inputs give the same outputs as the eager segment."""

    def __init__(self, seg: _Segment, pool):
        self.seg = seg
        self.ops = seg.ops
        self._pool = pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    def _capture(self, env, pc, mask) -> None:
        names = [n for n in self.seg.names if n in env]
        self._in = {n: torch.empty_like(env[n]) for n in names}
        self._pc, self._mask = torch.empty_like(pc), torch.empty_like(mask)
        self._load(env, pc, mask)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.seg(self._in, self._pc, self._mask)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out_env, out_pc = self.seg(self._in, self._pc, self._mask)
        self._out = {n: out_env[n] for n in self.seg.writes}
        self._out_pc = out_pc
        self._graph = graph

    def _load(self, env, pc, mask) -> None:
        for n, buf in self._in.items():
            buf.copy_(env[n])
        self._pc.copy_(pc)
        self._mask.copy_(mask)

    def __call__(self, env, pc, mask):
        if self._graph is None:
            self._capture(env, pc, mask)
        else:
            self._load(env, pc, mask)
        self._graph.replay()
        env = dict(env)
        for n, out in self._out.items():
            env[n] = out.clone()
        pc = self._out_pc.clone() if self.seg.term is not None else pc
        return env, pc


class LocalStaticBatcher:
    """Batched executor for a source :class:`ir.Program` (Algorithm 1) on
    ``device`` (the card unless the caller names another)."""

    def __init__(self, program: ir.Program, batch_size: int, jit_blocks: bool = True,
                 device=None):
        self.device = resolve_device(device)
        program.validate()
        analysis.infer_types(program, self.device)
        self.program = program
        self.batch_size = batch_size
        self.jit_blocks = jit_blocks
        graphs = jit_blocks and self.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if graphs else None
        # (fname, block_idx) -> [("seg", segment) | ("call", Call)]
        self._plans: dict[tuple[str, int], list[tuple[str, Any]]] = {}
        for fname, func in program.functions.items():
            for bi, blk in enumerate(func.blocks):
                plan: list[tuple[str, Any]] = []
                run: list[ir.Prim] = []
                for op in blk.ops:
                    if isinstance(op, ir.Prim):
                        run.append(op)
                        continue
                    if run:
                        plan.append(("seg", self._segment(run, None, pool)))
                        run = []
                    plan.append(("call", op))
                plan.append(("seg", self._segment(run, blk.term, pool)))
                self._plans[(fname, bi)] = plan
        self.stats = LocalStats()

    def _segment(self, ops, term, pool):
        seg = _Segment(ops, term, self.batch_size, self.device)
        return seg if pool is None else _GraphSegment(seg, pool)

    def run(self, inputs: dict[str, Any]) -> dict[str, torch.Tensor]:
        main = self.program.functions[self.program.main]
        z = self.batch_size
        args = []
        for p in main.params:
            spec = main.param_specs[p]
            x = torch.as_tensor(inputs[p])
            if tuple(x.shape) != (z,) + spec.shape:
                raise ValueError(
                    f"input {p!r}: expected {(z,) + spec.shape}, got {tuple(x.shape)}"
                )
            args.append(x.to(device=self.device, dtype=spec.dtype))
        active = torch.ones((z,), dtype=torch.bool, device=self.device)
        outs = self._run_function(main, args, active, np.ones(z, bool))
        return dict(zip(main.outputs, outs))

    def _run_function(self, func: ir.Function, args: list[torch.Tensor],
                      active: torch.Tensor, act_np: np.ndarray) -> list[torch.Tensor]:
        """Run ``func`` to completion for the ``active`` lanes (``act_np``
        is the same mask on the host)."""
        z, dev, stats = self.batch_size, self.device, self.stats
        env: dict[str, torch.Tensor] = {
            v: torch.zeros((z,) + spec.shape, dtype=spec.dtype, device=dev)
            for v, spec in func.var_specs.items()
        }
        env.update(zip(func.params, args))
        pc = torch.where(active, 0, DONE_PC).to(_I32)
        while True:
            pc_np = pc.cpu().numpy()  # the one host read of a block
            live = act_np & (pc_np != DONE_PC)
            if not live.any():
                break
            i = int(pc_np[live].min())
            at_i = act_np & (pc_np == i)
            mask = active & (pc == i)
            stats.block_execs += 1
            for kind, item in self._plans[(func.name, i)]:
                if kind == "seg":
                    env, pc = item(env, pc, mask)
                    stats.primitive_execs += len(item.ops)
                    n_active = int(at_i.sum())
                    for op in item.ops:
                        if op.tag:
                            stats.tag_execs[op.tag] = stats.tag_execs.get(op.tag, 0) + 1
                            stats.tag_active[op.tag] = (
                                stats.tag_active.get(op.tag, 0) + n_active
                            )
                    continue
                callee = self.program.functions[item.callee]
                # Host recursion (the paper's Figure 1): the callee runs to
                # completion for the locally active subset.
                outs = self._run_function(callee, [env[a] for a in item.ins], mask, at_i)
                for name, val in zip(item.outs, outs):
                    env[name] = _masked(mask, val.to(env[name].dtype), env[name])
        return [env[o] for o in func.outputs]
