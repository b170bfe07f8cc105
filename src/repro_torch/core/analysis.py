"""Static analyses over the source and lowered IRs.

Source-IR analyses drive the paper's five lowering optimizations:
  (i)   per-variable caller-saves stacks     -> save sets from liveness,
  (ii)  block-local temporaries              -> syntactic def-before-use,
  (iii) stack only when live across a call   -> save sets / recursion info,
  (iv)  top-of-stack caching                 -> structural in the VM,
  (v)   pop-push elimination                 -> peephole in lowering.py.

Lowered-IR analyses drive the pass pipeline (passes.py) and the default
stack depth: :class:`LoweredLiveness` (dead-code elimination),
:func:`stack_effects` (per-function stack-balance dataflow) and
:func:`stack_depth_bound` (interprocedural worst-case stack depth, the
static replacement for the magic ``max_depth=32``).

Type inference (:func:`infer_types`) and the verifier type every primitive
through one helper, :func:`eval_spec`: the primitive runs under
``torch.func.vmap`` on a batch of one member made of fake tensors
(:mod:`repro_torch.fake`) on the program's device, so no data is read and
nothing is computed, as ``jax.eval_shape`` types it in the JAX package.
Real tensors the primitive closes over (a target's data set) are faked
where they are used, and the vmap checks up front that it batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import fake
from ..device import resolve_device
from . import ir


# --------------------------------------------------------------------------
# Reads/writes of source ops
# --------------------------------------------------------------------------


def op_reads(op: ir.Op) -> tuple[str, ...]:
    return op.ins


def op_writes(op: ir.Op) -> tuple[str, ...]:
    return op.outs


def term_reads(term: ir.Terminator) -> tuple[str, ...]:
    if isinstance(term, ir.Branch):
        return (term.var,)
    return ()


# --------------------------------------------------------------------------
# Liveness (per function, backward dataflow over the source CFG)
# --------------------------------------------------------------------------


class Liveness:
    """Per-block live-in/live-out, plus live-after sets for each op index.

    ``live_after(block, op_index)`` is the set of variables whose current
    value may still be read on some path after op ``op_index`` of ``block``
    has executed (excluding that op's own writes-before-reads semantics).
    """

    def __init__(self, func: ir.Function):
        self.func = func
        n = len(func.blocks)
        self.live_in: list[set[str]] = [set() for _ in range(n)]
        self.live_out: list[set[str]] = [set() for _ in range(n)]
        self._solve()

    def _block_use_def(self, blk: ir.Block) -> tuple[set[str], set[str]]:
        use: set[str] = set()
        defined: set[str] = set()
        for op in blk.ops:
            for r in op_reads(op):
                if r not in defined:
                    use.add(r)
            defined.update(op_writes(op))
        for r in term_reads(blk.term):
            if r not in defined:
                use.add(r)
        return use, defined

    def _solve(self) -> None:
        func = self.func
        n = len(func.blocks)
        use_def = [self._block_use_def(b) for b in func.blocks]
        # Function outputs are live at every Return.
        out_live = set(func.outputs)
        changed = True
        while changed:
            changed = False
            for i in range(n - 1, -1, -1):
                term = func.blocks[i].term
                if isinstance(term, ir.Return):
                    new_out = set(out_live)
                else:
                    new_out = set()
                    for s in ir.successors(func.blocks, i):
                        new_out |= self.live_in[s]
                use, defined = use_def[i]
                new_in = use | (new_out - defined)
                if new_out != self.live_out[i] or new_in != self.live_in[i]:
                    self.live_out[i] = new_out
                    self.live_in[i] = new_in
                    changed = True
        # Per-op live-after sets, cached at solve time.  One backward scan
        # per block here makes every live_after() query O(1) instead of
        # rescanning the block suffix — this is a hot path now that the
        # pass pipeline re-runs analyses after every transform.
        self._after: list[list[frozenset[str]]] = []
        for i, blk in enumerate(func.blocks):
            live = set(self.live_out[i])
            live.update(term_reads(blk.term))
            after: list[frozenset[str]] = [frozenset()] * len(blk.ops)
            for j in range(len(blk.ops) - 1, -1, -1):
                after[j] = frozenset(live)
                op = blk.ops[j]
                live -= set(op_writes(op))
                live |= set(op_reads(op))
            self._after.append(after)

    def live_after(self, block_idx: int, op_idx: int) -> set[str]:
        """Variables live immediately after op ``op_idx`` in ``block_idx``."""
        return set(self._after[block_idx][op_idx])


# --------------------------------------------------------------------------
# Lowered-CFG structure (drives the superblock fusion pass in fusion.py)
# --------------------------------------------------------------------------


def lowered_targets(term: "ir.LTerminator") -> tuple[int, ...]:
    """Every block index a lowered terminator can transfer control to
    *statically*.  ``LPushJump`` contributes both its callee entry and its
    return address (the latter is entered dynamically via ``LReturn``);
    ``LReturn`` itself contributes nothing — its target is on the pc stack.
    """
    if isinstance(term, ir.LJump):
        return (term.target,)
    if isinstance(term, ir.LBranch):
        return (term.true, term.false)
    if isinstance(term, ir.LPushJump):
        return (term.target, term.ret)
    return ()


def pinned_blocks(lowered: "ir.LoweredProgram") -> frozenset[int]:
    """Blocks whose *index* is load-bearing and must survive fusion intact:
    the program entry, every function entry (``LPushJump`` targets), and
    every return site (``LPushJump.ret`` addresses, entered dynamically by
    ``LReturn`` popping the pc stack).  Fusion may copy their ops into a
    predecessor but must never remove or renumber-away these blocks while
    they are reachable.
    """
    pinned = {lowered.entry} | set(lowered.func_entries.values())
    for blk in lowered.blocks:
        if isinstance(blk.term, ir.LPushJump):
            pinned.add(blk.term.target)
            pinned.add(blk.term.ret)
    return frozenset(pinned)


# --------------------------------------------------------------------------
# Lowered-CFG liveness (drives dead-code elimination in passes.py)
# --------------------------------------------------------------------------


class LoweredLiveness:
    """Backward liveness of variable *tops* over the lowered CFG.

    Deliberately conservative about dynamic control flow: an ``LReturn``
    may resume at *any* return site (every ``LPushJump.ret``) or at
    program exit (where ``main_outputs`` stay live), so its live-out is
    the union over all of them.  ``LPush`` reads both its source and the
    variable it buries — the buried value is restored by a later ``LPop``
    and may be read afterwards — so a value that reaches a push is never
    considered dead.
    """

    def __init__(self, lowered: ir.LoweredProgram):
        self.lowered = lowered
        n = len(lowered.blocks)
        self.live_in: list[set[str]] = [set() for _ in range(n)]
        self.live_out: list[set[str]] = [set() for _ in range(n)]
        self._ret_sites = tuple(sorted({
            blk.term.ret
            for blk in lowered.blocks
            if isinstance(blk.term, ir.LPushJump)
        }))
        self._solve()

    @staticmethod
    def op_reads(op: ir.LOp) -> tuple[str, ...]:
        if isinstance(op, ir.LPush):
            return (op.src, op.var)
        return ir.prim_reads(op)

    def successors(self, i: int) -> tuple[int, ...]:
        t = self.lowered.blocks[i].term
        if isinstance(t, ir.LJump):
            return (t.target,)
        if isinstance(t, ir.LBranch):
            return (t.true, t.false)
        if isinstance(t, ir.LPushJump):
            return (t.target,)
        return self._ret_sites  # LReturn: any ret site (exit is separate)

    def _block_use_def(self, blk: ir.LBlock) -> tuple[set[str], set[str]]:
        use: set[str] = set()
        defined: set[str] = set()
        for op in blk.ops:
            for r in self.op_reads(op):
                if r not in defined:
                    use.add(r)
            defined.update(ir.prim_writes(op))
        if isinstance(blk.term, ir.LBranch) and blk.term.var not in defined:
            use.add(blk.term.var)
        return use, defined

    def _solve(self) -> None:
        blocks = self.lowered.blocks
        exit_live = set(self.lowered.main_outputs)
        if self.lowered.state_layout is not None:
            # A packed main output leaves the VM through its packed array
            # (the boundary reads ``tops[packed][:, slot]``), so it is the
            # *packed* variable that must stay live at exit.
            for o in tuple(exit_live):
                packed_slot = self.lowered.state_layout.slot_of(o)
                if packed_slot is not None:
                    exit_live.discard(o)
                    exit_live.add(packed_slot[0])
        use_def = [self._block_use_def(b) for b in blocks]
        changed = True
        while changed:
            changed = False
            for i in range(len(blocks) - 1, -1, -1):
                new_out: set[str] = set()
                if isinstance(blocks[i].term, ir.LReturn):
                    new_out |= exit_live
                for s in self.successors(i):
                    new_out |= self.live_in[s]
                use, defined = use_def[i]
                new_in = use | (new_out - defined)
                if new_out != self.live_out[i] or new_in != self.live_in[i]:
                    self.live_out[i] = new_out
                    self.live_in[i] = new_in
                    changed = True


# --------------------------------------------------------------------------
# Interprocedural stack effects + static stack-depth bound
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class FunctionStackEffects:
    """Stack-balance summary of one function's lowered body.

    ``entry_deltas[b]`` is the per-variable stack delta (pushes minus
    pops, relative to the function's own entry) on entry to block ``b``;
    zero entries are dropped.  ``local_peaks[v]`` is the largest standing
    delta ``v`` reaches anywhere in the body.  ``calls`` records each
    ``LPushJump`` site as ``(block, callee, standing deltas)`` — the
    deltas held *while the callee runs*.
    """

    name: str
    entry_deltas: dict[int, dict[str, int]]
    local_peaks: dict[str, int]
    calls: tuple[tuple[int, str, dict[str, int]], ...]


def stack_effects(
    lowered: ir.LoweredProgram,
) -> dict[str, FunctionStackEffects]:
    """Per-function stack-balance dataflow over the lowered CFG.

    This is the JVM-bytecode-style verification of the paper's calling
    convention: within one frame, every variable's stack delta must be
    non-negative everywhere, merge points must agree, and every
    ``LReturn`` must be reached with all deltas at zero (the caller's
    return site pops exactly what the call site pushed).  A call is
    summarized as a net-zero edge from the ``LPushJump`` block to its
    return site.

    Raises ``ValueError`` naming the function, block and variable on any
    violation.
    """
    entry_of = {e: f for f, e in lowered.func_entries.items()}
    out: dict[str, FunctionStackEffects] = {}
    for fname, entry in lowered.func_entries.items():
        entry_deltas: dict[int, dict[str, int]] = {}
        local_peaks: dict[str, int] = {}
        calls: list[tuple[int, str, dict[str, int]]] = []
        work: list[tuple[int, dict[str, int]]] = [(entry, {})]
        while work:
            b, delta = work.pop()
            if b in entry_deltas:
                if entry_deltas[b] != delta:
                    raise ValueError(
                        f"{fname}: block {b} "
                        f"({lowered.blocks[b].label or 'unlabeled'}) is "
                        f"reached with disagreeing stack deltas "
                        f"{entry_deltas[b]} vs {delta}"
                    )
                continue
            entry_deltas[b] = delta
            cur = dict(delta)
            blk = lowered.blocks[b]
            for op in blk.ops:
                if isinstance(op, ir.LPush):
                    cur[op.var] = cur.get(op.var, 0) + 1
                    local_peaks[op.var] = max(
                        local_peaks.get(op.var, 0), cur[op.var]
                    )
                elif isinstance(op, ir.LPop):
                    cur[op.var] = cur.get(op.var, 0) - 1
                    if cur[op.var] < 0:
                        raise ValueError(
                            f"{fname}: block {b} ({blk.label}): pop of "
                            f"{op.var!r} below the frame's stack floor "
                            "(unbalanced push/pop)"
                        )
            cur = {v: d for v, d in cur.items() if d}
            t = blk.term
            if isinstance(t, ir.LJump):
                work.append((t.target, cur))
            elif isinstance(t, ir.LBranch):
                work.append((t.true, cur))
                work.append((t.false, cur))
            elif isinstance(t, ir.LPushJump):
                callee = entry_of.get(t.target)
                if callee is None:
                    raise ValueError(
                        f"{fname}: block {b} ({blk.label}): pushjump "
                        f"target {t.target} is not a function entry"
                    )
                calls.append((b, callee, cur))
                work.append((t.ret, cur))
            elif isinstance(t, ir.LReturn):
                if cur:
                    raise ValueError(
                        f"{fname}: block {b} ({blk.label}): returns with "
                        f"non-zero stack delta for {sorted(cur)} "
                        "(unbalanced push/pop)"
                    )
            else:
                raise ValueError(
                    f"{fname}: block {b} ({blk.label}): invalid lowered "
                    f"terminator {t!r}"
                )
        out[fname] = FunctionStackEffects(
            fname, entry_deltas, local_peaks, tuple(calls)
        )
    return out


@dataclass(frozen=True)
class StackDepthReport:
    """Worst-case stack usage of a lowered program, statically bounded.

    For non-recursive call structures, ``required_max_depth`` is the
    smallest ``VMConfig.max_depth`` that can never overflow: the pc stack
    needs ``pc_depth + 1`` slots (the pc pointer starts at 1, above the
    exit sentinel) and each variable stack needs ``var_depths[v]`` slots.
    A recursive program has no static bound: ``required_max_depth`` and
    ``pc_depth`` are ``None`` and ``recursive_cycle`` names the cycle of
    functions whose call depth is input-dependent.
    """

    pc_depth: Optional[int]
    var_depths: dict[str, int]
    required_max_depth: Optional[int]
    recursive_cycle: Optional[tuple[str, ...]]


def stack_depth_bound(lowered: ir.LoweredProgram) -> StackDepthReport:
    """Interprocedural worst-case pc/variable stack depth from ``main``.

    Walks the lowered call graph (``LPushJump`` sites from
    :func:`stack_effects`) accumulating, per variable, the standing
    pushes held across each call plus the callee subtree's own peak.
    Only functions reachable from the program entry contribute — a
    registered-but-never-called recursive helper cannot overflow at run
    time and does not forfeit the static bound.
    """
    effects = stack_effects(lowered)
    entry_of = {e: f for f, e in lowered.func_entries.items()}
    main = entry_of[lowered.entry]
    memo: dict[str, tuple[int, dict[str, int]]] = {}
    path: list[str] = []
    cycle: Optional[tuple[str, ...]] = None

    def visit(f: str) -> tuple[int, dict[str, int]]:
        nonlocal cycle
        if f in memo:
            return memo[f]
        if f in path:
            if cycle is None:
                cycle = tuple(path[path.index(f):])
            return (0, {})
        path.append(f)
        eff = effects[f]
        pc = 0
        peaks = dict(eff.local_peaks)
        for _b, callee, standing in eff.calls:
            cpc, cpeaks = visit(callee)
            pc = max(pc, 1 + cpc)
            for v, p in cpeaks.items():
                peaks[v] = max(peaks.get(v, 0), standing.get(v, 0) + p)
        path.pop()
        memo[f] = (pc, peaks)
        return memo[f]

    pc, peaks = visit(main)
    if cycle is not None:
        return StackDepthReport(
            pc_depth=None, var_depths={}, required_max_depth=None,
            recursive_cycle=cycle,
        )
    required = max([pc + 1, 1] + list(peaks.values()))
    return StackDepthReport(
        pc_depth=pc, var_depths=peaks, required_max_depth=required,
        recursive_cycle=None,
    )


# --------------------------------------------------------------------------
# Call graph / recursion structure
# --------------------------------------------------------------------------


class CallGraph:
    def __init__(self, program: ir.Program):
        self.edges: dict[str, set[str]] = {f: set() for f in program.functions}
        for fname, func in program.functions.items():
            for blk in func.blocks:
                for op in blk.ops:
                    if isinstance(op, ir.Call):
                        self.edges[fname].add(op.callee)
        self._reach: dict[str, set[str]] = {}
        for f in self.edges:
            self._reach[f] = self._reachable(f)

    def _reachable(self, f: str) -> set[str]:
        seen: set[str] = set()
        stack = list(self.edges[f])
        while stack:
            g = stack.pop()
            if g in seen:
                continue
            seen.add(g)
            stack.extend(self.edges[g])
        return seen

    def can_reenter(self, caller: str, callee: str) -> bool:
        """Can a call from ``caller`` to ``callee`` lead back into ``caller``?

        If so, the caller must save (push) its live variables around the call.
        """
        return caller == callee or caller in self._reach[callee]

    def is_recursive(self, callee: str) -> bool:
        """Can ``callee`` transitively have two live frames at once?

        If so, arguments must be pushed onto the parameter stacks (burying the
        outer frame's values) rather than overwriting the tops.
        """
        return callee in self._reach[callee]


# --------------------------------------------------------------------------
# Type inference
# --------------------------------------------------------------------------


def _spec_of(x: torch.Tensor) -> ir.Spec:
    return ir.Spec(tuple(x.shape), x.dtype)


def _specs_eq(a: ir.Spec, b: ir.Spec) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype


def eval_spec(op, in_specs: list[ir.Spec], device) -> tuple[ir.Spec, ...]:
    """Output specs of one primitive (an ``ir.Prim`` or ``ir.LPrim``),
    typed on fake tensors without running it.

    Nullary primitives (constants) are called as they are.  Others run in
    :func:`fake.fake_mode` under ``torch.func.vmap`` on a batch of one fake
    zero member on ``device`` (``batched=True`` primitives directly on
    that batch) and lose the batch axis again.
    """
    if not op.ins and not op.batched:
        out = op.fn()
        outs = out if isinstance(out, tuple) else (out,)
        return tuple(_spec_of(torch.as_tensor(o)) for o in outs)
    with fake.fake_mode():
        args = [torch.zeros((1,) + s.shape, dtype=s.dtype, device=device)
                for s in in_specs]
        fn = op.fn if op.batched else torch.func.vmap(op.fn)
        out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    for o in outs:
        if o.dim() == 0 or o.shape[0] != 1:
            raise TypeError(
                f"primitive {op.name!r} output lost its batch axis: "
                f"{tuple(o.shape)}"
            )
    return tuple(ir.Spec(tuple(o.shape[1:]), o.dtype) for o in outs)


def infer_types(program: ir.Program, device=None) -> None:
    """Forward abstract interpretation filling ``Function.var_specs``.

    Function parameter and output specs are declared; locals are inferred
    by typing each ``Prim.fn`` on fake tensors (see :func:`eval_spec`) of
    ``device`` (the card unless the caller names another), which must be
    where the primitives' captured tensors live.  Merge
    points must agree exactly (we do not insert casts — the frontends emit
    explicit casts where needed).
    """
    device = resolve_device(device)
    for func in program.functions.values():
        specs: dict[str, ir.Spec] = dict(func.param_specs)
        typed: set[int] = set()
        pending = True
        guard = 0
        while pending:
            pending = False
            guard += 1
            if guard > len(func.blocks) * 4 + 16:
                missing = _missing_vars(func, specs)
                raise TypeError(
                    f"{func.name}: type inference did not converge; "
                    f"unresolved variables: {sorted(missing)}"
                )
            for blk in func.blocks:
                for op in blk.ops:
                    if isinstance(op, ir.Prim):
                        if not all(i in specs for i in op.ins):
                            if not all(o in specs for o in op.outs):
                                pending = True
                            continue
                        if id(op) in typed:
                            continue  # inputs are fixed once bound
                        typed.add(id(op))
                        try:
                            outs = eval_spec(
                                op, [specs[i] for i in op.ins], device
                            )
                        except Exception as e:  # pragma: no cover - error path
                            raise TypeError(
                                f"{func.name}: cannot type primitive "
                                f"{op.name!r}({op.ins}): {e}"
                            ) from e
                        if len(outs) != len(op.outs):
                            raise TypeError(
                                f"{func.name}: primitive {op.name!r} returned "
                                f"{len(outs)} values for {len(op.outs)} outputs"
                            )
                        for name, o in zip(op.outs, outs):
                            _bind(specs, name, o, func.name)
                    elif isinstance(op, ir.Call):
                        callee = program.functions[op.callee]
                        for name, oname in zip(op.outs, callee.outputs):
                            _bind(
                                specs,
                                name,
                                callee.output_specs[oname],
                                func.name,
                            )
        # Declared output specs must match inferred ones.
        for oname in func.outputs:
            declared = func.output_specs[oname]
            if oname in specs and not _specs_eq(specs[oname], declared):
                raise TypeError(
                    f"{func.name}: output {oname!r} declared "
                    f"{declared} but inferred {specs[oname]}"
                )
            specs[oname] = declared
        func.var_specs = specs

def _bind(specs, name, spec, fname) -> None:
    if name in specs and not _specs_eq(specs[name], spec):
        raise TypeError(
            f"{fname}: variable {name!r} assigned conflicting types "
            f"{specs[name]} vs {spec} (merge points must agree)"
        )
    specs[name] = spec


def _missing_vars(func: ir.Function, specs) -> set[str]:
    missing: set[str] = set()
    for blk in func.blocks:
        for op in blk.ops:
            missing |= {o for o in op.outs if o not in specs}
    return missing


def all_vars(func: ir.Function) -> set[str]:
    vs: set[str] = set(func.params) | set(func.outputs)
    for blk in func.blocks:
        for op in blk.ops:
            vs.update(op.ins)
            vs.update(op.outs)
        vs.update(term_reads(blk.term))
    return vs
