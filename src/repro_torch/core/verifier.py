"""Executable invariants of the lowered, stack-explicit IR.

The paper's transformation is only sound if the lowered program
(``ir.LoweredProgram``) stays semantically equivalent to the source
program while lowering, fusion and the other pipeline passes rewrite it.
:func:`verify` checks every invariant those transforms rely on:

* **CFG well-formedness** — every block has a lowered terminator, every
  terminator target (including ``LPushJump.ret``) is in range, every
  ``LPushJump`` targets a function entry, and every load-bearing block
  (``analysis.pinned_blocks``: program entry, function entries, return
  sites) is reachable from the control roots.
* **Stack balance** — along every acyclic path of every function frame,
  each variable's push/pop delta is non-negative, merge points agree,
  and ``LReturn`` is reached with all deltas at zero
  (``analysis.stack_effects``).
* **Variable classes** — ``stack_vars`` is exactly the set of variables
  some ``LPush``/``LPop`` touches, and ``temp_vars`` (which never enter
  VM state) are written before every read within each block that
  mentions them.
* **Types** — every mentioned variable has a spec, ``LPush`` sources
  match their destination, and every ``LPrim`` agrees with its declared
  output specs, typed on fake tensors by ``analysis.eval_spec`` (the
  helper type inference uses, so nothing is run).
* **Provenance** — ``fused_from`` covers every block with a non-empty
  source chain, and no two blocks claim the same chain head (unless the
  profile-guided inliner legitimately tail-duplicated whole frames).
* **Layout packing** — every ``state_layout`` group packs ≥ 2 same-spec,
  non-stack member variables into a packed array whose spec is
  ``(k,) + member_shape``; members are block-local temps, belong to
  exactly one group, and the packed array itself is VM state.
* **Reordering** — ``block_order``, when present, is a permutation of
  ``0..n-1`` (the ``BlockReordering`` provenance).

``PassPipeline`` (passes.py) runs :func:`verify` between passes so a
broken transform is caught at the pass that produced it, not at runtime.
"""
from __future__ import annotations

from typing import Optional

from ..device import resolve_device
from . import analysis, ir


class VerificationError(ValueError):
    """A ``LoweredProgram`` violates a structural or semantic invariant."""


def verify(
    lowered: ir.LoweredProgram,
    *,
    check_specs: bool = True,
    device=None,
    typed: Optional[dict] = None,
) -> None:
    """Raise :class:`VerificationError` on the first violated invariant.

    ``check_specs=False`` skips the fake-tensor type check of every
    primitive (the one non-structural — and by far the most expensive —
    invariant).  The type check's fake tensors lie on ``device``, else on
    ``lowered.device`` (where the program was typed), else on the card.
    ``typed``, a dict the caller keeps across calls (``PassPipeline`` does,
    across its passes), remembers each primitive's output specs for its
    input specs, so an unchanged primitive is typed once; its outputs are
    still checked against every program's ``var_specs``.
    """
    _check_structure(lowered)
    _check_reachability(lowered)
    _check_stack_balance(lowered)
    _check_var_classes(lowered)
    if check_specs:
        _check_specs(lowered, resolve_device(device or lowered.device), typed)
    _check_provenance(lowered)
    _check_layout(lowered)
    _check_reorder(lowered)


def _fail(msg: str) -> None:
    raise VerificationError(msg)


def _label(lowered: ir.LoweredProgram, i: int) -> str:
    return f"block {i} ({lowered.blocks[i].label or 'unlabeled'})"


# --------------------------------------------------------------------------
# Structure + reachability
# --------------------------------------------------------------------------


def _check_structure(lowered: ir.LoweredProgram) -> None:
    n = len(lowered.blocks)
    if n == 0:
        _fail("program has no blocks")
    if not (0 <= lowered.entry < n):
        _fail(f"entry {lowered.entry} is out of range [0, {n})")
    for fname, e in lowered.func_entries.items():
        if not (0 <= e < n):
            _fail(f"entry of function {fname!r} is out of range: {e}")
    entries = set(lowered.func_entries.values())
    if lowered.entry not in entries:
        _fail(f"entry {lowered.entry} is not a function entry")
    for i, blk in enumerate(lowered.blocks):
        for op in blk.ops:
            if not isinstance(op, (ir.LPrim, ir.LPush, ir.LPop)):
                _fail(f"{_label(lowered, i)}: invalid lowered op {op!r}")
        t = blk.term
        if not isinstance(t, (ir.LJump, ir.LBranch, ir.LPushJump,
                              ir.LReturn)):
            _fail(f"{_label(lowered, i)}: invalid terminator {t!r}")
        for tgt in analysis.lowered_targets(t):
            if not (0 <= tgt < n):
                _fail(
                    f"{_label(lowered, i)}: terminator target {tgt} is "
                    f"out of range [0, {n})"
                )
        if isinstance(t, ir.LPushJump) and t.target not in entries:
            _fail(
                f"{_label(lowered, i)}: pushjump target {t.target} is "
                "not a function entry"
            )


def _check_reachability(lowered: ir.LoweredProgram) -> None:
    roots = {lowered.entry} | set(lowered.func_entries.values())
    reachable: set[int] = set()
    stack = list(roots)
    while stack:
        b = stack.pop()
        if b in reachable:
            continue
        reachable.add(b)
        stack.extend(analysis.lowered_targets(lowered.blocks[b].term))
    for b in sorted(analysis.pinned_blocks(lowered)):
        if b not in reachable:
            _fail(
                f"pinned {_label(lowered, b)} is unreachable from the "
                "control roots (entry + function entries)"
            )


# --------------------------------------------------------------------------
# Stack balance
# --------------------------------------------------------------------------


def _check_stack_balance(lowered: ir.LoweredProgram) -> None:
    try:
        analysis.stack_effects(lowered)
    except ValueError as e:
        raise VerificationError(f"stack balance: {e}") from e


# --------------------------------------------------------------------------
# Variable classes (stack_vars exactness, temp def-before-use)
# --------------------------------------------------------------------------


def _check_var_classes(lowered: ir.LoweredProgram) -> None:
    actual = frozenset(
        op.var
        for blk in lowered.blocks
        for op in blk.ops
        if isinstance(op, (ir.LPush, ir.LPop))
    )
    if actual != lowered.stack_vars:
        missing = sorted(actual - lowered.stack_vars)
        extra = sorted(lowered.stack_vars - actual)
        _fail(
            "stack_vars is not exactly the pushed/popped set: "
            f"missing {missing}, extra {extra}"
        )
    overlap = lowered.temp_vars & lowered.stack_vars
    if overlap:
        _fail(f"temp_vars overlap stack_vars: {sorted(overlap)}")
    io = set(lowered.main_params) | set(lowered.main_outputs)
    if lowered.state_layout is not None:
        # Packed members are block-local by construction: their cross-block
        # value lives in the packed array, so a main param/output member is
        # legitimately a temp (the VM boundary reads/writes the packed slot).
        io -= lowered.state_layout.members()
    bad_io = lowered.temp_vars & io
    if bad_io:
        _fail(f"temp_vars include main params/outputs: {sorted(bad_io)}")
    for i, blk in enumerate(lowered.blocks):
        written: set[str] = set()
        for op in blk.ops:
            for r in ir.prim_reads(op):
                if r in lowered.temp_vars and r not in written:
                    _fail(
                        f"{_label(lowered, i)}: temp var {r!r} is read "
                        "before any write in this block (def-before-use)"
                    )
            written.update(ir.prim_writes(op))
        if (
            isinstance(blk.term, ir.LBranch)
            and blk.term.var in lowered.temp_vars
            and blk.term.var not in written
        ):
            _fail(
                f"{_label(lowered, i)}: temp var {blk.term.var!r} is "
                "read by the terminator but never written in this block"
            )


# --------------------------------------------------------------------------
# Types (var_specs consistency via analysis.eval_spec)
# --------------------------------------------------------------------------


def _specs_eq(a, b) -> bool:
    return tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype


def _check_specs(lowered: ir.LoweredProgram, device, typed) -> None:
    specs = lowered.var_specs
    for v in (*lowered.main_params, *lowered.main_outputs):
        if v not in specs:
            _fail(f"main variable {v!r} has no var_specs entry")
    checked: set[int] = set()  # fusion tail-duplicates share op objects
    for i, blk in enumerate(lowered.blocks):
        for op in blk.ops:
            for v in (*ir.prim_reads(op), *ir.prim_writes(op)):
                if v not in specs:
                    _fail(
                        f"{_label(lowered, i)}: variable {v!r} has no "
                        "var_specs entry"
                    )
            if isinstance(op, ir.LPush):
                if not _specs_eq(specs[op.var], specs[op.src]):
                    _fail(
                        f"{_label(lowered, i)}: push {op.var} <- {op.src} "
                        f"mixes specs {specs[op.var]} vs {specs[op.src]}"
                    )
                continue
            if not isinstance(op, ir.LPrim) or id(op) in checked:
                continue
            checked.add(id(op))
            _check_prim(lowered, i, op, specs, device, typed)
        if isinstance(blk.term, ir.LBranch) and blk.term.var not in specs:
            _fail(
                f"{_label(lowered, i)}: branch variable {blk.term.var!r} "
                "has no var_specs entry"
            )


def _check_prim(lowered, i: int, op: ir.LPrim, specs, device, typed) -> None:
    in_specs = tuple(specs[v] for v in op.ins)
    # The entry holds the op itself, so its id cannot be reused meanwhile.
    hit = None if typed is None else typed.get(id(op))
    if hit is not None and hit[0] is op and hit[1] == in_specs:
        outs = hit[2]
    else:
        try:
            outs = analysis.eval_spec(op, list(in_specs), device)
        except Exception as e:
            raise VerificationError(
                f"{_label(lowered, i)}: primitive {op.name!r}({op.ins}) does "
                f"not type-check: {e}"
            ) from e
        if typed is not None:
            typed[id(op)] = (op, in_specs, outs)
    if len(outs) != len(op.outs):
        _fail(
            f"{_label(lowered, i)}: primitive {op.name!r} returns "
            f"{len(outs)} values for {len(op.outs)} outputs"
        )
    for name, o in zip(op.outs, outs):
        if not _specs_eq(specs[name], o):
            _fail(
                f"{_label(lowered, i)}: primitive {op.name!r} writes "
                f"{name!r} as {o} but var_specs declares {specs[name]}"
            )


# --------------------------------------------------------------------------
# Fusion provenance
# --------------------------------------------------------------------------


def _check_provenance(lowered: ir.LoweredProgram) -> None:
    prov = lowered.fused_from
    if prov is None:
        return
    n = len(lowered.blocks)
    if set(prov) != set(range(n)):
        missing = sorted(set(range(n)) - set(prov))
        extra = sorted(set(prov) - set(range(n)))
        _fail(
            f"fused_from keys are not exactly 0..{n - 1}: "
            f"missing blocks {missing}, extra keys {extra}"
        )
    heads: dict[int, int] = {}
    for b in range(n):
        srcs = prov[b]
        if not srcs:
            _fail(f"fused_from[{b}] is empty: block {b} has no provenance")
        for s in srcs:
            if not isinstance(s, int) or s < 0:
                _fail(f"fused_from[{b}] has invalid source index {s!r}")
        if len(set(srcs)) != len(srcs):
            _fail(f"fused_from[{b}] repeats a source block: {srcs}")
        head = srcs[0]
        if head in heads and lowered.block_weights is None:
            # Structural fusion never duplicates a chain head; the
            # profile-guided inliner (which seeds block_weights) does —
            # a tail-duplicated frame copy shares its source chain.
            _fail(
                f"blocks {heads[head]} and {b} both claim original block "
                f"{head} as their chain head (provenance is not a "
                "partition)"
            )
        heads[head] = b


# --------------------------------------------------------------------------
# PGO invariants: state-layout packing + block reordering
# --------------------------------------------------------------------------


def _check_layout(lowered: ir.LoweredProgram) -> None:
    layout = lowered.state_layout
    if layout is None:
        return
    seen: dict[str, str] = {}
    for packed, members in layout.groups.items():
        if len(members) < 2:
            _fail(
                f"layout group {packed!r} packs {len(members)} member(s); "
                "a group needs >= 2 to cut masked updates"
            )
        if packed not in lowered.var_specs:
            _fail(f"packed variable {packed!r} has no var_specs entry")
        if packed in lowered.temp_vars or packed in lowered.stack_vars:
            _fail(
                f"packed variable {packed!r} must be VM state "
                f"(class {lowered.var_class(packed)!r})"
            )
        pspec = lowered.var_specs[packed]
        mspecs = []
        for m in members:
            if m in seen:
                _fail(
                    f"layout member {m!r} belongs to both {seen[m]!r} "
                    f"and {packed!r}"
                )
            seen[m] = packed
            if m in lowered.stack_vars:
                _fail(f"layout member {m!r} is a stack variable")
            if m not in lowered.temp_vars:
                _fail(
                    f"layout member {m!r} must be a block-local temp "
                    f"(class {lowered.var_class(m)!r})"
                )
            if m not in lowered.var_specs:
                _fail(f"layout member {m!r} has no var_specs entry")
            mspecs.append(lowered.var_specs[m])
        first = mspecs[0]
        for m, s in zip(members, mspecs):
            if not _specs_eq(s, first):
                _fail(
                    f"layout group {packed!r} mixes member specs: "
                    f"{members[0]!r} is {first} but {m!r} is {s}"
                )
        want = (len(members),) + tuple(first.shape)
        if tuple(pspec.shape) != want or pspec.dtype != first.dtype:
            _fail(
                f"packed variable {packed!r} spec {pspec} does not match "
                f"(k,) + member shape {want} / dtype {first.dtype}"
            )


def _check_reorder(lowered: ir.LoweredProgram) -> None:
    n = len(lowered.blocks)
    if lowered.block_weights is not None and len(lowered.block_weights) != n:
        _fail(
            f"block_weights has {len(lowered.block_weights)} entries for "
            f"{n} blocks"
        )
    order = lowered.block_order
    if order is None:
        return
    if sorted(order) != list(range(n)):
        _fail(
            f"block_order is not a permutation of 0..{n - 1}: {order}"
        )
