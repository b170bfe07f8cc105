"""Lowering from the source CFG IR (Fig. 2) to the stack-explicit merged
program (Fig. 4) that the program-counter VM executes.

The lowering implements the paper's calling convention and compiler
optimizations:

* **Caller-saves, per-variable stacks** (opt. i): at each call site that can
  re-enter the caller's frame, the caller pushes every variable that is live
  after the call (minus the call's outputs).  Argument passing into a
  recursive callee is itself a push onto the parameter's stack (burying the
  outer frame's value); the caller pops everything it pushed after the call
  returns.
* **Temporaries** (opt. ii): variables whose every read is preceded by a
  write within the same lowered block never enter VM state at all — they are
  ordinary intermediate values inside the fused block body.
* **Stack only when needed** (opt. iii): variables that are never pushed or
  popped get no stack or stack pointer; updates mask their cached top only.
* **Top-of-stack caching** (opt. iv): structural in the VM — every variable's
  current value lives in a dense ``[batch, ...]`` "top" buffer; the
  ``[depth, batch, ...]`` stack array is touched only by pushes and pops.
* **Pop-push elimination** (opt. v): within a block, ``pop v`` followed by
  ``push v <- src`` (``src != v``) with no intervening mention of ``v``
  cancels into a masked in-place update of the top.  This fires exactly in
  the hot "sequence of sibling calls" pattern (e.g. NUTS's two ``build_tree``
  recursions).
"""
from __future__ import annotations

import itertools
from typing import Any

from ..device import resolve_device
from . import analysis, ir

# Symbolic jump targets used during emission, patched at the end:
#   ("blk", fname, orig_block_idx)  -> lowered index of that block's head
#   ("entry", fname)                -> lowered entry of fname
#   int                             -> already-concrete lowered index
_Sym = Any


def lower(
    program: ir.Program, device=None, *, verify: bool = False
) -> ir.LoweredProgram:
    """Lower ``program`` to the stack-explicit merged form.

    Emission is followed by the block-local optimization passes
    (``passes.lowering_passes()``: pop-push elimination, temp detection).
    ``device`` is where type inference runs the primitives once (see
    ``analysis.infer_types``): the card unless the caller names another.
    With ``verify=True`` the lowered-IR verifier runs on the raw emission
    and between every pass.
    """
    device = resolve_device(device)
    program.validate()
    analysis.infer_types(program, device)
    cg = analysis.CallGraph(program)

    lowered: list[ir.LBlock] = []
    blockmap: dict[tuple[str, int], int] = {}
    func_entries: dict[str, int] = {}
    tmp_counter = itertools.count()

    def fresh(fname: str) -> str:
        return ir.qualify(fname, f"%arg{next(tmp_counter)}")

    # Qualified specs for every variable (temps added as we emit them).
    var_specs: dict[str, Any] = {}
    for fname, func in program.functions.items():
        for v, spec in func.var_specs.items():
            var_specs[ir.qualify(fname, v)] = spec

    for fname, func in program.functions.items():
        q = lambda v, _f=fname: ir.qualify(_f, v)
        lv = analysis.Liveness(func)
        for bi, blk in enumerate(func.blocks):
            cur = ir.LBlock(label=f"{fname}.{bi}")
            blockmap[(fname, bi)] = len(lowered)
            if bi == 0:
                func_entries[fname] = len(lowered)
            lowered.append(cur)
            for oi, op in enumerate(blk.ops):
                if isinstance(op, ir.Prim):
                    cur.ops.append(
                        ir.LPrim(
                            outs=tuple(q(o) for o in op.outs),
                            fn=op.fn,
                            ins=tuple(q(i) for i in op.ins),
                            name=op.name,
                            batched=op.batched,
                            tag=op.tag,
                        )
                    )
                    continue
                # ---- Call lowering ----
                callee = program.functions[op.callee]
                reenters = cg.can_reenter(fname, op.callee)
                recursive = cg.is_recursive(op.callee)
                # Save set: caller vars live after the call, minus the call's
                # own outputs, minus callee params (recursive self-calls pass
                # args by pushing the param itself, which is the save).
                saves: list[str] = []
                if reenters:
                    live = lv.live_after(bi, oi) - set(op.outs)
                    if op.callee == fname:
                        live -= set(callee.params)
                    saves = sorted(q(v) for v in live)
                # Argument values: route through fresh temps when the callee
                # is the caller (param writes could clobber arg reads).
                arg_srcs: list[str] = []
                for a in op.ins:
                    if op.callee == fname:
                        t = fresh(fname)
                        var_specs[t] = func.var_specs[a]
                        cur.ops.append(ir.identity_prim(t, q(a), name="argcopy"))
                        arg_srcs.append(t)
                    else:
                        arg_srcs.append(q(a))
                for v in saves:
                    cur.ops.append(ir.LPush(var=v, src=v))
                pushed_params: list[str] = []
                for p, src in zip(callee.params, arg_srcs):
                    pq = ir.qualify(op.callee, p)
                    if recursive:
                        cur.ops.append(ir.LPush(var=pq, src=src))
                        pushed_params.append(pq)
                    else:
                        cur.ops.append(ir.identity_prim(pq, src, name="argset"))
                ret_idx = len(lowered)
                cur.term = ir.LPushJump(target=("entry", op.callee), ret=ret_idx)
                # ---- Return-site block ----
                cur = ir.LBlock(label=f"{fname}.{bi}.ret{oi}")
                lowered.append(cur)
                for y, o in zip(op.outs, callee.outputs):
                    cur.ops.append(
                        ir.identity_prim(q(y), ir.qualify(op.callee, o), name="retval")
                    )
                for pq in reversed(pushed_params):
                    cur.ops.append(ir.LPop(var=pq))
                for v in reversed(saves):
                    cur.ops.append(ir.LPop(var=v))
            # ---- Original terminator ----
            t = blk.term
            if isinstance(t, ir.Jump):
                cur.term = ir.LJump(target=("blk", fname, t.target))
            elif isinstance(t, ir.Branch):
                cur.term = ir.LBranch(
                    var=q(t.var),
                    true=("blk", fname, t.true),
                    false=("blk", fname, t.false),
                )
            elif isinstance(t, ir.Return):
                cur.term = ir.LReturn()
            else:
                raise ValueError(
                    f"unterminated block {fname}.{bi} "
                    f"({blk.label or 'unlabeled'}): terminator {t!r} is not "
                    "a Jump, Branch or Return"
                )

    _patch_targets(lowered, blockmap, func_entries)

    stack_vars = frozenset(
        op.var
        for blk in lowered
        for op in blk.ops
        if isinstance(op, (ir.LPush, ir.LPop))
    )
    main = program.functions[program.main]
    main_params = tuple(ir.qualify(program.main, p) for p in main.params)
    main_outputs = tuple(ir.qualify(program.main, o) for o in main.outputs)
    temp_vars = find_temporaries(lowered, stack_vars, main_params, main_outputs)

    raw = ir.LoweredProgram(
        blocks=lowered,
        entry=func_entries[program.main],
        main_params=main_params,
        main_outputs=main_outputs,
        var_specs=var_specs,
        stack_vars=stack_vars,
        temp_vars=temp_vars,
        func_entries=func_entries,
        device=device,
    )
    # The block-local optimizations ((v) pop-push elimination, (ii) temp
    # detection) run as pipeline passes over the raw emission.
    from . import passes  # deferred: passes imports this module

    pipeline = passes.PassPipeline(
        passes.lowering_passes(), verify=verify, debug=verify
    )
    return pipeline.run(raw)


def _resolve(sym: _Sym, blockmap, func_entries) -> int:
    if isinstance(sym, int):
        return sym
    kind = sym[0]
    if kind == "blk":
        return blockmap[(sym[1], sym[2])]
    if kind == "entry":
        return func_entries[sym[1]]
    raise AssertionError(sym)


def _patch_targets(lowered, blockmap, func_entries) -> None:
    for i, blk in enumerate(lowered):
        t = blk.term
        if isinstance(t, ir.LJump):
            blk.term = ir.LJump(_resolve(t.target, blockmap, func_entries))
        elif isinstance(t, ir.LBranch):
            blk.term = ir.LBranch(
                var=t.var,
                true=_resolve(t.true, blockmap, func_entries),
                false=_resolve(t.false, blockmap, func_entries),
            )
        elif isinstance(t, ir.LPushJump):
            blk.term = ir.LPushJump(
                target=_resolve(t.target, blockmap, func_entries),
                ret=_resolve(t.ret, blockmap, func_entries),
            )


def popush_eliminate(lowered: list[ir.LBlock]) -> None:
    """Paper optimization (v): cancel ``pop v ... push v <- src`` pairs.

    Sound when nothing between the pop and the push mentions ``v`` (read or
    write) and ``src != v``.  The pair is replaced by a masked in-place
    update of the top (an identity LPrim at the push's position).
    """
    for blk in lowered:
        changed = True
        while changed:
            changed = False
            ops = blk.ops
            for i, op in enumerate(ops):
                if not isinstance(op, ir.LPop):
                    continue
                v = op.var
                for j in range(i + 1, len(ops)):
                    mentions = set(ir.prim_reads(ops[j])) | set(
                        ir.prim_writes(ops[j])
                    )
                    if isinstance(ops[j], ir.LPush) and ops[j].var == v:
                        if ops[j].src != v:
                            # Cancel: drop the pop, update in place.
                            new_ops = (
                                ops[:i]
                                + ops[i + 1 : j]
                                + [ir.identity_prim(v, ops[j].src, name="popush")]
                                + ops[j + 1 :]
                            )
                            blk.ops = new_ops
                            changed = True
                        break
                    if v in mentions:
                        break
                if changed:
                    break


def recompute_var_classes(
    blocks, main_params, main_outputs, state_layout=None
) -> tuple[frozenset[str], frozenset[str]]:
    """Re-derive ``(stack_vars, temp_vars)`` for a transformed block list.

    One shared implementation for every pass that rewrites blocks (jump-chain
    fusion, pop-push elimination, temp detection, the PGO passes): the pushed/
    popped set is re-scanned from the ops and temporaries re-detected, with
    packed-layout members (``state_layout``) always block-local.
    """
    stack_vars = frozenset(
        op.var
        for blk in blocks
        for op in blk.ops
        if isinstance(op, (ir.LPush, ir.LPop))
    )
    temp_vars = find_temporaries(
        blocks, stack_vars, main_params, main_outputs,
        state_layout=state_layout,
    )
    return stack_vars, temp_vars


def find_temporaries(
    lowered, stack_vars, main_params, main_outputs, *, state_layout=None
) -> frozenset[str]:
    """Paper optimization (ii): variables that never cross a VM iteration.

    Syntactic criterion: in every block that mentions the variable, each read
    (including a terminator read) is preceded by a write within that same
    block.  Such variables are ordinary intermediates of the fused block body
    and need no masked top buffer in VM state.

    Members of a packed ``state_layout`` group are exempt from the
    main-param/output exclusion: their cross-block value lives in the packed
    array (written back by the group's ``pack`` prim), so the members
    themselves are block-local by construction.
    """
    not_temp: set[str] = set(stack_vars) | set(main_params) | set(main_outputs)
    if state_layout is not None:
        not_temp -= state_layout.members()
    mentioned: set[str] = set()
    for blk in lowered:
        written: set[str] = set()
        for op in blk.ops:
            for r in ir.prim_reads(op):
                mentioned.add(r)
                if r not in written:
                    not_temp.add(r)
            for w in ir.prim_writes(op):
                mentioned.add(w)
                written.add(w)
        if isinstance(blk.term, ir.LBranch):
            mentioned.add(blk.term.var)
            if blk.term.var not in written:
                not_temp.add(blk.term.var)
    return frozenset(mentioned - not_temp)
