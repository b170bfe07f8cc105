"""Composable pass pipeline over the lowered IR.

Every lowered-IR transform is a :class:`Pass` — a named, pure
``LoweredProgram -> LoweredProgram`` rewrite — run in order by
:class:`PassPipeline`, which can run the verifier (verifier.py) between
every pass so a broken transform is caught *at the pass that produced it*
rather than as a silent wrong answer at runtime.

Passes:

* :class:`JumpChainFusion`    — superblock fusion (fusion.py steps 1–3).
* :class:`PopPushElimination` — paper opt. (v), as a pure pass.
* :class:`TempDetection`      — paper opt. (ii), recomputed after rewrites.
* :class:`DeadCodeElimination` — removes untagged primitives whose outputs
  are dead under :class:`analysis.LoweredLiveness` and drops variables that
  no longer appear anywhere from ``var_specs``, shrinking the masked-update
  footprint the VM pays on every dispatch (VM state is exactly
  ``var_specs - temp_vars``).
* :class:`ProfileGuidedFusion`, :class:`StateLayoutPacking`,
  :class:`BlockReordering` — the profile-guided pipeline
  (:func:`pgo_passes`): trace-driven superblock formation across the
  pinned call boundaries structural fusion must skip, hot-state layout
  packing that cuts masked per-dispatch updates, and frequency-ordered
  block renumbering.  All three consume a measured
  :class:`repro_torch.obs.BlockProfile` (via the seeded
  ``block_weights`` provenance).

:func:`diagnose` bundles the verifier + analyses into a
:class:`Diagnostics` report — the backing for ``fn.diagnostics()`` and the
``tools/torch_irlint.py`` CLI.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence, runtime_checkable

import torch

from . import analysis, fusion, ir, lowering, verifier


@runtime_checkable
class Pass(Protocol):
    """A named, pure rewrite of a lowered program."""

    name: str

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        ...  # pragma: no cover - protocol


class PassError(RuntimeError):
    """A pass crashed or produced a program the verifier rejects."""


@dataclass
class PassPipeline:
    """Run a sequence of passes, optionally verifying between every pass.

    With ``verify=True`` the input program and the output of every pass is
    checked by :func:`verifier.verify`; a failure raises :class:`PassError`
    naming the offending pass.  ``debug=True`` additionally appends the
    rejected program's ``pretty()`` dump to the error so the broken block
    can be read directly.  The verifications share one cache of typed
    primitives, so a primitive no pass changed is typed once.
    """

    passes: Sequence[Pass]
    verify: bool = False
    debug: bool = False
    _typed: dict = field(default_factory=dict, init=False, repr=False)

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        self._verify(lowered, where="input program (before any pass ran)")
        for p in self.passes:
            try:
                lowered = p.run(lowered)
            except Exception as e:
                raise PassError(f"pass {p.name!r} failed: {e}") from e
            self._verify(lowered, where=f"pass {p.name!r}")
        return lowered

    def _verify(self, lowered: ir.LoweredProgram, where: str) -> None:
        if not self.verify:
            return
        try:
            verifier.verify(lowered, typed=self._typed)
        except verifier.VerificationError as e:
            msg = f"{where} produced an invalid program: {e}"
            if self.debug:
                msg += "\n--- offending program ---\n" + lowered.pretty()
            raise PassError(msg) from e


# --------------------------------------------------------------------------
# The transforms, as passes
# --------------------------------------------------------------------------


def _recompute_var_classes(
    blocks: list[ir.LBlock], low: ir.LoweredProgram
) -> tuple[frozenset[str], frozenset[str]]:
    # One shared implementation (lowering.recompute_var_classes) for every
    # block-rewriting pass, including fusion.fuse_chains.
    return lowering.recompute_var_classes(
        blocks, low.main_params, low.main_outputs,
        state_layout=low.state_layout,
    )


def _copy_blocks(blocks: Sequence[ir.LBlock]) -> list[ir.LBlock]:
    return [
        ir.LBlock(ops=list(b.ops), term=b.term, label=b.label) for b in blocks
    ]


@dataclass
class JumpChainFusion:
    """Superblock fusion: concatenate unconditional jump chains, drop
    unreachable blocks, record ``fused_from`` provenance (fusion.py)."""

    name: str = "jump-chain-fusion"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        return fusion.fuse_chains(lowered)


@dataclass
class PopPushElimination:
    """Paper opt. (v): cancel block-local ``pop v … push v <- src`` pairs
    into masked in-place updates, then recompute the variable classes."""

    name: str = "popush-elimination"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        blocks = _copy_blocks(lowered.blocks)
        lowering.popush_eliminate(blocks)
        stack_vars, temp_vars = _recompute_var_classes(blocks, lowered)
        return ir.dataclass_replace(
            lowered, blocks=blocks, stack_vars=stack_vars, temp_vars=temp_vars
        )


@dataclass
class TempDetection:
    """Paper opt. (ii): recompute which variables are block-local
    temporaries (and so never enter VM state) after earlier rewrites."""

    name: str = "temp-detection"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        stack_vars, temp_vars = _recompute_var_classes(
            lowered.blocks, lowered
        )
        return ir.dataclass_replace(
            lowered, stack_vars=stack_vars, temp_vars=temp_vars
        )


@dataclass
class DeadCodeElimination:
    """Remove primitives whose outputs are dead and shrink VM state.

    Uses :class:`analysis.LoweredLiveness` (conservative about the dynamic
    ``LReturn`` edges and about values buried by ``LPush``) to delete
    untagged ``LPrim`` ops none of whose outputs are live, to a fixed
    point.  Stack ops are never removed (they move stack pointers), and
    tagged primitives are kept for the ``tag_stats`` instrumentation
    contract even when dead.  Afterwards, variables that no longer appear
    anywhere are dropped from ``var_specs`` — VM state is
    ``var_specs - temp_vars``, so each dropped variable removes one masked
    top buffer from every dispatch step.
    """

    name: str = "dead-code-elimination"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        blocks = _copy_blocks(lowered.blocks)
        cur = ir.dataclass_replace(lowered, blocks=blocks)
        changed = True
        while changed:
            changed = False
            lv = analysis.LoweredLiveness(cur)
            for i, blk in enumerate(blocks):
                live = set(lv.live_out[i])
                if isinstance(blk.term, ir.LBranch):
                    live.add(blk.term.var)
                kept: list[ir.LOp] = []
                for op in reversed(blk.ops):
                    if (
                        isinstance(op, ir.LPrim)
                        and op.tag is None
                        and not (set(op.outs) & live)
                    ):
                        changed = True
                        continue
                    kept.append(op)
                    live -= set(ir.prim_writes(op))
                    live |= set(analysis.LoweredLiveness.op_reads(op))
                kept.reverse()
                blk.ops = kept
        mentioned = self._mentioned_vars(cur)
        keep = (
            mentioned
            | set(cur.main_params)
            | set(cur.main_outputs)
        )
        var_specs = {v: s for v, s in cur.var_specs.items() if v in keep}
        stack_vars, temp_vars = _recompute_var_classes(blocks, cur)
        return ir.dataclass_replace(
            cur,
            var_specs=var_specs,
            stack_vars=stack_vars,
            temp_vars=temp_vars,
        )

    @staticmethod
    def _mentioned_vars(lowered: ir.LoweredProgram) -> set[str]:
        vs: set[str] = set()
        for blk in lowered.blocks:
            for op in blk.ops:
                vs.update(ir.prim_reads(op))
                vs.update(ir.prim_writes(op))
            if isinstance(blk.term, ir.LBranch):
                vs.add(blk.term.var)
        return vs


# --------------------------------------------------------------------------
# Profile-guided optimization passes
# --------------------------------------------------------------------------


def _frame_blocks(blocks: Sequence[ir.LBlock], entry: int) -> list[int]:
    """Blocks of the frame rooted at ``entry``: the intraprocedural CFG
    closure following jumps, branches and call *fallthroughs* (an
    ``LPushJump`` continues at its return site; the callee is another
    frame).  Returned in discovery order, entry first."""
    frame: list[int] = []
    seen: set[int] = set()
    stack = [entry]
    while stack:
        b = stack.pop()
        if b in seen:
            continue
        seen.add(b)
        frame.append(b)
        t = blocks[b].term
        if isinstance(t, ir.LJump):
            stack.append(t.target)
        elif isinstance(t, ir.LBranch):
            stack.extend((t.true, t.false))
        elif isinstance(t, ir.LPushJump):
            stack.append(t.ret)
    return frame


@dataclass
class ProfileGuidedFusion:
    """Trace-driven superblock formation.

    Consumes a ``BlockProfile`` measured on *this exact program* (the
    profile's ``num_blocks`` must match) and rewrites the hot call
    boundaries that structural :class:`JumpChainFusion` must skip because
    their blocks are pinned (function entries and return sites are
    multi-predecessor joins entered dynamically):

    * a function with **exactly one call site** is merged into its caller's
      frame: the ``LPushJump`` becomes a plain ``LJump``, every ``LReturn``
      of the frame becomes an ``LJump`` to the (now unique) return site,
      and the function entry is dropped from ``func_entries`` — un-pinning
      both blocks so the follow-up :class:`JumpChainFusion` absorbs them
      into superblocks;
    * a **hot call site** of a multi-site function gets the callee frame
      *tail-duplicated* (frame-copy inlining): the copy's returns jump
      straight to this site's return address, the copy's internal calls
      still target the original entries (recursion-safe), and the original
      frame keeps serving the remaining sites.  Gated by
      ``max_inline_blocks`` so a large frame is never duplicated.

    Also seeds ``LoweredProgram.block_weights`` with the profile's
    per-block dispatch counts — the hotness signal :class:`StateLayoutPacking`
    and :class:`BlockReordering` consume, propagated by every later
    renumbering pass.

    Bit-exactness: per-lane primitive sequences are unchanged — only pc
    bookkeeping (one less pc push per merged/inlined call) and block
    boundaries move, exactly like structural fusion.
    """

    profile: object  # obs.BlockProfile (duck-typed)
    min_count: int = 1
    max_inline_blocks: int = 8
    name: str = "profile-guided-fusion"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        prof = self.profile
        n = len(lowered.blocks)
        if prof.num_blocks != n:
            raise ValueError(
                f"profile was measured on a {prof.num_blocks}-block program "
                f"but this program has {n} blocks — re-profile with the same "
                "schedule/fuse/dce settings the optimized run will use"
            )
        blocks = _copy_blocks(lowered.blocks)
        weights = [int(prof.dispatches[b]) for b in range(n)]
        func_entries = dict(lowered.func_entries)
        fused_from = (
            dict(lowered.fused_from)
            if lowered.fused_from is not None else None
        )
        entry_of = {e: f for f, e in func_entries.items()}
        main = entry_of[lowered.entry]

        def call_sites(entry: int) -> list[int]:
            return [
                i for i, blk in enumerate(blocks)
                if isinstance(blk.term, ir.LPushJump)
                and blk.term.target == entry
            ]

        # ---- 1. Merge single-call-site functions into their caller. ----
        for fname, entry in sorted(lowered.func_entries.items()):
            if fname == main:
                continue
            sites = call_sites(entry)
            if len(sites) != 1:
                continue
            site = sites[0]
            frame = _frame_blocks(blocks, entry)
            if site in frame:  # a self-recursive only-caller: leave it
                continue
            if weights[site] < self.min_count:
                continue
            ret = blocks[site].term.ret
            for b in frame:
                if isinstance(blocks[b].term, ir.LReturn):
                    blocks[b].term = ir.LJump(ret)
            blocks[site].term = ir.LJump(entry)
            del func_entries[fname]

        # ---- 2. Tail-duplicate small callee frames at hot call sites. ----
        for fname, entry in sorted(lowered.func_entries.items()):
            if fname == main or fname not in func_entries:
                continue
            frame = _frame_blocks(blocks, entry)
            if len(frame) > self.max_inline_blocks:
                continue
            sites = call_sites(entry)
            if len(sites) < 2:
                continue
            for site in sites:
                if weights[site] < self.min_count or site in frame:
                    continue
                ret = blocks[site].term.ret
                mapping = {b: len(blocks) + k for k, b in enumerate(frame)}
                for b in frame:
                    src = blocks[b]
                    t = src.term
                    if isinstance(t, ir.LJump):
                        t = ir.LJump(mapping[t.target])
                    elif isinstance(t, ir.LBranch):
                        t = ir.LBranch(var=t.var, true=mapping[t.true],
                                       false=mapping[t.false])
                    elif isinstance(t, ir.LPushJump):
                        # The callee entry stays original (recursion-safe);
                        # only the intraframe return site is remapped.
                        t = ir.LPushJump(target=t.target, ret=mapping[t.ret])
                    else:  # LReturn: the caller no longer pushes a ret pc
                        t = ir.LJump(ret)
                    blocks.append(ir.LBlock(
                        ops=list(src.ops), term=t,
                        label=f"{src.label}@inline{site}",
                    ))
                    # The copy runs as often as its call site did; real
                    # counts would need a re-profile, this is the estimate.
                    weights.append(min(weights[b], weights[site]))
                    if fused_from is not None:
                        fused_from[len(blocks) - 1] = fused_from[b]
                blocks[site].term = ir.LJump(mapping[entry])

        # Drop functions no remaining call site targets: their entries are
        # un-pinned so the now-private frames can be absorbed (or dropped).
        for fname, entry in list(func_entries.items()):
            if fname != main and not call_sites(entry):
                del func_entries[fname]

        stack_vars, temp_vars = lowering.recompute_var_classes(
            blocks, lowered.main_params, lowered.main_outputs,
            state_layout=lowered.state_layout,
        )
        rewritten = ir.dataclass_replace(
            lowered,
            blocks=blocks,
            func_entries=func_entries,
            fused_from=fused_from,
            stack_vars=stack_vars,
            temp_vars=temp_vars,
            block_weights=tuple(weights),
        )
        # Re-fuse immediately: the rewrites above un-pin entries and return
        # sites (and can leave whole inlined-out frames unreachable), so the
        # chain fusion that concatenates the new superblocks — and compacts
        # the dead frames away — is part of this pass's contract.  It also
        # propagates ``block_weights`` (a merged chain runs as often as its
        # head) and composes ``fused_from``.
        return fusion.fuse_chains(rewritten)


@dataclass
class StateLayoutPacking:
    """Pack hot same-spec VM state members into grouped contiguous arrays.

    Every masked ``_masked(...)`` whole-state update the VM performs per
    dispatch costs one ``torch.where`` over a ``[batch, ...]`` buffer.  This
    pass groups state variables with identical ``(shape, dtype)`` into one
    packed ``(k,) + shape`` array per group (slot order = profile write
    weight, hottest first): inside each block that mentions members, an
    ``unpack`` prim materializes them as block-local temps and — iff any
    member was written — a single ``pack`` prim writes the group back, so a
    block that used to pay ``m`` masked updates pays one per touched group.
    The mapping is recorded as ``LoweredProgram.state_layout`` and every VM
    boundary (init/inject/park/outputs/stepper) reads
    ``tops[packed][:, slot]`` through it.  Only state variables are
    candidates, so no stack group ever addresses a member.
    """

    min_group: int = 2
    name: str = "state-layout-packing"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        if lowered.state_layout is not None:
            raise ValueError("state layout is already packed")

        # Candidates: plain state vars (stack vars need their own stacks;
        # temps never enter VM state in the first place).
        weights = lowered.block_weights
        mentions: dict[str, int] = {}
        writes_w: dict[str, int] = {}
        for i, blk in enumerate(lowered.blocks):
            w = int(weights[i]) if weights is not None else 1
            for op in blk.ops:
                for r in ir.prim_reads(op):
                    mentions[r] = mentions.get(r, 0) + 1
                for v in ir.prim_writes(op):
                    mentions[v] = mentions.get(v, 0) + 1
                    writes_w[v] = writes_w.get(v, 0) + w
            if isinstance(blk.term, ir.LBranch):
                mentions[blk.term.var] = mentions.get(blk.term.var, 0) + 1
        by_spec: dict[tuple, list[str]] = {}
        for v in sorted(lowered.var_specs):
            if lowered.var_class(v) != "state" or v not in mentions:
                continue
            spec = lowered.var_specs[v]
            # Groups are numbered in (shape, dtype name) order, the
            # names NumPy gives the dtypes, as the JAX package numbers them.
            dtype = str(spec.dtype).removeprefix("torch.")
            by_spec.setdefault((spec.shape, dtype), []).append(v)

        groups: dict[str, tuple[str, ...]] = {}
        var_specs = dict(lowered.var_specs)
        for (shape, _dtype), members in sorted(by_spec.items()):
            if len(members) < self.min_group:
                continue
            members = sorted(
                members, key=lambda v: (-writes_w.get(v, 0), v)
            )
            packed = f"%pgo/pack{len(groups)}"
            spec = lowered.var_specs[members[0]]
            groups[packed] = tuple(members)
            var_specs[packed] = ir.Spec(
                (len(members),) + spec.shape, spec.dtype
            )
        if not groups:
            return lowered
        layout = ir.StateLayout(groups=groups)
        member_group = {
            m: packed for packed, ms in groups.items() for m in ms
        }

        def unpack_prim(packed: str, members: tuple[str, ...]) -> ir.LPrim:
            return ir.LPrim(
                outs=members,
                fn=functools.partial(_unpack, len(members)),
                ins=(packed,),
                name="unpack",
                batched=True,
            )

        def pack_prim(packed: str, members: tuple[str, ...]) -> ir.LPrim:
            return ir.LPrim(
                outs=(packed,), fn=_pack, ins=members, name="pack",
                batched=True,
            )

        blocks = _copy_blocks(lowered.blocks)
        for blk in blocks:
            touched: set[str] = set()
            written: set[str] = set()
            for op in blk.ops:
                for r in ir.prim_reads(op):
                    if r in member_group:
                        touched.add(member_group[r])
                for v in ir.prim_writes(op):
                    if v in member_group:
                        touched.add(member_group[v])
                        written.add(member_group[v])
            if (
                isinstance(blk.term, ir.LBranch)
                and blk.term.var in member_group
            ):
                touched.add(member_group[blk.term.var])
            if not touched:
                continue
            pre = [unpack_prim(p, groups[p]) for p in sorted(touched)]
            post = [pack_prim(p, groups[p]) for p in sorted(written)]
            blk.ops = pre + blk.ops + post

        stack_vars, temp_vars = lowering.recompute_var_classes(
            blocks, lowered.main_params, lowered.main_outputs,
            state_layout=layout,
        )
        return ir.dataclass_replace(
            lowered,
            blocks=blocks,
            var_specs=var_specs,
            stack_vars=stack_vars,
            temp_vars=temp_vars,
            state_layout=layout,
        )


@dataclass
class BlockReordering:
    """Renumber blocks by profile dispatch frequency, hottest first.

    The ``earliest``/``lookahead`` scoring and the ``sweep`` schedule all
    iterate or argmin over block indices, so placing the hot blocks at the
    low indices makes every scheduler touch them first.  Pure renumbering:
    terminators, entries and provenance are remapped, per-lane execution
    is unchanged, and the permutation is recorded as
    ``LoweredProgram.block_order`` (``block_order[new] = old``).
    """

    name: str = "block-reordering"

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        weights = lowered.block_weights
        if weights is None:
            return lowered  # unprofiled: nothing to order by
        n = len(lowered.blocks)
        perm = sorted(range(n), key=lambda b: (-weights[b], b))
        if perm == list(range(n)):
            return lowered
        new_of = {old: new for new, old in enumerate(perm)}

        def remap(t: ir.LTerminator) -> ir.LTerminator:
            if isinstance(t, ir.LJump):
                return ir.LJump(new_of[t.target])
            if isinstance(t, ir.LBranch):
                return ir.LBranch(var=t.var, true=new_of[t.true],
                                  false=new_of[t.false])
            if isinstance(t, ir.LPushJump):
                return ir.LPushJump(target=new_of[t.target],
                                    ret=new_of[t.ret])
            return t

        blocks = [
            ir.LBlock(
                ops=list(lowered.blocks[old].ops),
                term=remap(lowered.blocks[old].term),
                label=lowered.blocks[old].label,
            )
            for old in perm
        ]
        fused_from = None
        if lowered.fused_from is not None:
            fused_from = {
                new: lowered.fused_from[old] for new, old in enumerate(perm)
            }
        if lowered.block_order is not None:  # compose with a prior reorder
            order = tuple(lowered.block_order[old] for old in perm)
        else:
            order = tuple(perm)
        return ir.dataclass_replace(
            lowered,
            blocks=blocks,
            entry=new_of[lowered.entry],
            func_entries={
                f: new_of[e] for f, e in lowered.func_entries.items()
            },
            fused_from=fused_from,
            block_weights=tuple(weights[old] for old in perm),
            block_order=order,
        )


def _unpack(k: int, packed: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The members of a ``[batch, k, ...]`` packed array, slot by slot."""
    return tuple(packed[:, i] for i in range(k))


def _pack(*members: torch.Tensor) -> torch.Tensor:
    """``[batch, ...]`` members -> one ``[batch, k, ...]`` packed array."""
    return torch.stack(members, dim=1)


def pgo_passes(
    profile, *, min_count: int = 1, max_inline_blocks: int = 8
) -> tuple[Pass, ...]:
    """The profile-guided pipeline appended after the structural passes:
    hot-path superblock formation (which re-fuses the un-pinned
    boundaries), block-local cleanups over the new superblocks,
    state-layout packing, and the final frequency renumbering."""
    return (
        ProfileGuidedFusion(
            profile, min_count=min_count,
            max_inline_blocks=max_inline_blocks,
        ),
        PopPushElimination(),
        TempDetection(),
        StateLayoutPacking(),
        BlockReordering(),
    )


def lowering_passes() -> tuple[Pass, ...]:
    """The post-emission cleanup `lowering.lower` runs: popush-eliminate
    then find-temporaries, as pipeline passes."""
    return (PopPushElimination(), TempDetection())


def fusion_passes() -> tuple[Pass, ...]:
    """`fusion.fuse` as a pipeline: chain fusion, then the block-local
    optimizations re-run on the merged superblocks."""
    return (JumpChainFusion(), PopPushElimination(), TempDetection())


# --------------------------------------------------------------------------
# Diagnostics (fn.diagnostics() / tools/torch_irlint.py)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Diagnostics:
    """Verifier + analysis summary of one lowered program."""

    num_blocks: int
    num_ops: int
    fused: bool
    num_source_blocks: Optional[int]  # pre-fusion block count, if fused
    num_state_vars: int  # masked top buffers the VM updates per dispatch
    num_stack_vars: int
    num_temp_vars: int
    dead_state_vars: tuple[str, ...]  # state DCE would remove
    dead_ops: int  # ops DCE would remove
    pc_depth: Optional[int]
    var_depths: dict[str, int] = field(default_factory=dict)
    required_max_depth: Optional[int] = None
    recursive_cycle: Optional[tuple[str, ...]] = None
    verified: bool = False
    verification_error: Optional[str] = None

    def pretty(self) -> str:
        lines = [
            f"blocks:        {self.num_blocks}"
            + (
                f" (fused from {self.num_source_blocks})"
                if self.fused
                else " (unfused)"
            ),
            f"ops:           {self.num_ops}",
            f"state vars:    {self.num_state_vars} "
            f"(stack: {self.num_stack_vars}, temps excluded: "
            f"{self.num_temp_vars})",
        ]
        if self.dead_ops or self.dead_state_vars:
            lines.append(
                f"dead:          {self.dead_ops} ops, "
                f"{len(self.dead_state_vars)} state vars "
                f"{sorted(self.dead_state_vars)}"
            )
        else:
            lines.append("dead:          none")
        if self.recursive_cycle is not None:
            lines.append(
                "stack bound:   unbounded (recursive cycle "
                + " -> ".join(self.recursive_cycle + self.recursive_cycle[:1])
                + ")"
            )
        else:
            lines.append(
                f"stack bound:   max_depth={self.required_max_depth} "
                f"(pc depth {self.pc_depth}, deepest variable stack "
                f"{max(self.var_depths.values(), default=0)})"
            )
        lines.append(
            "verifier:      ok"
            if self.verified
            else f"verifier:      FAILED: {self.verification_error}"
        )
        return "\n".join(lines)


def diagnose(lowered: ir.LoweredProgram) -> Diagnostics:
    """Run the verifier and every lowered-IR analysis over ``lowered``."""
    verified, err = True, None
    try:
        verifier.verify(lowered)
    except verifier.VerificationError as e:
        verified, err = False, str(e)
    if verified:
        depth = analysis.stack_depth_bound(lowered)
    else:  # analyses assume a well-formed program
        depth = analysis.StackDepthReport(None, {}, None, None)
    state_vars = [
        v for v in sorted(lowered.var_specs) if v not in lowered.temp_vars
    ]
    dead_state: tuple[str, ...] = ()
    dead_ops = 0
    if verified:
        after = DeadCodeElimination().run(lowered)
        after_state = {
            v for v in after.var_specs if v not in after.temp_vars
        }
        dead_state = tuple(sorted(set(state_vars) - after_state))
        dead_ops = sum(len(b.ops) for b in lowered.blocks) - sum(
            len(b.ops) for b in after.blocks
        )
    num_src = (
        len({s for srcs in lowered.fused_from.values() for s in srcs})
        if lowered.fused_from is not None
        else None
    )
    return Diagnostics(
        num_blocks=len(lowered.blocks),
        num_ops=sum(len(b.ops) for b in lowered.blocks),
        fused=lowered.fused_from is not None,
        num_source_blocks=num_src,
        num_state_vars=len(state_vars),
        num_stack_vars=len(lowered.stack_vars),
        num_temp_vars=len(lowered.temp_vars),
        dead_state_vars=dead_state,
        dead_ops=dead_ops,
        pc_depth=depth.pc_depth,
        var_depths=depth.var_depths,
        required_max_depth=depth.required_max_depth,
        recursive_cycle=depth.recursive_cycle,
        verified=verified,
        verification_error=err,
    )
