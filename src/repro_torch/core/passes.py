"""Composable pass pipeline over the lowered IR.

Every lowered-IR transform is a :class:`Pass` — a named, pure
``LoweredProgram -> LoweredProgram`` rewrite — run in order by
:class:`PassPipeline`:

* :class:`JumpChainFusion`    — superblock fusion (fusion.py steps 1–3).
* :class:`PopPushElimination` — paper opt. (v), as a pure pass.
* :class:`TempDetection`      — paper opt. (ii), recomputed after rewrites.
* :class:`DeadCodeElimination` — removes untagged primitives whose outputs
  are dead under :class:`analysis.LoweredLiveness` and drops variables that
  no longer appear anywhere from ``var_specs``, shrinking the masked-update
  footprint the VM pays on every dispatch (VM state is exactly
  ``var_specs - temp_vars``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from . import analysis, fusion, ir, lowering


@runtime_checkable
class Pass(Protocol):
    """A named, pure rewrite of a lowered program."""

    name: str

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        ...  # pragma: no cover - protocol


class PassError(RuntimeError):
    """A pass crashed."""


@dataclass
class PassPipeline:
    """Run a sequence of passes; a crash names the offending pass."""

    passes: Sequence[Pass]

    def run(self, lowered: ir.LoweredProgram) -> ir.LoweredProgram:
        for p in self.passes:
            try:
                lowered = p.run(lowered)
            except Exception as e:
                raise PassError(f"pass {p.name!r} failed: {e}") from e
        return lowered


# --------------------------------------------------------------------------
# The transforms, as passes
# --------------------------------------------------------------------------


def _recompute_var_classes(
    blocks: list[ir.LBlock], low: ir.LoweredProgram
) -> tuple[frozenset[str], frozenset[str]]:
    return lowering.recompute_var_classes(
        blocks, low.main_params, low.main_outputs
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
    anywhere are dropped from ``var_specs``.
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
        keep = (
            self._mentioned_vars(cur)
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


def lowering_passes() -> tuple[Pass, ...]:
    """The post-emission cleanup `lowering.lower` runs: popush-eliminate
    then find-temporaries, as pipeline passes."""
    return (PopPushElimination(), TempDetection())


def fusion_passes() -> tuple[Pass, ...]:
    """`fusion.fuse` as a pipeline: chain fusion, then the block-local
    optimizations re-run on the merged superblocks."""
    return (JumpChainFusion(), PopPushElimination(), TempDetection())
