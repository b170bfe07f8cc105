"""Superblock fusion over the lowered, stack-explicit program.

The program-counter VM (paper Algorithm 2) dispatches exactly one lowered
block per ``lax.while_loop`` iteration, so every block boundary costs a full
dispatch round-trip: a global argmin/argmax over the batch's pc values, one
``lax.switch``, and a masked update of the whole VM state.  The lowering of
``Call`` (lowering.py) emits many *tiny* straight-line blocks — argcopy
glue, retval/pop return sites, loop-header hops — that make the hot loop
pay that round-trip for a handful of element-wise ops.

This pass shrinks the block graph to its control-relevant skeleton by
**jump-chain fusion**:

* a block whose terminator is an unconditional ``LJump`` absorbs its
  target's ops and adopts its terminator, iterated to a fixed point along
  the chain (stopping at conditional branches, call/return boundaries, and
  cycles);
* when the target had that single jump predecessor, this is a pure merge
  and the target block disappears;
* when the target is a join block with several jump predecessors (the
  common shape: both arms of an ``if`` jump to the join), its ops are
  *tail-duplicated* into each predecessor; the join block itself is removed
  once no conditional branch or call/return site still enters it.

Blocks whose index is load-bearing are pinned and never absorbed: the
program entry, function entries (``LPushJump`` targets), and return sites
(``LPushJump.ret``, entered dynamically by ``LReturn``).

Fusion is a pure CFG transformation of per-member straight-line code under
one mask, so batched execution is **bit-exact**: each member executes the
same primitive sequence in the same order as in the unfused program, only
with fewer VM dispatch steps.  Relation to the paper's optimizations
(i)–(v): fusion runs *after* the lowering already applied (i) caller-save
stacks, (iii) stack-only-when-needed and (iv) top-of-stack caching, and it
re-runs (v) pop-push elimination and (ii) temporary detection on the merged
superblocks — a pop/push pair or a def-before-use chain that used to span
a block boundary becomes block-local, so the pair cancels and the variable
drops out of VM state entirely.

Entry point: :func:`fuse`, which is
``passes.PassPipeline(passes.fusion_passes())`` — :func:`fuse_chains` here
is the chain-concatenation step (the ``JumpChainFusion`` pass), and the
block-local re-optimizations are the shared ``PopPushElimination`` /
``TempDetection`` passes.  Provenance is recorded on
``LoweredProgram.fused_from`` (new block index -> original indices), which
the VM surfaces in its per-run scheduler stats.
"""
from __future__ import annotations

from . import analysis, ir, lowering


def fuse(
    low: ir.LoweredProgram, *, verify: bool = False
) -> ir.LoweredProgram:
    """Return a semantically identical program with fused superblocks.

    The input is not mutated.  ``fused_from`` on the result maps each new
    block index to the tuple of input block indices whose ops it
    concatenates (composed through an already-fused input).  With
    ``verify=True`` the lowered-IR verifier runs between every pass of the
    fusion pipeline (see passes.py).
    """
    from . import passes  # deferred: passes imports this module

    pipeline = passes.PassPipeline(
        passes.fusion_passes(), verify=verify, debug=verify
    )
    return pipeline.run(low)


def fuse_chains(low: ir.LoweredProgram) -> ir.LoweredProgram:
    """Jump-chain fusion proper (the ``JumpChainFusion`` pass body):
    concatenate unconditional jump chains, drop unreachable blocks, compact
    indices and record provenance.  Variable classes are recomputed so the
    result is self-consistent, but the block-local optimizations (popush
    elimination, temp detection on the merged superblocks) are separate
    passes.
    """
    blocks = low.blocks
    n = len(blocks)
    pinned = analysis.pinned_blocks(low)

    # ---- 1. Follow every unconditional jump chain, concatenating ops. ----
    # Chains are followed over the *original* blocks so the result is
    # independent of processing order; cycles and pinned targets cut them.
    fused: list[ir.LBlock] = []
    sources: list[tuple[int, ...]] = []
    for i, blk in enumerate(blocks):
        ops = list(blk.ops)
        term = blk.term
        label = blk.label
        chain = [i]
        while (
            isinstance(term, ir.LJump)
            and term.target not in pinned
            and term.target not in chain
        ):
            nxt = blocks[term.target]
            chain.append(term.target)
            ops.extend(nxt.ops)
            label = f"{label}+{nxt.label}"
            term = nxt.term
        fused.append(ir.LBlock(ops=ops, term=term, label=label))
        sources.append(tuple(chain))

    # ---- 2. Drop blocks no longer reachable from any control root. ----
    # Roots are the program entry plus every function entry (a function
    # may be registered without being called; keep its body addressable).
    roots = {low.entry} | set(low.func_entries.values())
    reachable: set[int] = set()
    stack = list(roots)
    while stack:
        b = stack.pop()
        if b in reachable:
            continue
        reachable.add(b)
        stack.extend(analysis.lowered_targets(fused[b].term))

    # ---- 3. Compact indices and retarget terminators. ----
    index: dict[int, int] = {}
    new_blocks: list[ir.LBlock] = []
    fused_from: dict[int, tuple[int, ...]] = {}
    for i in range(n):
        if i not in reachable:
            continue
        index[i] = len(new_blocks)
        new_blocks.append(fused[i])
        srcs = sources[i]
        if low.fused_from is not None:  # compose through a prior fusion
            srcs = tuple(s for j in srcs for s in low.fused_from[j])
        fused_from[index[i]] = srcs
    for blk in new_blocks:
        t = blk.term
        if isinstance(t, ir.LJump):
            blk.term = ir.LJump(index[t.target])
        elif isinstance(t, ir.LBranch):
            blk.term = ir.LBranch(
                var=t.var, true=index[t.true], false=index[t.false]
            )
        elif isinstance(t, ir.LPushJump):
            blk.term = ir.LPushJump(
                target=index[t.target], ret=index[t.ret]
            )

    # Recompute the variable classes for the merged blocks (dropping an
    # unreachable block can shrink the pushed/popped set).  The block-local
    # re-optimizations — (v) popush pairs newly confined to one superblock,
    # (ii) temp detection on the merged bodies — run as their own passes.
    stack_vars, temp_vars = lowering.recompute_var_classes(
        new_blocks, low.main_params, low.main_outputs,
        state_layout=low.state_layout,
    )

    # Profile weights survive the renumbering: a merged chain is dispatched
    # exactly as often as its head block was.
    block_weights = None
    if low.block_weights is not None:
        block_weights = tuple(
            low.block_weights[i] for i in range(n) if i in index
        )

    return ir.LoweredProgram(
        blocks=new_blocks,
        entry=index[low.entry],
        main_params=low.main_params,
        main_outputs=low.main_outputs,
        var_specs=low.var_specs,
        stack_vars=stack_vars,
        temp_vars=temp_vars,
        func_entries={f: index[e] for f, e in low.func_entries.items()},
        fused_from=fused_from,
        block_weights=block_weights,
        state_layout=low.state_layout,
        device=low.device,
    )
