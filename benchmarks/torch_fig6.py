"""Paper Figure 6 on the PyTorch port: batch utilization of the gradient on
the correlated Gaussian, program-counter against local static
autobatching, on one CUDA card (or on the CPU when asked for).

The counterpart of ``benchmarks/fig6_utilization.py`` with the same
settings and definition: utilization(tag=grad) = active member-gradient
evaluations / (gradient launches x batch size), from the kernels'
``utilization["grad"]``.  Local static autobatching synchronizes chains on
trajectory boundaries (its host recursion pins every member to the same
call stack), the pc VM batches gradients across trajectory and recursion
depth.  The pc arm expands over ``--schedule`` x ``--fuse`` x
``--compact-every`` x ``--mesh``.  A ``mesh{n}`` arm shards the batch's
lanes over ``n`` ranks that the benchmark starts itself, as
``benchmarks/torch_fig5.py`` does; as in the JAX benchmark the batch is
the whole batch here, and one that ``n`` does not divide gives a nan
cell (a null record).  There is no ``--pgo``, as the JAX benchmark has
none.

Run from the repository root, e.g.::

    python -m benchmarks.torch_fig6 --device cpu --batches 2,4
    python -m benchmarks.torch_fig6 --full --batches 64
    python -m benchmarks.torch_fig6 --device cpu --batches 2,3 --mesh none,2

Records go to ``--json`` (default ``BENCH_fig6_torch.json``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.device import resolve_device
from repro_torch.mcmc import nuts, targets

from .common import Table, write_json
from .torch_fig5 import (DEFAULT_PC_VARIANTS, add_common_args, device_record, lead_rank,
                         mesh_ranks, on_ranks, parse_pc_variants, pc_arm_name, pc_variant)


def utilization_sweep(
    batch_sizes: list[int],
    *,
    dim: int = 100,
    rho: float = 0.95,
    num_steps: int = 10,
    max_tree_depth: int = 8,
    steps_per_leaf: int = 4,
    eps: float = 0.1,
    pc_variants: tuple = DEFAULT_PC_VARIANTS,
    device=None,
) -> tuple[Table, list[dict]]:
    """Run the sweep on ``device`` (default: the card); returns the table
    and JSON-able records (one per batch size).  A variant with a mesh runs
    over the ranks of the process group; the others on the first rank."""
    device = resolve_device(device)
    lead = lead_rank()
    target = targets.correlated_gaussian(dim=dim, rho=rho, device=device)
    settings = nuts.NutsSettings(max_tree_depth=max_tree_depth, num_steps=num_steps,
                                 steps_per_leaf=steps_per_leaf)
    solo = len(pc_variants) == 1
    variants = [pc_variant(v) for v in pc_variants]
    pc_cols = [pc_arm_name(*v, solo=solo) for v in variants]
    tab = Table(
        f"Fig 6 (PyTorch port, {device_record(device)['name']}) — batch utilization of "
        f"gradient evals (correlated Gaussian d={dim} rho={rho}, {num_steps} trajectories)",
        ["batch", *pc_cols, "local_static", f"{pc_cols[0]}/local"],
    )
    pcs = [nuts.make_nuts_kernel(target, settings, schedule=s, fuse=f, compact_every=c,
                                 mesh=m, device=device) for s, f, c, _, m in variants]
    loc = nuts.make_nuts_kernel(target, settings, backend="local", device=device)
    nan = float("nan")
    records = []
    for z in batch_sizes:
        args = nuts.initial_state(target, z, eps=eps, seed=0, device=device)
        u_pcs = []
        for pc, (*_, mesh) in zip(pcs, variants):
            if (mesh is None and not lead) or (mesh is not None and z % mesh):
                u_pcs.append(nan)  # another rank's arm, or lanes that do not divide
                continue
            pc(*args)
            u_pcs.append(grad_utilization(pc))
        u_loc = nan
        if lead:
            loc(*args)
            u_loc = grad_utilization(loc)
        ratio = u_pcs[0] / u_loc if u_loc else nan
        tab.add(z, *u_pcs, u_loc, ratio)
        # Strict JSON: a cell that did not run is null.
        records.append({"batch": z,
                        "pc": {c: None if u != u else u for c, u in zip(pc_cols, u_pcs)},
                        "local": u_loc, "ratio": None if ratio != ratio else ratio})
    return tab, records


def grad_utilization(kernel) -> float:
    """The kernel's gradient utilization; raises when it kept no counters
    (this figure is that measurement)."""
    u = kernel.utilization.get("grad")
    if u is None:
        raise RuntimeError("fig6 needs block statistics: build the NUTS kernel with "
                           "collect_stats=True (the default)")
    return u


def _sweep_on_rank(rank: int, device, batches: list[int], sweep: dict):
    return utilization_sweep(batches, device=device, **sweep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="paper-scale (d=100, batches up to 64)")
    ap.add_argument("--json", default="BENCH_fig6_torch.json", metavar="PATH")
    add_common_args(ap)
    args = ap.parse_args(argv)
    if args.full:
        batches = [1, 2, 4, 8, 16, 32, 64]
        kw: dict = dict(dim=100, num_steps=10, max_tree_depth=10)
    else:
        batches = [1, 4, 16, 32]
        kw = dict(dim=16, num_steps=6, max_tree_depth=7)
    if args.batches:
        batches = [int(b) for b in args.batches.split(",")]
    pc_variants = parse_pc_variants(args.schedule, args.fuse, args.compact_every, args.mesh)
    ranks = mesh_ranks(pc_variants)
    device = resolve_device(args.device)
    if ranks:
        tab, records = on_ranks(_sweep_on_rank, ranks, args.device,
                                batches, dict(pc_variants=pc_variants, **kw))
    else:
        tab, records = utilization_sweep(batches, pc_variants=pc_variants, device=device, **kw)
    print(tab.render())
    write_json(args.json, {
        "benchmark": "fig6_utilization_torch",
        "unit": "grad utilization (active / (executions x batch))",
        "device": device_record(device),
        "config": {"full": bool(args.full), "batches": batches,
                   "pc_variants": [list(v) for v in pc_variants], "ranks": ranks or 1, **kw},
        "records": records,
    })
    print(f"[wrote {args.json}: {len(records)} records]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
