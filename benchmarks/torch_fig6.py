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
``--compact-every``; ``--mesh`` is refused (not ported).  There is no
``--pgo``, as the JAX benchmark has none.

Run from the repository root, e.g.::

    python -m benchmarks.torch_fig6 --device cpu --batches 2,4
    python -m benchmarks.torch_fig6 --full --batches 64

Records go to ``--json`` (default ``BENCH_fig6_torch.json``).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.device import resolve_device
from repro_torch.mcmc import nuts, targets

from .common import Table, write_json
from .torch_fig5 import (DEFAULT_PC_VARIANTS, add_common_args, device_record,
                         parse_pc_variants, pc_arm_name, refuse_unported)


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
    and JSON-able records (one per batch size)."""
    device = resolve_device(device)
    target = targets.correlated_gaussian(dim=dim, rho=rho, device=device)
    settings = nuts.NutsSettings(max_tree_depth=max_tree_depth, num_steps=num_steps,
                                 steps_per_leaf=steps_per_leaf)
    solo = len(pc_variants) == 1
    pc_cols = [pc_arm_name(s, f, c, solo=solo) for s, f, c in pc_variants]
    tab = Table(
        f"Fig 6 (PyTorch port, {device_record(device)['name']}) — batch utilization of "
        f"gradient evals (correlated Gaussian d={dim} rho={rho}, {num_steps} trajectories)",
        ["batch", *pc_cols, "local_static", f"{pc_cols[0]}/local"],
    )
    pcs = [nuts.make_nuts_kernel(target, settings, schedule=s, fuse=f, compact_every=c,
                                 device=device) for s, f, c in pc_variants]
    loc = nuts.make_nuts_kernel(target, settings, backend="local", device=device)
    records = []
    for z in batch_sizes:
        args = nuts.initial_state(target, z, eps=eps, seed=0, device=device)
        u_pcs = []
        for pc in pcs:
            pc(*args)
            u_pcs.append(grad_utilization(pc))
        loc(*args)
        u_loc = grad_utilization(loc)
        ratio = u_pcs[0] / u_loc if u_loc else float("nan")
        tab.add(z, *u_pcs, u_loc, ratio)
        records.append({"batch": z, "pc": dict(zip(pc_cols, u_pcs)), "local": u_loc,
                        "ratio": ratio})
    return tab, records


def grad_utilization(kernel) -> float:
    """The kernel's gradient utilization; raises when it kept no counters
    (this figure is that measurement)."""
    u = kernel.utilization.get("grad")
    if u is None:
        raise RuntimeError("fig6 needs block statistics: build the NUTS kernel with "
                           "collect_stats=True (the default)")
    return u


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true", help="paper-scale (d=100, batches up to 64)")
    ap.add_argument("--json", default="BENCH_fig6_torch.json", metavar="PATH")
    add_common_args(ap)
    args = ap.parse_args(argv)
    refuse_unported(args)
    if args.full:
        batches = [1, 2, 4, 8, 16, 32, 64]
        kw: dict = dict(dim=100, num_steps=10, max_tree_depth=10)
    else:
        batches = [1, 4, 16, 32]
        kw = dict(dim=16, num_steps=6, max_tree_depth=7)
    if args.batches:
        batches = [int(b) for b in args.batches.split(",")]
    pc_variants = parse_pc_variants(args.schedule, args.fuse, args.compact_every)
    device = resolve_device(args.device)
    tab, records = utilization_sweep(batches, pc_variants=pc_variants, device=device, **kw)
    print(tab.render())
    write_json(args.json, {
        "benchmark": "fig6_utilization_torch",
        "unit": "grad utilization (active / (executions x batch))",
        "device": device_record(device),
        "config": {"full": bool(args.full), "batches": batches,
                   "pc_variants": [list(v) for v in pc_variants], **kw},
        "records": records,
    })
    print(f"[wrote {args.json}: {len(records)} records]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
