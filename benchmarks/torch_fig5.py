"""Paper Figure 5 on the PyTorch port: NUTS gradient evaluations per second
against batch size, on one CUDA card (or on the CPU when asked for).

The counterpart of ``benchmarks/fig5_throughput.py`` with the same arms,
settings and definitions, run through ``repro_torch``:

* ``pc`` — program-counter autobatching (the port's VM, stack traffic
  through the K1/K2 CUDA kernels on the card);
* ``local`` — local static autobatching (Algorithm 1) with each block
  segment replayed from a CUDA graph (the paper's "hybrid" arm);
* ``local_eager`` — local static autobatching, op by op;
* ``unbatched`` — one chain at a time through the reference interpreter;
* ``iterative`` — the hand-batched iterative NUTS.

The ``pc`` arm expands into one column per ``--schedule`` x ``--fuse`` x
``--compact-every`` x ``--pgo`` combination; each pc record carries the
VM's steps, ``num_blocks``, ``masked_updates``, ``mean_occupancy``
(tile-based) and ``mean_lane_occupancy``.  A ``pgo`` variant is profiled
once at set-up, untimed: a traced run of its own configuration at
:data:`PGO_PROFILE_BATCH` chains, whose block profile re-lowers it through
the profile-guided passes (``kernel.optimize``), bit-exact and with fewer
dispatches.  ``--verify`` runs the lowered-IR verifier between every pass.
Lane sharding (``--mesh``) is not ported yet and is refused.

Throughput = member gradient evaluations per second (active leaf
executions x grads per leaf over the wall), best of ``repeats`` warm runs;
each timed run ends with ``torch.cuda.synchronize()`` on the card.  The
``unbatched`` arm counts its gradients with a pc kernel on the same
inputs.

Run from the repository root, e.g.::

    python -m benchmarks.torch_fig5 --device cpu --batches 1,2 --repeats 1
    python -m benchmarks.torch_fig5 --device cpu --batches 4,8 --arms pc --pgo on,off
    python -m benchmarks.torch_fig5 --full --schedule earliest,sweep

Records go to ``--json`` (default ``BENCH_fig5_torch.json``).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.mcmc import iterative, nuts, targets
from repro_torch.obs import block_profile

from .common import Table, write_json

#: (schedule, fuse, compact_every, pgo) combinations of the plain "pc" arm
#: (a 3-tuple means pgo off).
DEFAULT_PC_VARIANTS = (("earliest", True, None),)
ARMS = ("pc", "local", "local_eager", "unbatched", "iterative")
#: Where the knobs this benchmark refuses are tracked (ROADMAP.md, queue 1).
REFUSED = {"mesh": "item 14 (multi-device lane sharding)"}
#: Chains and trace-ring capacity of a pgo variant's set-up profiling run,
#: as the JAX benchmark profiles (the ring holds the whole run).
PGO_PROFILE_BATCH = 32
PGO_TRACE_CAPACITY = 262_144


def pc_arm_name(schedule: str, fuse: bool, compact_every=None, pgo: bool = False, *,
                solo: bool) -> str:
    if solo:
        return "pc"
    parts = [schedule, "fuse" if fuse else "nofuse"]
    if compact_every is not None:
        parts.append(f"ce{compact_every}")
    if pgo:
        parts.append("pgo")
    return f"pc[{','.join(parts)}]"


def timed(fn, device: torch.device) -> float:
    """Wall seconds of ``fn()``, with the card idle before and after."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def best_of(fn, repeats: int, device: torch.device) -> float:
    return min(timed(fn, device) for _ in range(repeats))


def device_record(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(device),
                "count": torch.cuda.device_count()}
    return {"type": device.type, "name": device.type, "count": 1}


def throughput_sweep(
    batch_sizes: list[int],
    *,
    num_data: int = 2_000,
    dim: int = 50,
    num_steps: int = 3,
    max_tree_depth: int = 6,
    steps_per_leaf: int = 4,
    eps: float = 0.02,
    repeats: int = 3,
    arms: tuple = ARMS,
    pc_variants: tuple = DEFAULT_PC_VARIANTS,
    unbatched_cap: int = 8,
    verify: bool = False,
    device=None,
) -> tuple[Table, list[dict]]:
    """Run the sweep on ``device`` (default: the card); returns the table
    and JSON-able records."""
    device = resolve_device(device)
    target = targets.logistic_regression(num_data=num_data, dim=dim, device=device)
    settings = nuts.NutsSettings(max_tree_depth=max_tree_depth, num_steps=num_steps,
                                 steps_per_leaf=steps_per_leaf)
    gpl = settings.grads_per_leaf
    solo = len(pc_variants) == 1
    columns: list[str] = []
    pc_meta: dict[str, tuple] = {}
    for arm in arms:
        if arm == "pc":
            for variant in pc_variants:
                sched, fz, ce, pg = tuple(variant) + (False,) * (4 - len(variant))
                name = pc_arm_name(sched, fz, ce, pg, solo=solo)
                columns.append(name)
                pc_meta[name] = (sched, fz, ce, pg)
        else:
            columns.append(arm)
    tab = Table(
        f"Fig 5 (PyTorch port, {device_record(device)['name']}) — NUTS grad evals/sec "
        f"(logreg n={num_data} d={dim}, {num_steps} steps/chain)",
        ["batch", *columns],
    )
    # One kernel per arm, shared across batch sizes (the lowering is made
    # once; each batch size gets its own executor).
    kernels = {}
    for name, (sched, fz, ce, pg) in pc_meta.items():
        kern = nuts.make_nuts_kernel(target, settings, max_steps=500_000, schedule=sched,
                                     fuse=fz, compact_every=ce, verify=verify, device=device)
        if pg:
            # Set-up time, untimed: profile a traced run of this very
            # configuration and re-lower through the profile-guided passes.
            traced = kern.with_options(trace=PGO_TRACE_CAPACITY)
            traced(*nuts.initial_state(target, PGO_PROFILE_BATCH, eps=eps, seed=0,
                                       device=device))
            kern = kern.optimize(block_profile(traced.last_trace))
        kernels[name] = kern
    for arm in ("local", "local_eager"):
        if arm in arms:
            kernels[arm] = nuts.make_nuts_kernel(target, settings, backend=arm,
                                                 max_steps=500_000, device=device)
    if "unbatched" in arms:
        kernels["unbatched"] = nuts.make_nuts_kernel(target, settings, backend="reference",
                                                     device=device)
        counter = next((kernels[n] for n in pc_meta), None) \
            or nuts.make_nuts_kernel(target, settings, max_steps=500_000, device=device)
    if "iterative" in arms:
        run_iterative = iterative.make_batched(target, settings, device=device)

    records: list[dict] = []

    def record(arm: str, z: int, grads: int, wall: float, **extra) -> float:
        rec = {"arm": arm, "batch": z, "grads_per_sec": grads / wall, "grads": grads,
               "wall_s": wall}
        if arm in pc_meta:
            sched, fz, ce, pg = pc_meta[arm]
            rec.update(schedule=sched, fuse=fz, compact_every=ce, pgo=pg)
        rec.update(extra)
        records.append(rec)
        return rec["grads_per_sec"]

    for z in batch_sizes:
        args = nuts.initial_state(target, z, eps=eps, seed=0, device=device)
        row = [z]
        for arm in columns:
            if arm == "iterative":
                out = run_iterative(*args)  # warm-up
                grads = int(out["grads"].sum())
                wall = best_of(lambda: run_iterative(*args), repeats, device)
                row.append(record(arm, z, grads, wall,
                                  iterations=run_iterative.chain.iterations))
                continue
            if arm == "unbatched":
                if z > unbatched_cap:
                    row.append(float("nan"))
                    continue
                counter(*args)
                _, active = counter.tag_stats["grad"]
                wall = best_of(lambda: kernels["unbatched"](*args), 1, device)
                row.append(record(arm, z, active * gpl, wall))
                continue
            kern = kernels[arm]
            kern(*args)  # warm-up (type inference, lowering, graph capture)
            _, active = kern.tag_stats["grad"]
            extra = {}
            if arm in pc_meta:
                st = kern.scheduler_stats
                extra = {"vm_steps": st.steps, "num_blocks": st.num_blocks,
                         "mean_occupancy": st.mean_occupancy,
                         "mean_lane_occupancy": st.mean_lane_occupancy,
                         "masked_updates": st.masked_updates}
            else:
                extra = {"block_execs": kern.local_stats.block_execs}
            wall = best_of(lambda: kern(*args), repeats, device)
            row.append(record(arm, z, active * gpl, wall, **extra))
        tab.add(*row)
    return tab, records


def parse_onoff(text: str, flag: str) -> list[bool]:
    onoff = {"on": True, "off": False, "true": True, "false": False}
    out = []
    for f in (f.strip().lower() for f in text.split(",")):
        if f and f not in onoff:
            raise SystemExit(f"{flag} values must be on/off, got {f!r}")
        if f:
            out.append(onoff[f])
    return out


def parse_pc_variants(schedules: str, fuses: str, compacts: str = "none") -> tuple:
    scheds = [s.strip() for s in schedules.split(",") if s.strip()]
    fzs = parse_onoff(fuses, "--fuse")
    ces = []
    for c in (c.strip().lower() for c in compacts.split(",")):
        if c in ("none", "0"):
            ces.append(None)
        elif c.isdigit():
            ces.append(int(c))
        elif c:
            raise SystemExit(f"--compact-every values must be ints or 'none', got {c!r}")
    if not scheds or not fzs or not ces:
        raise SystemExit("--schedule, --fuse and --compact-every must each name a value")
    return tuple((s, f, c) for c in ces for f in fzs for s in scheds)


def refuse_unported(args) -> None:
    """``--mesh`` names a knob the port does not have yet."""
    if any(m.strip().lower() not in ("", "none") for m in args.mesh.split(",")):
        raise SystemExit(f"--mesh is not ported yet: ROADMAP.md queue 1, {REFUSED['mesh']}")


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--batches", default=None, help="comma-separated batch sizes")
    ap.add_argument("--schedule", default="earliest",
                    help="comma list of pc schedules (earliest, popular, sweep, lookahead)")
    ap.add_argument("--fuse", default="on", help="comma list of on/off: superblock fusion")
    ap.add_argument("--compact-every", default="none",
                    help="comma list of lane-compaction cadences ('none' = off)")
    ap.add_argument("--mesh", default="none", help="not ported (refused unless 'none')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale problem (10k x 100 logreg)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--arms", default=",".join(ARMS), help="comma list of arms")
    ap.add_argument("--json", default="BENCH_fig5_torch.json", metavar="PATH")
    ap.add_argument("--pgo", default="off",
                    help="comma list of on/off: profile-guided lowering of the pc arm")
    ap.add_argument("--verify", action="store_true",
                    help="run the lowered-IR verifier between every pass")
    add_common_args(ap)
    args = ap.parse_args(argv)
    refuse_unported(args)
    if args.full:
        kw: dict = dict(num_data=10_000, dim=100, max_tree_depth=10, num_steps=10)
        batches = [1, 4, 16, 64, 256, 1024]
    else:
        kw = {}
        batches = [1, 4, 16, 64]
    if args.batches:
        batches = [int(b) for b in args.batches.split(",")]
    arms = tuple(a.strip() for a in args.arms.split(",") if a.strip())
    unknown = set(arms) - set(ARMS)
    if unknown:
        raise SystemExit(f"unknown arms {sorted(unknown)}; have {ARMS}")
    pgos = parse_onoff(args.pgo, "--pgo")
    if not pgos:
        raise SystemExit("--pgo must name a value (on, off or on,off)")
    pc_variants = tuple(v + (p,) for p in pgos
                        for v in parse_pc_variants(args.schedule, args.fuse, args.compact_every))
    device = resolve_device(args.device)
    tab, records = throughput_sweep(batches, repeats=args.repeats, arms=arms,
                                    pc_variants=pc_variants, verify=args.verify,
                                    device=device, **kw)
    print(tab.render())
    write_json(args.json, {
        "benchmark": "fig5_throughput_torch",
        "unit": "member grad evals / sec",
        "device": device_record(device),
        "config": {"full": bool(args.full), "batches": batches, "repeats": args.repeats,
                   "arms": list(arms), "pc_variants": [list(v) for v in pc_variants],
                   "verify": args.verify, **kw},
        "records": records,
    })
    print(f"[wrote {args.json}: {len(records)} records]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
