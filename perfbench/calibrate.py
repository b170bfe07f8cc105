"""Measurements that define a cell, run once when the cell is set up, not by
the benchmark's own runs.

    python3 perfbench/calibrate.py sweep --workload W --chains 16384,65536 --seed N --seconds S
    python3 perfbench/calibrate.py control --workload W --seeds A,B,... --seconds S

``sweep`` runs the traced window at each chain count and prints the device's
busy share, the memory peak and the per-layer metrics.  ``control`` runs the
program on each seed and reads the comparison's numbers, then puts the
reference computed one precision below the configuration's (``control`` in
the configuration file: ``tf32`` or ``bfloat16``) in the program's place on
the same inputs and reads the same numbers against the float64 reference.
Each prints one JSON line a run and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

import torch  # noqa: E402

from perfbench import harness, run as bench  # noqa: E402
from perfbench.reference import compare  # noqa: E402

CONTROL_DTYPES = {"tf32": torch.float32, "bfloat16": torch.bfloat16, "float32": torch.float32}


def control_numbers(cell, out, device, chains: int) -> dict:
    """The comparison's numbers of the lower-precision reference on the
    inputs of the program's compared calls."""
    drv = harness.driver(cell.config["kind"])
    cfg = cell.config
    kind = cfg["control"]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
    try:
        gaps = []
        for call, ref in zip(out.extra["compared"], out.extra["refs"]):
            low = drv.reference_outputs(cfg, out.extra["seed"], chains, out.extra["idx"],
                                        call, device, CONTROL_DTYPES[kind])
            gaps.append(compare.chain_gaps(low, ref, cfg["num_steps"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return compare.numbers(torch.cat(gaps))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("sweep", "control"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--chains", default="")
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    rows = []
    cell = harness.resolve(harness.load_manifest(), args.workload)
    if args.mode == "sweep":
        plan = [(args.seed, int(c)) for c in args.chains.split(",")]
    else:
        plan = [(int(s), int(args.chains) if args.chains else None)
                for s in args.seeds.split(",")]
    for seed, chains in plan:
        over = {"traffic": {"chains": chains}} if chains else {}
        trace = bool(args.trace if args.trace is not None else args.mode == "sweep")
        got = []
        t = time.perf_counter()
        try:
            res = bench.execute(args.workload, seed, args.seconds, trace, overrides=over,
                                outcome=got, t_start=t)
        except torch.cuda.OutOfMemoryError as exc:
            rows.append({"workload": args.workload, "seed": seed, "chains": chains,
                         "error": str(exc)[:300]})
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
            continue
        out = got[0]
        row = {"workload": args.workload, "seed": seed, "chains": chains or cell.traffic["chains"],
               "wall_s": time.perf_counter() - t, "calls": out.calls,
               "window_s": out.window_s, "setup_s": out.setup_s,
               "grads_per_s": out.counters["grads"] / out.window_s,
               "per_call": out.extra["per_call"], "setup_parts": out.extra["setup_parts"],
               "result": res}
        if out.trace is not None:
            row["trace_ops"], row["trace_scopes"] = len(out.trace.ops), len(out.trace.scopes)
        dv = res["device"]
        if "busy_s" in dv:
            row["busy_share"] = dv["busy_s"] / dv["window_s"]
        if args.mode == "control":
            out.extra["seed"] = seed
            t = time.perf_counter()
            row["control"] = control_numbers(cell, out, dev, row["chains"])
            row["control_s"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out, got
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
