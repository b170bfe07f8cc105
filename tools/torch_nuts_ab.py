#!/usr/bin/env python3
"""Full-width NUTS on one CUDA card from two source trees, in turns.

    python tools/torch_nuts_ab.py A_SRC B_SRC [--rounds N]

``A_SRC`` and ``B_SRC`` are ``src`` directories holding a ``repro_torch``
package (for instance a parent commit unpacked with ``git archive`` and the
working tree).  Each run is a fresh process that drives the workload of
``chip_smoke.py`` phase 6 — the 10,000 x 100 logistic regression, 1024
chains, ``NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)``,
``eps=0.01``, seed 0 — once to warm up, once measured and once under
``torch.profiler``.  Runs go A, B, B, A for each round, so that a drift of
the host shows on both sides.  Each run prints one JSON line: wall
seconds, dispatches, gradient evaluations per second, the profiled run's
device busy time, its kernel count and kernels per dispatch, and the
stack kernels' (K1/K2) device time and launches.  The last line is the
median of each side.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def one(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.mcmc import nuts, targets

    if not torch.cuda.is_available():
        raise SystemExit("torch_nuts_ab: needs a CUDA device")
    settings = nuts.NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)
    target = targets.logistic_regression(num_data=10_000, dim=100, device="cuda")
    kern = nuts.make_nuts_kernel(target, settings, device="cuda")
    args = nuts.initial_state(target, 1024, eps=0.01, seed=0, device="cuda")
    kern(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kern(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = kern.last_result
    grads = res.tag_stats["grad"][1] * settings.grads_per_leaf
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kern(*args)
        torch.cuda.synchronize()
    avgs = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    stack = [e for e in avgs if any(k in e.key for k in ("push_kernel", "pop_kernel",
                                                          "peek_kernel"))]
    n_kernels = sum(e.count for e in avgs)
    return {
        "src": src, "converged": bool(res.converged), "wall_s": wall, "dispatches": res.steps,
        "grads_per_s": grads / wall,
        "device_busy_ms": sum(e.self_device_time_total for e in avgs) / 1e3,
        "kernels": n_kernels, "kernels_per_dispatch": n_kernels / res.steps,
        "stack_kernel_ms": sum(e.self_device_time_total for e in stack) / 1e3,
        "stack_kernel_launches": sum(e.count for e in stack),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.one:
        print(json.dumps(one(opts.a)))
        return 0
    runs = {opts.a: [], opts.b: []}
    for _ in range(opts.rounds):
        for src in (opts.a, opts.b, opts.b, opts.a):
            out = subprocess.run([sys.executable, __file__, src, src, "--one"],
                                 capture_output=True, text=True, check=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[src].append(line)
    medians = {src: {k: statistics.median(r[k] for r in rs)
                     for k in rs[0] if isinstance(rs[0][k], (int, float))
                     and not isinstance(rs[0][k], bool)}
               for src, rs in runs.items()}
    print(json.dumps({"medians": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
