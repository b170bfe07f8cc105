"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and per-layer metrics are found by
name from ``BENCHMARK.json`` (see ``harness.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number the comparison judged, with its limit.  The same
numbers close standard error.

The run fails (exit code not 0, no result) without a CUDA card, with fewer
cards than the cell asks for, without the program (``src/repro_torch``),
or when a JAX module or the JAX package is loaded once the window closes.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # One host thread: the port's host work is small tensor and NumPy
    # code, and a pool of spinning threads on a shared host only adds noise.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    # A library that would load JAX by itself is kept from doing so.
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # Build and kernel caches at fixed paths inside the checkout, so that
    # only a cell's first run there builds (the port's own nvcc libraries
    # go to build/torch_kernels/ by themselves).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor_cache")):
        os.environ[var] = str(ROOT / "build" / sub)


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device=None,
            make_kernel=None, t_start: float = T_START, overrides=None, outcome=None) -> dict:
    """Run the cell and return its result object (the line printed).

    ``overrides`` (``{"config": {...}, "traffic": {...}}``) replaces entries
    of the cell's files, for rehearsals at other sizes; ``outcome``, a list,
    receives the driver's :class:`Outcome`."""
    import torch

    from perfbench import harness

    cell = harness.resolve(harness.load_manifest(), cell_name)
    for part, new in (overrides or {}).items():
        setattr(cell, part, {**getattr(cell, part), **new})
    drv = harness.driver(cell.config["kind"])
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    out = drv.run(drv.Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace, device=dev,
                          t_start=t_start, make_kernel=make_kernel))
    if outcome is not None:
        outcome.append(out)
    cuda = dev.type == "cuda"
    device_rec = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed}
    if trace:
        run = {"cell": cell, "config": cell.config, "traffic": cell.traffic,
               "window_s": out.window_s, "calls": out.calls, "counters": out.counters,
               "trace": out.trace, "counts": harness.counts(cell.config["target"]),
               "peaks": harness.peaks(device_rec["kind"])}
        metrics = {}
        for m in cell.per_layer:
            v = harness.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        if out.trace is not None:
            device_rec["busy_s"] = out.trace.busy_s()
            device_rec["window_s"] = out.trace.window_s
        result["device"] = device_rec
        if out.trace is not None:
            result["breakdown"] = {"device_ops": out.trace.top_ops(),
                                   "idle_gaps": out.trace.idle_gaps()}
    else:
        e2e = {"setup_s": out.setup_s,
               "grads_per_s": out.counters.get("grads", 0) / out.window_s}
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_rec
    result["checks"] = out.checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the program is missing ({exc})", file=sys.stderr)
        return 3
    import torch

    from perfbench import harness

    torch.set_num_threads(1)
    cell = harness.resolve(harness.load_manifest(), args.workload)
    need = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {need} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_loaded()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
