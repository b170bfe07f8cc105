"""Benchmark driver of the PyTorch port: ``python -m benchmarks.torch_run``.

The counterpart of ``benchmarks/run.py``: runs the port's benchmarks on
one CUDA card (quick configurations; ``--full`` for paper scale; ``--device
cpu`` for a CPU run) and strictly validates every record it wrote.

  fig5   NUTS gradient throughput against batch size (paper Fig. 5;
         ``benchmarks/torch_fig5.py``, the pc arm fused and unfused)
  fig6   batch utilization across recursion (paper Fig. 6;
         ``benchmarks/torch_fig6.py``)
  serve  the VM-scheduled generation engine (``benchmarks/torch_serve_bench.py``)
  roofline  per-(arch x shape) terms on both production meshes (32x8 and
         2x32x8) from the dry-run's records (``benchmarks/torch_roofline.py``;
         ``--dryrun-dir``, default ``build/dryrun``, where
         ``tools/torch_run_matrix.py`` writes them); it renders what is there

Records go to ``BENCH_fig5_torch.json``, ``BENCH_fig6_torch.json`` and
``BENCH_serve_torch.json`` at the repository root unless ``--json-out``,
``--fig6-json-out`` and ``--serve-json-out`` name other paths; the JAX
package's records, ``BENCH_fig5.json`` and ``BENCH_serve.json``, are
refused.  ``--mesh`` goes to fig5 (its pc arms, a batch a rank) and to
serve (the largest rank count), as in the JAX driver; each starts its own
ranks.  Refused as well: ``--use-kernel off`` (the port runs the K1/K2
stack kernels on the card always).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import torch_fig5, torch_fig6, torch_roofline, torch_serve_bench
from .common import validate_bench_json

#: Default records land at the repository root whatever the working
#: directory, as the JAX driver's do.
REPO_ROOT = Path(__file__).resolve().parent.parent
#: The JAX package's records, which this driver never writes.
JAX_RECORDS = ("BENCH_fig5.json", "BENCH_serve.json")
BENCHES = ("fig5", "fig6", "serve", "roofline")


def _refuse(args) -> None:
    only = set(args.only.split(",")) if args.only else set(BENCHES)
    unknown = only - set(BENCHES)
    if unknown:
        raise SystemExit(f"unknown benchmarks {sorted(unknown)}; have {list(BENCHES)}")
    if args.use_kernel and "off" in {u.strip().lower() for u in args.use_kernel.split(",")}:
        raise SystemExit("--use-kernel off is refused: the port runs the K1/K2 stack kernels "
                         "on the card always (a plain version on the card's main path would "
                         "be a fallback)")
    for path in (args.json_out, args.fig6_json_out, args.serve_json_out):
        if Path(path).name in JAX_RECORDS:
            raise SystemExit(f"{Path(path).name} is the JAX package's record; pick another path")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, help="comma list: fig5,fig6,serve,roofline")
    ap.add_argument("--batches", default=None,
                    help="comma-separated batch sizes for fig5/fig6")
    ap.add_argument("--mesh", default=None,
                    help="comma list of rank counts for the fig5 pc arms ('none' = "
                         "unsharded); serve takes the largest")
    ap.add_argument("--schedule", default=None,
                    help="comma list of pc schedules for fig5 (earliest, popular, sweep, "
                         "lookahead); default earliest")
    ap.add_argument("--compact-every", default=None,
                    help="comma list of lane-compaction cadences for the fig5 pc arms "
                         "(e.g. 'none,1')")
    ap.add_argument("--use-kernel", default=None,
                    help="'on' only: the port's stack kernels always run on the card")
    ap.add_argument("--pgo", default=None,
                    help="comma list of on/off: profile-guided lowering of the fig5 pc arms")
    ap.add_argument("--serve-arrivals", default="closed", choices=("closed", "poisson"),
                    help="serve bench mode: closed-loop sweep or open-loop Poisson arrivals")
    ap.add_argument("--serve-requests", type=int, default=16,
                    help="open-loop serve: requests in the arrival stream")
    ap.add_argument("--json-out", default=str(REPO_ROOT / "BENCH_fig5_torch.json"),
                    help="path of the fig5 record")
    ap.add_argument("--fig6-json-out", default=str(REPO_ROOT / "BENCH_fig6_torch.json"),
                    help="path of the fig6 record")
    ap.add_argument("--serve-json-out", default=str(REPO_ROOT / "BENCH_serve_torch.json"),
                    help="path of the serve record")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    ap.add_argument("--dryrun-dir", default=torch_roofline.ARTIFACT_DIR,
                    help="directory of the dry-run records the roofline reads")
    args = ap.parse_args(argv)
    _refuse(args)
    only = set(args.only.split(",")) if args.only else set(BENCHES)

    common = (["--full"] if args.full else []) + (
        ["--batches", args.batches] if args.batches else [])
    device = ["--device", args.device] if args.device else []
    emitted: list[str] = []  # records THIS run wrote (validated below)
    t0 = time.time()
    if "fig5" in only:
        print()
        # The fused pc arm beside the unfused one, in one run.
        fig5_args = common + device + ["--fuse", "on,off"]
        if args.schedule:
            fig5_args += ["--schedule", args.schedule]
        if args.compact_every:
            fig5_args += ["--compact-every", args.compact_every]
        if args.pgo:
            fig5_args += ["--pgo", args.pgo]
        if args.mesh:
            fig5_args += ["--mesh", args.mesh]
        torch_fig5.main(fig5_args + ["--json", args.json_out])
        emitted.append(args.json_out)
    if "fig6" in only:
        print()
        torch_fig6.main(common + device + ["--json", args.fig6_json_out])
        emitted.append(args.fig6_json_out)
    if "serve" in only:
        print()
        serve_args = device + ["--arrivals", args.serve_arrivals]
        if args.serve_arrivals == "poisson":
            serve_args += ["--num-requests", str(args.serve_requests)]
        counts = [m for m in (args.mesh or "").split(",")
                  if m.strip().lower() not in ("", "none", "0")]
        if counts:
            serve_args += ["--mesh", max(counts, key=int)]
        torch_serve_bench.main(serve_args + ["--json", args.serve_json_out])
        emitted.append(args.serve_json_out)
    if "roofline" in only:
        for mesh in torch_roofline.MESHES:
            print()
            torch_roofline.main(["--dir", args.dryrun_dir, "--mesh", mesh])
    # Every record this run wrote must parse as strict JSON (no bare NaN or
    # Infinity); a stale record from another run is not read.
    if emitted:
        validate_bench_json(emitted)
        print(f"[validated strict JSON: {', '.join(emitted)}]")
    print(f"\n[benchmarks done in {time.time() - t0:.1f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
