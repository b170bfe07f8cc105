#!/usr/bin/env python3
"""Sweep the port's dry-run matrix, one JSON record per cell (the
counterpart of ``tools/run_matrix.py``).

    PYTHONPATH=src python tools/torch_run_matrix.py [--multi-pod] [--only ARCH] \\
        [--shape SHAPE] [--microbatches N] [--force] [--out-dir build/dryrun]

Every (arch x applicable shape) cell runs on the production mesh (32 x 8,
or 2 x 32 x 8 with ``--multi-pod``) in this one process, on the CPU with
no card (``repro_torch.launch.dryrun``: meta tensors, a fake process
group).  ``--shape`` keeps one input shape; ``--microbatches`` counts the
train cells at that many microbatches instead of the mesh's default (its
records' file names end in ``__mb<N>``).  Resilient: a cell that fails is
recorded with an ``"error"`` field and the sweep continues.  Records
already present are skipped unless ``--force``.  ``benchmarks/torch_roofline.py`` renders them.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from repro_torch.launch import dryrun

ART = str(Path(__file__).resolve().parent.parent / "build" / "dryrun")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--only", default=None, help="one arch")
    ap.add_argument("--shape", default=None, help="one input shape")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="train cells at this many microbatches (default: the mesh's)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=ART)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    mesh_name = "2x32x8" if args.multi_pod else "32x8"
    cells = dryrun.all_cells()
    if args.only:
        cells = [c for c in cells if c[0] == args.only]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    suffix = f"__mb{args.microbatches}" if args.microbatches else ""
    t_start = time.time()
    failed = 0
    for i, (arch, shape) in enumerate(cells):
        path = os.path.join(args.out_dir, f"{arch}__{shape}__{mesh_name}{suffix}.json")
        if os.path.exists(path) and not args.force:
            print(f"[{i+1}/{len(cells)}] skip {arch} x {shape} (exists)")
            continue
        print(f"[{i+1}/{len(cells)}] {arch} x {shape} on {mesh_name} ...", flush=True)
        t0 = time.time()
        try:
            res = dryrun.run_cell(arch, shape, multi_pod=args.multi_pod, verbose=False,
                                  microbatches=args.microbatches)
        except Exception as e:
            failed += 1
            res = {
                "arch": arch, "shape": shape, "mesh": mesh_name,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"    FAILED: {res['error'][:300]}", flush=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=2, default=float)
        if "error" not in res:
            print(f"    ok {time.time()-t0:.0f}s bound={res['bottleneck']} "
                  f"peak={res['peak_bytes']/1e9:.1f}GB fits={res['fits']} "
                  f"roof={res['roofline_fraction']:.4f}", flush=True)
    print(f"matrix done in {(time.time()-t_start)/60:.1f} min ({failed} failed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
