#!/usr/bin/env python3
"""Perf-iteration driver of the port: dry-run a cell with a named variant
and diff its roofline terms against the stored baseline record (the
counterpart of ``tools/hillclimb.py``).

    PYTHONPATH=src python tools/torch_hillclimb.py --arch X --shape Y \\
        [--kv-int8] [--param-bf16] [--remat dots] [--microbatches 4] \\
        [--q-chunk 256] [--window 2048] [--capacity-factor F] \\
        [--compress-grads] [--multi-pod] [--mesh 64x4] [--tag name]

The baseline is ``tools/torch_run_matrix.py``'s record of the cell under
``--dir`` (default ``build/dryrun``).  Prints before/after for t_compute /
t_memory / t_collective / peak and appends the variant's record to
``hillclimb_log.jsonl`` there.  On the CPU, with no card.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from repro_torch.launch import dryrun

ART = str(Path(__file__).resolve().parent.parent / "build" / "dryrun")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--param-bf16", action="store_true",
                    help="serve with bf16 weights (deployment checkpoint)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--tag", default="variant")
    ap.add_argument("--mesh", default=None,
                    help="logical mesh DxM over the same cards, e.g. 64x4")
    ap.add_argument("--dir", default=ART)
    args = ap.parse_args(argv)

    overrides = {}
    if args.kv_int8:
        overrides["kv_cache_dtype"] = "int8"
    if args.param_bf16:
        overrides["param_dtype"] = "bfloat16"
    if args.q_chunk:
        overrides["attn_q_chunk"] = args.q_chunk
    if args.window:
        overrides["long_context_window"] = args.window
    if args.capacity_factor:
        overrides["capacity_factor"] = args.capacity_factor

    mesh_name = "2x32x8" if args.multi_pod else "32x8"
    base_path = os.path.join(args.dir, f"{args.arch}__{args.shape}__{mesh_name}.json")
    base = json.load(open(base_path)) if os.path.exists(base_path) else None

    mesh_shape = (tuple(int(x) for x in args.mesh.split("x"))
                  if args.mesh else None)
    res = dryrun.run_cell(
        args.arch, args.shape, multi_pod=args.multi_pod,
        remat=args.remat, compress_grads=args.compress_grads,
        cfg_overrides=overrides or None, microbatches=args.microbatches,
        mesh_shape=mesh_shape, verbose=False,
    )
    res["variant"] = {
        "tag": args.tag, "overrides": overrides, "remat": args.remat,
        "mesh": args.mesh,
        "microbatches": args.microbatches,
        "compress_grads": args.compress_grads,
    }

    def row(name, b, v):
        delta = (v - b) / b * 100 if b else float("nan")
        print(f"  {name:16s} {b:12.4g} -> {v:12.4g}  ({delta:+.1f}%)")

    print(f"{args.arch} x {args.shape} on {res['mesh']}  [{args.tag}]")
    if base and "error" not in base:
        for k in ("t_compute", "t_memory", "t_collective",
                  "collective_bytes", "peak_bytes", "hlo_bytes",
                  "roofline_fraction"):
            row(k, float(base.get(k, 0)), float(res.get(k, 0)))
        if "t_memory_flash" in res and "t_memory_flash" in base:
            row("t_memory_flash", base["t_memory_flash"],
                res["t_memory_flash"])
    else:
        print(json.dumps({k: res[k] for k in (
            "t_compute", "t_memory", "t_collective", "peak_bytes",
            "roofline_fraction")}, indent=2, default=float))
    os.makedirs(args.dir, exist_ok=True)
    with open(os.path.join(args.dir, "hillclimb_log.jsonl"), "a") as f:
        f.write(json.dumps(res, default=float) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
