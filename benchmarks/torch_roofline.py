"""Roofline report of the PyTorch port: reads the dry-run records and
renders the per-(arch x shape) table of compute / memory / collective
terms, dominant bottleneck, useful-FLOPs ratio, roofline fraction and
peak memory on one production mesh (the counterpart of
``benchmarks/roofline.py``).

The records come from the port's dry-run, on the CPU with no card
(meta tensors and a fake process group; H100 datasheet constants)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch A --shape S \\
        [--multi-pod] --out build/dryrun/<arch>__<shape>__<mesh>.json
    PYTHONPATH=src python tools/torch_run_matrix.py [--multi-pod]

and land under ``build/dryrun/`` by default (never
``benchmarks/artifacts``, the JAX package's).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

from .common import Table

ARTIFACT_DIR = str(Path(__file__).resolve().parent.parent / "build" / "dryrun")
MESHES = ("32x8", "2x32x8")


def load_artifacts(directory: str = ARTIFACT_DIR) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        cells.extend(data if isinstance(data, list) else [data])
    return cells


def render(cells: list[dict], mesh: str = "32x8") -> str:
    tab = Table(
        f"Roofline terms per (arch x shape), mesh {mesh} "
        "(seconds per step, per H100; *_fl = with flash attention (K3) "
        "modeled)",
        ["arch", "shape", "t_comp", "t_mem", "t_coll", "bound",
         "useful", "roof", "t_mem_fl", "roof_fl", "peakGB", "fits", "mb"],
    )
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"])):
        if c.get("mesh") != mesh or "error" in c:
            continue
        tab.add(
            c["arch"], c["shape"],
            c["t_compute"], c["t_memory"], c["t_collective"],
            c["bottleneck"],
            round(c.get("useful_flops_ratio", 0.0), 3),
            round(c.get("roofline_fraction", 0.0), 4),
            round(c["t_memory_flash"], 3) if "t_memory_flash" in c else "-",
            round(c["roofline_fraction_flash"], 4)
            if "roofline_fraction_flash" in c else "-",
            round(c.get("peak_bytes", 0) / 1e9, 2),
            "yes" if c.get("fits") else "no",
            c.get("microbatches", 1),
        )
    failed = [c for c in cells if c.get("mesh") == mesh and "error" in c]
    out = tab.render()
    if failed:
        out += "\nFAILED cells: " + ", ".join(
            f"{c['arch']}x{c['shape']}" for c in failed
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=ARTIFACT_DIR)
    ap.add_argument("--mesh", default="32x8")
    args = ap.parse_args(argv)
    cells = load_artifacts(args.dir)
    if not cells:
        print(f"(no dry-run records in {args.dir} — run "
              "python -m repro_torch.launch.dryrun or tools/torch_run_matrix.py first)")
        return 0
    print(render(cells, args.mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main())
