#!/usr/bin/env python3
"""``chip_smoke.py``'s serving phases from two source trees, in turns.

    python tools/torch_serve_ab.py A_ROOT B_ROOT [--rounds N]

``A_ROOT`` and ``B_ROOT`` are checkouts of the repo (for instance a parent
commit unpacked with ``git archive`` and the working tree).  Each run is a
fresh process that imports that tree's ``chip_smoke.py``, builds its
kernels and drives phase 9 (the closed-loop engine on SmolLM-135M, bf16,
64 lanes x 2 requests) and phase 12 (open-loop serving: the burst of 64,
the burst with 32 Poisson arrivals behind it, a profiled burst of 8), as
the smoke does; those phases print their tokens/s, ms a dispatch and busy
share.  Runs go A, B, B, A for each round, so that a drift of the host
shows on both sides.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def one(root: str) -> None:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: needs a CUDA device")
    cs.phase_env(torch)
    cs.phase_build()
    for name, phase in (("9", cs.phase_engine), ("12", cs.phase_serve)):
        t = time.perf_counter()
        phase(torch)
        print(f"torch_serve_ab: {root} phase {name} {time.perf_counter() - t:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        one(args.one)
        return 0
    for _ in range(args.rounds):
        for root in (args.a, args.b, args.b, args.a):
            print(f"torch_serve_ab: run {root}", flush=True)
            subprocess.run([sys.executable, __file__, args.a, args.b, "--one", root], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
