#!/usr/bin/env python3
"""Host-side phases of ``chip_smoke.py`` from two source trees, in turns.

    python tools/torch_serve_ab.py A_ROOT B_ROOT [--rounds N] [--phases 9,12,xlstm]

``A_ROOT`` and ``B_ROOT`` are checkouts of the repo (for instance a parent
commit unpacked with ``git archive`` and the working tree).  Each run is a
fresh process that imports that tree's code and drives the phases named
(default ``9,12``):

- ``9``: the closed-loop engine on SmolLM-135M, bf16, 64 lanes x 2
  requests, as the smoke's phase 9 (that tree's ``chip_smoke.py``);
- ``12``: open-loop serving (the burst of 64, the burst with 32 Poisson
  arrivals behind it, a profiled burst of 8), as the smoke's phase 12;
- ``xlstm``: phase 16's prefill forward of xLSTM-350M at full width, bf16
  compute weights from seed 23, 2 x 1,024 tokens from seed 24: one
  warm-up forward, three timed ones (ms each, ended by a synchronise) and
  one counted by that tree's ``launch/op_cost.py`` (ops dispatched, HBM
  bytes).

Phases 9 and 12 print their tokens/s, ms a dispatch and busy share.  Runs
go A, B, B, A for each round, so that a drift of the host shows on both
sides.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

XLSTM_PREFILL = (2, 1024)  # batch x tokens, as chip_smoke.FAMILY_PREFILL


def xlstm_prefill(torch) -> dict:
    """xLSTM-350M's bf16 prefill forward: ms of three timed runs, and the
    ops and bytes the op counter reads on one more."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import op_cost
    from repro_torch.models import get_model

    cfg = configs.get_config("xlstm-350m")
    b, s = XLSTM_PREFILL
    model = get_model(cfg, device="cuda")
    params = model.cast_for_compute(model.init(torch.Generator(device="cuda").manual_seed(23)))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()}
    with torch.no_grad():
        model.forward(params, batch)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        _, cost = op_cost.count(lambda p, bt: model.forward(p, bt), params, batch)
    return {"shape": [b, s], "ms": ms, "ops": cost.op_count, "bytes": cost.bytes_accessed}


def one(root: str, phases: list[str]) -> None:
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_ab: needs a CUDA device")
    cs.phase_env(torch)
    if {"9", "12"} & set(phases):
        cs.phase_build()
    for name in phases:
        t = time.perf_counter()
        if name == "xlstm":
            rec = xlstm_prefill(torch)
            print(f"torch_serve_ab: {root} xlstm prefill {rec['shape'][0]} x {rec['shape'][1]} "
                  f"bf16 ms {', '.join(f'{x:.3f}' for x in rec['ms'])}; ops {rec['ops']}, "
                  f"bytes {rec['bytes']:.6e}", flush=True)
        else:
            {"9": cs.phase_engine, "12": cs.phase_serve}[name](torch)
        print(f"torch_serve_ab: {root} phase {name} {time.perf_counter() - t:.1f} s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--phases", default="9,12", help="comma-separated: 9, 12, xlstm")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= {"9", "12", "xlstm"}:
        ap.error(f"--phases takes 9, 12 and xlstm, got {args.phases}")
    if args.one:
        one(args.one, phases)
        return 0
    for _ in range(args.rounds):
        for root in (args.a, args.b, args.b, args.a):
            print(f"torch_serve_ab: run {root}", flush=True)
            subprocess.run([sys.executable, __file__, args.a, args.b, "--one", root,
                            "--phases", args.phases], check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
