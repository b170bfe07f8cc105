#!/usr/bin/env python3
"""Time ``verify=True`` lowering in the PyTorch port with and without the
typing cache that ``PassPipeline`` shares across its passes.

    PYTHONPATH=src python tools/torch_verify_cost.py [--device cpu] [--rounds N]

Two programs, as ``chip_smoke.py`` phase 13 verifies them: phase 6's NUTS
(10,000 x 100 logistic regression, ``max_tree_depth=10``) and the
SmolLM-135M serving engine at 64 lanes.  Each lowering is made anew, in
turns: shared (the port as it is: a primitive no pass changed is typed
once), per pass (every verification types every primitive again, as the
JAX package's verifier does), per pass, shared.  Typing runs on fake
tensors, so the time is the host's.  One JSON line a lowering; the last
line holds the medians.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from unittest import mock


def _programs(device):
    """(name, zero-argument function returning a fresh verified lowering)."""
    import torch

    from repro_torch import configs
    from repro_torch.mcmc import nuts, targets
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine

    settings = nuts.NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)
    target = targets.logistic_regression(num_data=10_000, dim=100, device=device)
    kern = nuts.make_nuts_kernel(target, settings, device=device)
    cfg = configs.get_config("smollm-135m")
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(1))
    ecfg = EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(model, params, ecfg)
    return [("nuts", lambda: kern.with_options(verify=True).lowered),
            ("engine", lambda: eng.batched.with_options(verify=True).lowered)]


def _per_pass(verify):
    """``verifier.verify`` with the pipeline's cache dropped."""
    def run(lowered, **kw):
        kw.pop("typed", None)
        return verify(lowered, **kw)
    return run


def main(argv=None) -> int:
    from repro_torch.core import passes
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the fake tensors (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=1)
    opts = ap.parse_args(argv)
    device = resolve_device(opts.device)
    times: dict = {}
    for name, lower in _programs(device):
        lower()  # warm-up: the fake-tensor mode's first use
        for _ in range(opts.rounds):
            for how in ("shared", "per_pass", "per_pass", "shared"):
                with mock.patch.object(passes.verifier, "verify",
                                       _per_pass(passes.verifier.verify)
                                       if how == "per_pass" else passes.verifier.verify):
                    t0 = time.perf_counter()
                    low = lower()
                    s = time.perf_counter() - t0
                times.setdefault(name, {}).setdefault(how, []).append(s)
                print(json.dumps({"program": name, "typing": how, "blocks": len(low.blocks),
                                  "seconds": s}), flush=True)
    print(json.dumps({"device": str(device), "medians": {
        name: {how: statistics.median(v) for how, v in d.items()} for name, d in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
