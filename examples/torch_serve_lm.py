"""Serve a small LM with batched requests through the PyTorch port's
autobatch VM (the counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py --lanes 8 [--check] [--device cpu]
    PYTHONPATH=src python examples/torch_serve_lm.py --lanes 4 --open-loop [--device cpu]

The generation loop (streaming prefill -> sample until EOS -> the lane's
next request) is a program in the paper's IR; the program-counter VM runs
all lanes in lockstep with masking, so requests of different prompt
lengths, generation lengths and queue depths batch together: continuous
batching as a compiler artifact rather than scheduler code.

With ``--open-loop`` the engine runs the resumable (segmented) VM instead:
requests are admitted from a host-side queue as lanes retire, and each
completion is printed the moment it finishes (retire-and-refill).

The model is SmolLM-135M's smoke config with random weights from a seed,
on the CUDA card unless ``--device`` names another (``--device cpu`` for
a CPU run; with neither a card nor ``--device`` it raises).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.serve.engine import EngineConfig, GenerationEngine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--requests-per-lane", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--check", action="store_true",
                    help="verify against the sequential oracle")
    ap.add_argument("--open-loop", action="store_true",
                    help="continuous batching: admit requests from a host-side queue "
                         "between VM segments")
    ap.add_argument("--num-requests", type=int, default=16,
                    help="open-loop: total requests in the stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    ecfg = EngineConfig(
        lanes=args.lanes,
        max_context=64,
        max_prompt_len=12,
        max_new_tokens=args.max_new,
        requests_per_lane=args.requests_per_lane,
        eos_id=0,
        backend="pc",
    )
    engine = GenerationEngine(model, params, ecfg)
    print(f"engine on {model.device}: {args.lanes} lanes x {args.requests_per_lane} requests, "
          f"program blocks: {len(engine.batched.lowered.blocks)}, "
          f"stacks: {len(engine.batched.lowered.stack_vars)} "
          f"(loop-only program -> none)")

    rng = np.random.default_rng(0)
    if args.open_loop:
        reqs = [
            Request(
                rid=i,
                prompt=rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(1, ecfg.max_prompt_len + 1))
                                    ).astype(np.int32),
                arrival=float(i) * 0.02,  # a 50 req/s trickle
            )
            for i in range(args.num_requests)
        ]
        # Warm-up: type inference of the segmented path, off the measured run.
        engine.serve([Request(rid=0, prompt=np.array([1], np.int32))])
        comps, stats = engine.serve(
            reqs,
            on_finish=lambda c: print(
                f"  request {c.rid} done on lane {c.lane}: "
                f"{len(c.tokens)} tokens, latency {c.latency * 1e3:.1f}ms"
            ),
        )
        lat = np.array([c.latency for c in comps])
        print(f"served {stats.completions} requests / "
              f"{stats.generated_tokens} tokens in {stats.wall_time:.2f}s "
              f"over {stats.segments} segments; occupancy "
              f"{stats.occupancy:.2f}, p50 latency {np.percentile(lat, 50) * 1e3:.1f}ms, "
              f"p99 {np.percentile(lat, 99) * 1e3:.1f}ms")
        return

    prompts = rng.integers(
        1, cfg.vocab_size, (args.lanes, args.requests_per_lane, ecfg.max_prompt_len)
    ).astype(np.int32)
    plens = rng.integers(
        2, ecfg.max_prompt_len + 1, (args.lanes, args.requests_per_lane)
    ).astype(np.int32)

    res = engine.generate(prompts, plens)  # warm-up: type inference, kernel builds
    t0 = time.perf_counter()
    res = engine.generate(prompts, plens)  # returns numpy: the run has ended on the card
    dt = time.perf_counter() - t0
    total = int(res["lengths"].sum())
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total / dt:,.0f} tok/s), decode-batch utilization "
          f"{res['utilization']:.3f}")
    print("first lane, first request tokens:",
          res["tokens"][0, 0, : res["lengths"][0, 0]])

    if args.check:
        ref = engine.reference_generate(prompts, plens)
        ok = np.array_equal(res["tokens"], ref["tokens"])
        print("matches sequential oracle:", ok)


if __name__ == "__main__":
    main()
