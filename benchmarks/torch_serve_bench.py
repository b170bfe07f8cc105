"""Serving-engine benchmark on the PyTorch port: the counterpart of
``benchmarks/serve_bench.py``, on one CUDA card (or on the CPU when asked
for).

Two modes:

* ``--arrivals closed`` (default): every lane's request queue is fixed
  before the run (``GenerationEngine.generate``); reports generated
  tokens/s, dispatches and decode utilization, and the sequential
  oracle's tokens/s beside it (``reference_generate``; skipped with
  ``--full``, where it would take minutes);
* ``--arrivals poisson``: open-loop serving (``GenerationEngine.serve``)
  — requests arrive by a Poisson process at ``--rate`` req/s and are
  admitted into free lanes between VM segments (retire-and-refill);
  reports tokens/s, p50/p99 arrival-to-finish latency, lane occupancy and
  segments, next to an all-at-once run of the same requests.

The model is SmolLM-135M: its smoke config (float32, a few layers) by
default, the full config (30 layers, bf16, random weights from a seed)
with ``--full``.  ``--seed`` fixes the weights, prompts and arrival
stream.  Records go to ``--json`` (default ``BENCH_serve_torch.json``;
never ``BENCH_serve.json``, the JAX package's record); ``--metrics-out``
dumps the engines' shared metrics registry in Prometheus text format.
Lane sharding (``--mesh``) and the fault-injection sweep (``--chaos``)
of the JAX benchmark are not ported.

Run from the repository root, e.g.::

    python -m benchmarks.torch_serve_bench --device cpu --lanes 2,4
    python -m benchmarks.torch_serve_bench --device cpu --arrivals poisson --lanes 4
    python -m benchmarks.torch_serve_bench --full --arrivals poisson --lanes 64 \\
        --num-requests 128 --max-new 64 --prompt-len 64 --rate 40
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.engine import EngineConfig, GenerationEngine, Request

from .common import Table, write_json

ARCH = "smollm-135m"


def load_model(full: bool, device, seed: int = 0):
    """SmolLM-135M (smoke or full config) with random weights from ``seed``."""
    cfg = configs.get_config(ARCH) if full else configs.get_smoke_config(ARCH)
    model = get_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    return cfg, model, params


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine(model, params, lanes: int, *, max_new: int, prompt_len: int,
            requests_per_lane: int, segment_steps: int = 64, metrics=None,
            max_context=None):
    ecfg = EngineConfig(
        lanes=lanes, max_context=max_context or prompt_len + max_new + 2,
        max_prompt_len=prompt_len, max_new_tokens=max_new,
        requests_per_lane=requests_per_lane, eos_id=0, segment_steps=segment_steps,
    )
    return GenerationEngine(model, params, ecfg, metrics=metrics)


def closed_sweep(model_triple, lane_counts: list[int], *, device, max_new: int,
                 prompt_len: int, requests_per_lane: int = 2, oracle: bool = True,
                 seed: int = 0) -> tuple[Table, list[dict]]:
    cfg, model, params = model_triple
    tab = Table("Serve engine (port), closed loop — generated tokens/s",
                ["lanes", "tok_s", "seq_tok_s", "dispatches", "ms_per_dispatch",
                 "utilization"])
    rng = np.random.default_rng(seed)
    records = []
    for lanes in lane_counts:
        eng = _engine(model, params, lanes, max_new=max_new, prompt_len=prompt_len,
                      requests_per_lane=requests_per_lane)
        prompts = rng.integers(1, cfg.vocab_size,
                               (lanes, requests_per_lane, prompt_len)).astype(np.int32)
        plens = rng.integers(2, prompt_len + 1, (lanes, requests_per_lane)).astype(np.int32)
        eng.generate(prompts, plens)  # warm-up (type inference, kernel builds)
        _sync(device)
        t0 = time.perf_counter()
        res = eng.generate(prompts, plens)
        _sync(device)
        wall = time.perf_counter() - t0
        n_tok = int(res["lengths"].sum())
        steps = eng.batched.last_result.steps
        seq = float("nan")
        if oracle:
            t0 = time.perf_counter()
            eng.reference_generate(prompts, plens)
            _sync(device)
            seq = n_tok / (time.perf_counter() - t0)
        tab.add(lanes, n_tok / wall, seq, steps, wall / steps * 1e3, res["utilization"])
        records.append({"mode": "closed", "lanes": lanes, "tok_s": n_tok / wall,
                        "seq_tok_s": seq if oracle else None, "wall_s": wall,
                        "tokens": n_tok, "dispatches": steps,
                        "utilization": res["utilization"]})
    return tab, records


def poisson_requests(num: int, rate: float, prompt_len: int, vocab: int,
                     seed: int = 0, min_len: int = 1) -> list[Request]:
    """An open-loop arrival stream: exponential gaps at ``rate`` req/s."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=num))
    return [Request(rid=i, prompt=rng.integers(
                1, vocab, int(rng.integers(min_len, prompt_len + 1))).astype(np.int32),
            arrival=float(t))
            for i, t in enumerate(arrivals)]


def open_loop_sweep(model_triple, lane_counts: list[int], *, device, rate: float,
                    num_requests: int, segment_steps: int, max_new: int,
                    prompt_len: int, seed: int = 0, metrics=None,
                    max_context=None) -> tuple[Table, list[dict]]:
    """Poisson arrivals against all-at-once arrivals, retire-and-refill in both."""
    cfg, model, params = model_triple
    tab = Table(f"Serve engine (port), open loop — Poisson arrivals at {rate} req/s vs "
                "all at once",
                ["lanes", "mode", "tok_s", "p50_s", "p99_s", "occupancy", "segments",
                 "dispatches"])
    records = []
    for lanes in lane_counts:
        eng = _engine(model, params, lanes, max_new=max_new, prompt_len=prompt_len,
                      requests_per_lane=1, segment_steps=segment_steps, metrics=metrics,
                      max_context=max_context)
        reqs = poisson_requests(num_requests, rate, prompt_len, cfg.vocab_size, seed=seed)
        eng.serve([Request(rid=0, prompt=np.array([1], np.int32))])  # warm-up
        for mode in ("poisson", "batch"):
            batch = reqs if mode == "poisson" else [Request(r.rid, r.prompt, 0.0) for r in reqs]
            _sync(device)
            comps, stats = eng.serve(batch)
            _sync(device)
            tok_s = stats.generated_tokens / stats.wall_time
            tab.add(lanes, mode, tok_s, stats.p50_latency, stats.p99_latency,
                    round(stats.occupancy, 3), stats.segments, stats.vm_steps)
            records.append({
                "mode": mode, "lanes": lanes, "rate": rate if mode == "poisson" else None,
                "seed": seed, "num_requests": num_requests, "segment_steps": segment_steps,
                "tok_s": tok_s, "wall_s": stats.wall_time,
                "generated_tokens": stats.generated_tokens,
                "p50_latency_s": stats.p50_latency, "p99_latency_s": stats.p99_latency,
                "occupancy": stats.occupancy, "segments": stats.segments,
                "vm_steps": stats.vm_steps,
                "statuses": {s: getattr(stats, s) for s in ("ok", "faulted", "timeout",
                                                             "rejected")},
            })
    return tab, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lanes", default="2,8")
    ap.add_argument("--arrivals", default="closed", choices=("closed", "poisson"))
    ap.add_argument("--full", action="store_true",
                    help="the full SmolLM-135M config (bf16) instead of its smoke config")
    ap.add_argument("--rate", type=float, default=8.0, help="poisson arrival rate, req/s")
    ap.add_argument("--num-requests", type=int, default=32)
    ap.add_argument("--segment-steps", type=int, default=64,
                    help="VM loop iterations per segment between host checks")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-context", type=int, default=None,
                    help="KV cache window (default: prompt + new tokens + 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    ap.add_argument("--mesh", default="none", help="not ported (refused unless 'none')")
    ap.add_argument("--chaos", action="store_true", help="not ported (refused)")
    ap.add_argument("--json", default="BENCH_serve_torch.json", metavar="PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    if args.mesh.lower() not in ("none", "0", "1"):
        raise SystemExit("--mesh is not ported yet: ROADMAP.md queue 1, item 14")
    if args.chaos:
        raise SystemExit("--chaos is not ported yet (see tools/torch_chaos.py for the VM "
                         "harness)")
    if args.json == "BENCH_serve.json":
        raise SystemExit("BENCH_serve.json is the JAX package's record; pick another path")
    device = resolve_device(args.device)
    lanes = [int(x) for x in args.lanes.split(",")]
    model_triple = load_model(args.full, device, args.seed)
    metrics = MetricsRegistry() if args.metrics_out else None
    if args.arrivals == "poisson":
        tab, records = open_loop_sweep(
            model_triple, lanes, device=device, rate=args.rate,
            num_requests=args.num_requests, segment_steps=args.segment_steps,
            max_new=args.max_new, prompt_len=args.prompt_len, seed=args.seed,
            metrics=metrics, max_context=args.max_context)
    else:
        tab, records = closed_sweep(model_triple, lanes, device=device, max_new=args.max_new,
                                    prompt_len=args.prompt_len, oracle=not args.full,
                                    seed=args.seed)
    print(tab.render())
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write((metrics or MetricsRegistry()).render_prometheus())
        print(f"[wrote {args.metrics_out}]")
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    write_json(args.json, {
        "benchmark": "serve_bench_torch",
        "device": {"type": device.type, "name": device_name},
        "config": {"arrivals": args.arrivals, "lanes": lanes, "full": args.full,
                   "rate": args.rate, "seed": args.seed, "num_requests": args.num_requests,
                   "segment_steps": args.segment_steps, "max_new": args.max_new,
                   "prompt_len": args.prompt_len, "max_context": args.max_context},
        "records": records,
    })
    print(f"[wrote {args.json}: {len(records)} records]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
