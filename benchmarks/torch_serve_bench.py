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

``--chaos`` layers fault injection on the Poisson stream, as the JAX
benchmark does: a ``--chaos-rate`` fraction of the requests carry
NaN-poisoning or livelock sentinel prompts (``tools/torch_chaos.py``
``ChaosModel``), and the engine runs under ``on_fault="quarantine"``,
``detect_nonfinite`` and a ``lane_step_budget`` watchdog calibrated on a
fault-free 1-lane serve, with one retry a faulted request.  Each cell
reports the statuses and the error, retry, shed and timeout rates beside
tokens/s and p50/p99, checks that every request ends in a terminal status
and that no injected request ends ``ok``, and holds the healthy requests'
tokens bit-exact to a chaos-free serve of them; the exit status is 1 when
any cell has a violation.

``--mesh n`` shards every engine's lanes over ``n`` ranks that the
benchmark starts itself (``repro_torch.distributed.spawn``, a gloo
group); as in the JAX benchmark ``--lanes`` are the whole batch, and a lane count that ``n``
does not divide gives a nan row (a null record).  The first rank writes
the record.

Run from the repository root, e.g.::

    python -m benchmarks.torch_serve_bench --device cpu --lanes 2,4
    python -m benchmarks.torch_serve_bench --device cpu --arrivals poisson --lanes 4
    python -m benchmarks.torch_serve_bench --device cpu --chaos --lanes 2,4 --rate 32
    python -m benchmarks.torch_serve_bench --device cpu --lanes 2,3 --mesh 2
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
from repro_torch.serve.engine import (COMPLETION_STATUSES, EngineConfig, GenerationEngine,
                                      Request)

from .common import Table, write_json
from .torch_fig5 import device_record, lead_rank, on_ranks

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
            max_context=None, mesh=None, **fault_knobs):
    ecfg = EngineConfig(
        lanes=lanes, max_context=max_context or prompt_len + max_new + 2,
        max_prompt_len=prompt_len, max_new_tokens=max_new,
        requests_per_lane=requests_per_lane, eos_id=0, segment_steps=segment_steps,
        mesh=mesh, **fault_knobs,
    )
    return GenerationEngine(model, params, ecfg, metrics=metrics)


def _indivisible(tab: Table, records: list, mode: str, lanes: int, mesh) -> bool:
    """A lane count the mesh does not divide: a nan row and a null record."""
    if not mesh or lanes % mesh == 0:
        return False
    tab.add(lanes, *[float("nan")] * (len(tab.columns) - 1))
    records.append({"mode": mode, "lanes": lanes, "mesh": mesh, "tok_s": None,
                    "skipped": "lanes do not divide across mesh"})
    return True


def closed_sweep(model_triple, lane_counts: list[int], *, device, max_new: int,
                 prompt_len: int, requests_per_lane: int = 2, oracle: bool = True,
                 seed: int = 0, mesh=None) -> tuple[Table, list[dict]]:
    cfg, model, params = model_triple
    tab = Table("Serve engine (port), closed loop — generated tokens/s",
                ["lanes", "tok_s", "seq_tok_s", "dispatches", "ms_per_dispatch",
                 "utilization"])
    rng = np.random.default_rng(seed)
    records = []
    for lanes in lane_counts:
        prompts = rng.integers(1, cfg.vocab_size,
                               (lanes, requests_per_lane, prompt_len)).astype(np.int32)
        plens = rng.integers(2, prompt_len + 1, (lanes, requests_per_lane)).astype(np.int32)
        if _indivisible(tab, records, "closed", lanes, mesh):
            continue
        eng = _engine(model, params, lanes, max_new=max_new, prompt_len=prompt_len,
                      requests_per_lane=requests_per_lane, mesh=mesh)
        eng.generate(prompts, plens)  # warm-up (type inference, kernel builds)
        _sync(device)
        t0 = time.perf_counter()
        res = eng.generate(prompts, plens)
        _sync(device)
        wall = time.perf_counter() - t0
        n_tok = int(res["lengths"].sum())
        steps = eng.batched.last_result.steps
        seq = float("nan")
        if oracle and lead_rank():
            t0 = time.perf_counter()
            eng.reference_generate(prompts, plens)
            _sync(device)
            seq = n_tok / (time.perf_counter() - t0)
        tab.add(lanes, n_tok / wall, seq, steps, wall / steps * 1e3, res["utilization"])
        records.append({"mode": "closed", "lanes": lanes, "mesh": mesh or 1,
                        "tok_s": n_tok / wall,
                        "seq_tok_s": None if seq != seq else seq, "wall_s": wall,
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
                    max_context=None, mesh=None) -> tuple[Table, list[dict]]:
    """Poisson arrivals against all-at-once arrivals, retire-and-refill in both."""
    cfg, model, params = model_triple
    tab = Table(f"Serve engine (port), open loop — Poisson arrivals at {rate} req/s vs "
                "all at once",
                ["lanes", "mode", "tok_s", "p50_s", "p99_s", "occupancy", "segments",
                 "dispatches"])
    records = []
    for lanes in lane_counts:
        if _indivisible(tab, records, "poisson", lanes, mesh):
            continue
        eng = _engine(model, params, lanes, max_new=max_new, prompt_len=prompt_len,
                      requests_per_lane=1, segment_steps=segment_steps, metrics=metrics,
                      max_context=max_context, mesh=mesh)
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
                "mode": mode, "lanes": lanes, "mesh": mesh or 1,
                "rate": rate if mode == "poisson" else None,
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


def chaos_requests(num: int, rate: float, chaos_rate: float, prompt_len: int, vocab: int,
                   seed: int) -> tuple[list[Request], dict[int, str]]:
    """A Poisson stream where ``chaos_rate`` of the requests carry fault
    sentinels: ``vocab-1`` = NaN-poison prompt, ``vocab-2`` = livelock
    prompt (alternating).  Returns ``(requests, {rid: fault_kind})``; the
    same draws as ``benchmarks/serve_bench.py``'s."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=num))
    n_fault = max(int(round(num * chaos_rate)), 2) if chaos_rate else 0
    fault_rids = rng.choice(num, size=min(n_fault, num - 1), replace=False)
    injected = {int(rid): ("nonfinite" if i % 2 == 0 else "watchdog")
                for i, rid in enumerate(fault_rids)}
    reqs = []
    for i, t in enumerate(arrivals):
        if injected.get(i) == "nonfinite":
            prompt = np.array([vocab - 1], np.int32)
        elif injected.get(i) == "watchdog":
            prompt = np.array([vocab - 2], np.int32)
        else:
            # Healthy prompts avoid the two sentinel ids.
            prompt = rng.integers(1, vocab - 2, int(rng.integers(1, prompt_len + 1))
                                  ).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, arrival=float(t)))
    return reqs, injected


def chaos_sweep(model_triple, lane_counts: list[int], *, device, rate: float,
                chaos_rate: float, num_requests: int, segment_steps: int,
                max_new: int = 64, prompt_len: int = 6, seed: int = 0,
                metrics=None, mesh=None) -> tuple[Table, list[dict]]:
    """Fault-injected open-loop serving under quarantine.

    A chaos-free serve of the healthy subset first (same rids, same
    arrivals), then the whole injected stream through the same engine:
    healthy requests must come back bit-exact, every request must resolve
    to a terminal status, and the engine must never abort.  Records carry
    a ``violations`` list; the CLI exits non-zero if any cell has one.
    """
    from tools.torch_chaos import ChaosModel

    cfg, model, params = model_triple
    tab = Table(f"Serve engine (port), chaos — {chaos_rate:.0%} of {rate} req/s Poisson "
                "arrivals fault (NaN-poison / livelock), quarantine + watchdog",
                ["lanes", "ok", "faulted", "timeout", "rejected", "retries", "tok_s",
                 "p50_s", "p99_s", "occupancy", "bitexact"])
    records: list[dict] = []
    cmodel = ChaosModel(model, eos_pos=prompt_len + 2)
    knobs = dict(on_fault="quarantine", detect_nonfinite=True, max_attempts=2,
                 retry_backoff_s=0.0)

    # Calibrate the watchdog: a healthy request's per-lane executed
    # dispatches are schedule- and batch-independent (a lane only counts
    # the dispatches it executes), so one fault-free 1-lane serve measures
    # the healthy path length H.  Healthy lanes need <= H; a livelocked lane
    # needs ~ H * max_new / eos_pos >> 2H.  Budget = 2H.
    cal = _engine(cmodel, params, 1, max_new=max_new, prompt_len=prompt_len,
                  requests_per_lane=1, segment_steps=segment_steps, **knobs)
    _, cal_stats = cal.serve([Request(rid=0, prompt=np.full((prompt_len,), 1, np.int32))])
    budget = 2 * cal_stats.vm_steps
    knobs["lane_step_budget"] = budget
    calibration = {"vm_steps": cal_stats.vm_steps,
                   "decode_executions": cal.last_serve_result.tag_stats["decode"][0]}

    for lanes in lane_counts:
        if _indivisible(tab, records, "chaos", lanes, mesh):
            continue
        reqs, injected = chaos_requests(num_requests, rate, chaos_rate, prompt_len,
                                        cfg.vocab_size, seed)
        healthy = [r for r in reqs if r.rid not in injected]
        eng = _engine(cmodel, params, lanes, max_new=max_new, prompt_len=prompt_len,
                      requests_per_lane=1, segment_steps=segment_steps, metrics=metrics,
                      mesh=mesh, **knobs)
        base, _ = eng.serve(healthy)
        base_execs = eng.last_serve_result.tag_stats["decode"][0]
        base_tokens = {c.rid: c.tokens for c in base}
        comps, stats = eng.serve(reqs)
        execs = eng.last_serve_result.tag_stats["decode"][0]

        violations: list[str] = []
        if {c.rid for c in comps} != {r.rid for r in reqs}:
            violations.append("not every request resolved terminally")
        bad_status = [c.rid for c in comps if c.status not in COMPLETION_STATUSES]
        if bad_status:
            violations.append(f"non-terminal statuses at rids {bad_status}")
        not_contained = [c.rid for c in comps if c.rid in injected and c.status == "ok"]
        if not_contained:
            violations.append(f"injected requests completed 'ok': {not_contained}")
        bitexact = True
        for c in comps:
            if c.rid in injected or c.status != "ok":
                continue
            if not np.array_equal(c.tokens, base_tokens[c.rid]):
                bitexact = False
                violations.append(f"healthy rid {c.rid} tokens diverged from chaos-free run")
                break
        n = len(reqs)
        tok_s = stats.generated_tokens / stats.wall_time
        tab.add(lanes, stats.ok, stats.faulted, stats.timeout, stats.rejected, stats.retries,
                tok_s, stats.p50_latency, stats.p99_latency, round(stats.occupancy, 3),
                bitexact)
        records.append({
            "mode": "chaos", "lanes": lanes, "mesh": mesh or 1,
            "device": device_record(device),
            "seed": seed, "rate": rate, "chaos_rate": chaos_rate,
            "num_requests": n, "segment_steps": segment_steps,
            "max_new": max_new, "prompt_len": prompt_len,
            "lane_step_budget": budget, "calibration": calibration,
            "injected": {k: sum(1 for v in injected.values() if v == k)
                         for k in ("nonfinite", "watchdog")},
            "statuses": {s: getattr(stats, s) for s in COMPLETION_STATUSES},
            "injected_rids": {str(rid): kind for rid, kind in sorted(injected.items())},
            "faults": {str(c.rid): c.fault for c in comps if c.status == "faulted"},
            "error_rate": stats.faulted / n,
            "retry_rate": stats.retries / n,
            "shed_rate": stats.rejected / n,
            "timeout_rate": stats.timeout / n,
            "retries": stats.retries,
            "tok_s": tok_s, "wall_s": stats.wall_time,
            "generated_tokens": stats.generated_tokens,
            "p50_latency_s": stats.p50_latency, "p99_latency_s": stats.p99_latency,
            "occupancy": stats.occupancy, "segments": stats.segments,
            "vm_steps": stats.vm_steps,
            "decode_executions": {"healthy": base_execs, "chaos": execs},
            "healthy_bitexact": bitexact,
            "violations": violations,
        })
    return tab, records


def _run(rank: int, device, args, lanes: list[int], mesh):
    """The sweep that ``args`` asks for, on ``device`` (in each rank under a
    mesh; the first writes ``--metrics-out``)."""
    model_triple = load_model(args.full, device, args.seed)
    metrics = MetricsRegistry() if args.metrics_out else None
    if args.chaos:
        out = chaos_sweep(
            model_triple, lanes, device=device, rate=args.rate, chaos_rate=args.chaos_rate,
            num_requests=args.num_requests, segment_steps=args.segment_steps,
            max_new=args.max_new, prompt_len=args.prompt_len, seed=args.seed,
            metrics=metrics, mesh=mesh)
    elif args.arrivals == "poisson":
        out = open_loop_sweep(
            model_triple, lanes, device=device, rate=args.rate,
            num_requests=args.num_requests, segment_steps=args.segment_steps,
            max_new=args.max_new, prompt_len=args.prompt_len, seed=args.seed,
            metrics=metrics, max_context=args.max_context, mesh=mesh)
    else:
        out = closed_sweep(model_triple, lanes, device=device, max_new=args.max_new,
                           prompt_len=args.prompt_len, oracle=not args.full,
                           seed=args.seed, mesh=mesh)
    if args.metrics_out and rank == 0:
        with open(args.metrics_out, "w") as f:
            f.write(metrics.render_prometheus())
        print(f"[wrote {args.metrics_out}]")
    return out


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
    ap.add_argument("--max-new", type=int, default=None,
                    help="new tokens a request (default 16; 64 with --chaos, as the JAX sweep)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="longest prompt (default 8; 6 with --chaos, as the JAX sweep)")
    ap.add_argument("--max-context", type=int, default=None,
                    help="KV cache window (default: prompt + new tokens + 2)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    ap.add_argument("--mesh", default="none",
                    help="ranks to shard every engine's lanes over ('none' = unsharded)")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-injection sweep: Poisson arrivals where --chaos-rate of the "
                         "requests NaN-poison or livelock their lane (quarantine + watchdog)")
    ap.add_argument("--chaos-rate", type=float, default=0.2,
                    help="fraction of chaos requests that fault")
    ap.add_argument("--json", default="BENCH_serve_torch.json", metavar="PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH")
    args = ap.parse_args(argv)
    mesh = None if args.mesh.lower() in ("none", "0") else int(args.mesh)
    if args.json == "BENCH_serve.json":
        raise SystemExit("BENCH_serve.json is the JAX package's record; pick another path")
    device = resolve_device(args.device)
    lanes = [int(x) for x in args.lanes.split(",")]
    if args.max_new is None:
        args.max_new = 64 if args.chaos else 16
    if args.prompt_len is None:
        args.prompt_len = 6 if args.chaos else 8
    if mesh:
        tab, records = on_ranks(_run, mesh, args.device, args, lanes, mesh)
    else:
        tab, records = _run(0, device, args, lanes, None)
    print(tab.render())
    write_json(args.json, {
        "benchmark": "serve_bench_torch",
        "device": device_record(device),
        "config": {"arrivals": args.arrivals, "lanes": lanes, "full": args.full,
                   "rate": args.rate, "seed": args.seed, "chaos": args.chaos,
                   "chaos_rate": args.chaos_rate if args.chaos else None,
                   "num_requests": args.num_requests,
                   "segment_steps": args.segment_steps, "max_new": args.max_new,
                   "prompt_len": args.prompt_len, "max_context": args.max_context,
                   "mesh": mesh or 1},
        "records": records,
    })
    print(f"[wrote {args.json}: {len(records)} records]")
    violations = [v for r in records for v in r.get("violations", [])]
    for v in violations:
        print(f"[VIOLATION] {v}")
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
