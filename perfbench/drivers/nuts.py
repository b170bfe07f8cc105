"""Many-chain NUTS through the port's public entry point,
``repro_torch.mcmc.nuts.make_nuts_kernel``, on ``repro_torch.mcmc.targets``.

Set-up makes the target from the seed (the program's own constructor),
the chains' start on the device, builds the kernel with the traffic's
backend and warms the cell's own shapes: a few segments of dispatches on
the pc backend (the :class:`Stepper`), one whole call on ``local``, whose
CUDA graphs are captured at their first use.  The window then calls the
kernel again and again, each call continuing every chain from the last
call's ``theta`` with keys drawn from ``(seed, call)``, until ``seconds``
have passed, in whole calls (at least :data:`MIN_CALLS`).

Once the window has closed, the reference (:mod:`perfbench.reference`) runs
the sampled chains of the first call, from the benchmark's own start, and
of the last call, from the program's state at its start, and
:mod:`perfbench.reference.compare` judges the program's outputs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from perfbench import harness
from perfbench.reference import compare
from perfbench.reference import nuts as ref_nuts
from perfbench.reference import targets as ref_targets

#: The window holds at least this many calls: the first and the last are
#: the two compared.
MIN_CALLS = 2

_M63 = (1 << 63) - 1
_WARM_SEGMENT = 16
_WARM_MAX_DISPATCHES = 4096
_WARM_QUIET = 2


def mix(seed: int, *parts: int) -> int:
    """A 63-bit seed for a generator, from the run's seed and indices."""
    h = seed & _M63
    for p in parts:
        h = (h * 0x9E3779B97F4A7C15 + (p & _M63) + 0x632BE59BD9B4E019) & _M63
    return h


@dataclass
class Ctx:
    cell: harness.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    make_kernel: Any = None  # test hook: replaces make_nuts_kernel


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    setup_s: float
    window_s: float
    calls: int
    counters: dict
    checks: dict
    memory_peak_bytes: int
    trace: Optional[harness.Trace] = None
    extra: dict = field(default_factory=dict)


def _keys(seed: int, call: int, chains: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, 1, call))
    return torch.randint(-2**31, 2**31, (chains, 2), generator=g, device=device,
                         dtype=torch.int64).to(torch.int32)


def _start(seed: int, chains: int, dim: int, scale: float, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, 0))
    return scale * torch.randn((chains, dim), generator=g, device=device)


def _sample(seed: int, chains: int, n: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(mix(seed, 2))
    return torch.randperm(chains, generator=g)[:min(n, chains)].sort().values


def _data_seed(seed: int) -> int:
    return mix(seed, 3)


def make_target(cfg: dict, seed: int, device):
    from repro_torch.mcmc import targets
    if cfg["target"] == "logistic_regression":
        return targets.logistic_regression(cfg["num_data"], cfg["dim"], seed=_data_seed(seed),
                                           device=device)
    if cfg["target"] == "correlated_gaussian":
        return targets.correlated_gaussian(cfg["dim"], cfg["rho"], device=device)
    raise ValueError(f"no target {cfg['target']!r}")


def _warm_pc(kernel, args) -> None:
    """Dispatch segments until no new block has run for
    :data:`_WARM_QUIET` segments (every block the call reaches has then run
    once, with the cell's shapes), the call ends, or a cap."""
    st = kernel.stepper(*args)
    state = st.init()
    seen, quiet = -1, 0
    while quiet < _WARM_QUIET and st.steps(state) < _WARM_MAX_DISPATCHES and not st.done(state):
        st.step(state, _WARM_SEGMENT)
        ran = int((np.asarray(state["block_exec"]) > 0).sum())
        quiet = quiet + 1 if ran == seen else 0
        seen = ran
    del st, state


def run(ctx: Ctx) -> Outcome:
    from repro_torch.mcmc import nuts

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, seed = ctx.device, ctx.seed
    cuda = dev.type == "cuda"
    if cuda:
        tf32 = bool(cfg.get("tf32", False))
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
    settings = nuts.NutsSettings(max_tree_depth=cfg["max_tree_depth"],
                                 num_steps=cfg["num_steps"],
                                 steps_per_leaf=cfg["steps_per_leaf"])
    gpl = settings.grads_per_leaf
    chains, dim = tr["chains"], cfg["dim"]
    backend = tr["backend"]
    make = ctx.make_kernel or nuts.make_nuts_kernel
    marks = [("start", time.perf_counter())]
    target = make_target(cfg, seed, dev)
    marks.append(("target", time.perf_counter()))
    options = {k: tr[k] for k in ("schedule", "fuse", "compact_every") if k in tr}
    kernel = make(target, settings, backend=backend, device=dev, **options)
    theta0 = _start(seed, chains, dim, cfg["init_scale"], dev)
    eps = torch.tensor(cfg["eps"], dtype=torch.float32, device=dev)
    marks.append(("kernel", time.perf_counter()))

    # Warm-up on the cell's own shapes.
    warm = (theta0, eps, _keys(seed, -1, chains, dev))
    if backend == "pc":
        _warm_pc(kernel, warm)
    else:
        kernel(*warm)
    del warm
    if cuda:
        torch.cuda.synchronize()

    idx = _sample(seed, chains, tr["check_chains"])
    idx_dev = idx.to(dev)
    prof = None
    if ctx.trace:
        prof = _profiler(cuda)
        prof.start()
    counters = {"grad_execs": 0, "grad_active": 0, "vm_dispatches": 0, "block_execs": 0}
    per_call = []
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    theta = theta0
    first = last = None
    t_setup = time.perf_counter()
    marks.append(("warm", t_setup))
    setup_s = t_setup - ctx.t_start
    k = 0
    with torch.profiler.record_function("perfbench.window"):
        t0 = time.perf_counter()
        while True:
            t_call = time.perf_counter()
            keys = _keys(seed, k, chains, dev)
            theta_in = theta.index_select(0, idx_dev)
            with torch.profiler.record_function("perfbench.call"):
                out = kernel(theta, eps, keys)
            execs, active = kernel.tag_stats.get("grad", (0, 0))
            counters["grad_execs"] += execs
            counters["grad_active"] += active
            if kernel.last_result is not None:
                counters["vm_dispatches"] += kernel.last_result.steps
            if kernel.local_stats is not None:
                counters["block_execs"] += kernel.local_stats.block_execs
            per_call.append((execs, active, time.perf_counter() - t_call))
            bad += (~torch.isfinite(out["theta"]).all(-1)).sum()
            rows = {n: out[n].index_select(0, idx_dev) for n in ("theta", "sum_theta", "sum_sq")}
            last = (k, theta_in, rows)
            if first is None:
                first = last
            theta = out["theta"]
            k += 1
            if k >= MIN_CALLS and time.perf_counter() - t0 >= ctx.seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    trace = None
    if prof is not None:
        prof.stop()
        trace = harness.reduce_profile(prof, "perfbench.window") if cuda else None
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = int(bad)
    calls = k
    # The program's state is freed before the reference runs.
    first = _to_host(first)
    last = _to_host(last)
    del kernel, target, out, theta, rows, theta0, theta_in, keys
    if cuda:
        torch.cuda.empty_cache()

    compared = [first, last] if calls > 1 else [first]
    values, refs = judge_calls(cfg, seed, chains, idx, compared, dev, dtype=torch.float64)
    correct, checks = compare.judge(values, cfg.get("limits", {}))
    correct = correct and failed == 0
    counters["grads"] = counters["grad_active"] * gpl
    counters["chains"] = chains
    counters["grads_per_leaf"] = gpl
    return Outcome(correct=correct, attempted=calls * chains, failed=failed, setup_s=setup_s,
                   window_s=window_s, calls=calls, counters=counters, checks=checks,
                   memory_peak_bytes=int(peak), trace=trace,
                   extra={"per_call": per_call, "setup_parts": _parts(ctx.t_start, marks),
                          "idx": idx, "compared": compared, "refs": refs})


def _parts(t_start: float, marks: list) -> dict:
    """Seconds of each step of set-up (``start``: imports and the card)."""
    out, t = {}, t_start
    for name, m in marks:
        out[name] = m - t
        t = m
    return out


def _to_host(call):
    k, theta_in, rows = call
    return k, theta_in.cpu(), {n: v.cpu() for n, v in rows.items()}


def _profiler(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def reference_outputs(cfg: dict, seed: int, chains: int, idx: torch.Tensor, call: tuple,
                      device, dtype) -> dict:
    """The reference's outputs for the sampled chains of one call."""
    k, theta_in, _ = call
    target = ref_targets.make(cfg, _data_seed(seed), dtype, device)
    keys = _keys(seed, k, chains, device).index_select(0, idx.to(device)).cpu().numpy()
    algo = ref_nuts.Nuts(target, max_tree_depth=cfg["max_tree_depth"],
                         num_steps=cfg["num_steps"], steps_per_leaf=cfg["steps_per_leaf"],
                         dtype=dtype, device=device)
    out = algo.chain(theta_in, cfg["eps"], keys)
    return {n: v.cpu() for n, v in out.items()}


def judge_calls(cfg, seed, chains, idx, calls, device, dtype) -> tuple[dict, list]:
    """The comparison's numbers over the compared calls, and the
    reference's outputs for each."""
    gaps, refs = [], []
    for call in calls:
        ref = reference_outputs(cfg, seed, chains, idx, call, device, dtype)
        gaps.append(compare.chain_gaps(call[2], ref, cfg["num_steps"]))
        refs.append(ref)
    return compare.numbers(torch.cat(gaps)), refs
