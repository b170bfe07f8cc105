#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; every phase checks its results and any failure exits
non-zero (nothing is caught):

1. environment: torch, the card, ``nvidia-smi``'s name and power limit,
   ``nvcc``; TF32 is switched off for matmuls and cuDNN;
2. build: the hand-written CUDA stack kernels, compiled with ``nvcc`` for
   ``sm_90a`` into ``build/torch_kernels/``;
3. kernels: K1 ``masked_push`` and K2 ``masked_peek`` against their plain
   PyTorch versions at the VM's shapes (exact equality), with their device
   time (CUDA-graph replay) and time per call from Python (CUDA events)
   beside their byte bound, the plain version's and one PyTorch indexing
   call's device time;
4. VM exactness: integer programs (fib, mutual recursion) through
   ``autobatch`` on the card, bit-exact against the unbatched oracle;
5. card vs CPU: NUTS on a 100-d correlated Gaussian, same control flow
   chain by chain and the same samples to 1e-4;
6. the slice at full width: NUTS on the paper's 10,000 x 100 logistic
   regression with 1024 chains, once to warm up and once measured, with the
   kernels' launch counts held to the counts the dispatched blocks imply;
   a third, profiled run gives the device's busy time (beside its own wall
   time and the measured run's), its kernel count and top kernels.

The second-to-last line of output is a JSON object describing every
kernel; the last line is ``{"ok": true, "device": {...}}``.  Without CUDA
the script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
CHAINS = 1024  # the paper's widest batch (fig5_throughput.py --full)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# 1. environment
# ---------------------------------------------------------------------------


def phase_env(torch) -> str:
    from repro_torch.kernels import _build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(run([_build.find_nvcc(), "--version"]).splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cudnn (float32 runs in full float32)")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.stack_ops import kernel as sk_kernel

    t0 = time.perf_counter()
    path = _build.build("stack_ops", sk_kernel.SOURCES)
    sk_kernel.library()
    print(f"build: stack_ops in {time.perf_counter() - t0:.2f} s -> "
          f"{path.relative_to(ROOT)}")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _call_ms(torch, fn, iters: int = 200) -> float:
    """Time per call between CUDA events: device time plus whatever host
    overhead the device waits for (the rate at which a loop can call fn)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters: int = 100, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so no host overhead is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def phase_kernels(torch, depth: int, lanes: int) -> dict:
    """K1/K2 vs ref at the VM's shapes; returns per-kernel numbers at the
    widest main-path shape (float32 F=100: the theta/momentum stacks)."""
    from repro_torch.kernels.stack_ops import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    lanes_idx = torch.arange(lanes, device=dev)
    report = {}
    max_err = {"masked_push": 0.0, "masked_peek": 0.0}
    for dtype in (torch.float32, torch.int32, torch.bool):
        for feat in (1, 2, 100):
            shape = (depth, lanes, feat)
            if dtype == torch.bool:
                stack = torch.rand(shape, generator=gen, device=dev) < 0.5
                val = torch.rand((lanes, feat), generator=gen, device=dev) < 0.5
            elif dtype == torch.int32:
                stack = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                                      device=dev, dtype=torch.int32)
                val = torch.randint(-2**31, 2**31 - 1, (lanes, feat), generator=gen,
                                    device=dev, dtype=torch.int32)
            else:
                stack = torch.randn(shape, generator=gen, device=dev)
                val = torch.randn((lanes, feat), generator=gen, device=dev)
            # Pointers include negative and >= depth entries (dropped/clamped).
            ptr = torch.randint(-2, depth + 2, (lanes,), generator=gen, device=dev,
                                dtype=torch.int32)
            mask = torch.rand((lanes,), generator=gen, device=dev) < 0.5

            want = ref.masked_push(stack, ptr, val, mask)
            got = ops.masked_push(stack.clone(), ptr, val, mask)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"masked_push != ref ({dtype}, F={feat})")
            want_p = ref.masked_peek(stack, ptr)
            got_p = ops.masked_peek(stack, ptr)
            check(torch.equal(got_p, want_p), f"masked_peek != ref ({dtype}, F={feat})")
            for name, a, b in (("masked_push", got, want), ("masked_peek", got_p, want_p)):
                err = float((a.double() - b.double()).abs().max())
                max_err[name] = max(max_err[name], err)

            # Byte bounds: ptr (4 B) and mask (1 B) per lane; the push reads
            # val and writes the stack only for the lanes it writes, the
            # peek reads one row and writes one row per lane.
            s = stack.element_size()
            written = int((mask & (ptr >= 0) & (ptr < depth)).sum())
            push_bytes = 5 * lanes + 2 * written * feat * s
            peek_bytes = 2 * lanes * feat * s + 4 * lanes
            # The library yardsticks: index_put_ writes every lane at its
            # clamped row (no mask, no drop), so it does more than K1.
            rows = ptr.clamp(0, depth - 1).long()
            scratch = stack.clone()
            calls = {
                "masked_push": (
                    lambda: ops.masked_push(scratch, ptr, val, mask),
                    lambda: ref.masked_push(stack, ptr, val, mask),
                    lambda: scratch.index_put_((rows, lanes_idx), val),
                    push_bytes),
                "masked_peek": (
                    lambda: ops.masked_peek(stack, ptr),
                    lambda: ref.masked_peek(stack, ptr),
                    lambda: stack[rows, lanes_idx],
                    peek_bytes),
            }
            name = str(dtype).replace("torch.", "")
            for kname, (kern, plain, lib, nbytes) in calls.items():
                call = _call_ms(torch, kern)
                kern_dev = _device_ms(torch, kern)
                plain_dev, lib_dev = _device_ms(torch, plain), _device_ms(torch, lib)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                print(f"kernel {kname} {name:7s} D={depth} Z={lanes} F={feat:3d}: "
                      f"device {kern_dev * 1e3:7.2f} us/launch, call {call * 1e3:7.2f} us "
                      f"(plain {plain_dev * 1e3:7.2f}, library {lib_dev * 1e3:7.2f}, "
                      f"bound {bound * 1e3:6.3f} us)")
                if dtype == torch.float32 and feat == 100:
                    report[kname] = dict(ms=kern_dev, plain_ms=plain_dev, bound_ms=bound,
                                         library_ms=lib_dev, call_ms=call)
    for name in report:
        report[name]["max_abs_err"] = max_err[name]
    return report


# ---------------------------------------------------------------------------
# 4. integer programs through the VM, bit-exact
# ---------------------------------------------------------------------------


def phase_vm(torch, lanes: int) -> None:
    from repro_torch.core import batching, reference
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.testing import build_fib, build_mutual

    gen = torch.Generator().manual_seed(1)
    for name, prog, hi, depth in (("fib", build_fib(), 13, 16),
                                  ("mutual", build_mutual(), 40, 48)):
        n = torch.randint(0, hi, (lanes,), generator=gen, dtype=torch.int32)
        ops.masked_push.launches = ops.masked_peek.launches = 0
        fn = batching.autobatch(prog, max_depth=depth, device="cuda")
        out = fn(n.cuda())["out"].cpu()
        push, peek = ops.masked_push.launches, ops.masked_peek.launches
        want = reference.run_reference_batch(prog, {"n": n})["out"]
        check(torch.equal(out, want), f"{name}: VM on the card != reference")
        check(push > 0 and peek > 0, f"{name}: stack kernels not launched")
        res = fn.last_result
        print(f"vm {name}: Z={lanes} bit-exact vs reference; {res.steps} dispatches, "
              f"launches push={push} peek={peek}")


# ---------------------------------------------------------------------------
# 5. NUTS, card vs CPU
# ---------------------------------------------------------------------------


def phase_nuts(torch) -> None:
    from repro_torch.mcmc import nuts, targets

    settings = nuts.NutsSettings(max_tree_depth=8, num_steps=2, steps_per_leaf=4)
    results = {}
    for dev in ("cuda", "cpu"):
        target = targets.correlated_gaussian(100, 0.95, device=dev)
        kern = nuts.make_nuts_kernel(target, settings, device=dev)
        out = kern(*nuts.initial_state(target, 8, eps=0.1, seed=3, device=dev))
        res = kern.last_result
        check(res.converged, f"NUTS on {dev} did not converge")
        results[dev] = (out["theta"].cpu(), res.lane_steps.cpu(), res.tag_stats["grad"])
    (th_c, ls_c, g_c), (th_h, ls_h, g_h) = results["cuda"], results["cpu"]
    check(torch.equal(ls_c, ls_h), f"lane_steps differ card vs CPU: {ls_c} vs {ls_h}")
    check(g_c == g_h, f"grad tag stats differ card vs CPU: {g_c} vs {g_h}")
    torch.testing.assert_close(th_c, th_h, rtol=1e-4, atol=1e-5)
    err = float((th_c - th_h).abs().max())
    print(f"nuts card vs cpu: correlated_gaussian(100, 0.95), 8 chains, "
          f"lane_steps equal, grad stats {g_c}, max |theta diff| {err:.3g}")


# ---------------------------------------------------------------------------
# 6. the slice at full width
# ---------------------------------------------------------------------------


def phase_full(torch, chains: int, settings) -> dict:
    from repro_torch.core import ir
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.mcmc import nuts, targets

    target = targets.logistic_regression(num_data=10_000, dim=100, device="cuda")
    kern = nuts.make_nuts_kernel(target, settings, device="cuda")
    args = nuts.initial_state(target, chains, eps=0.01, seed=0, device="cuda")
    t0 = time.perf_counter()
    kern(*args)
    torch.cuda.synchronize()
    print(f"full: warm-up run {time.perf_counter() - t0:.2f} s "
          f"({kern.last_result.steps} dispatches)")

    ops.masked_push.launches = ops.masked_peek.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = kern(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    push, peek = ops.masked_push.launches, ops.masked_peek.launches

    res = kern.last_result
    check(res.converged, "full-width NUTS did not converge")
    for k, v in out.items():
        check(tuple(v.shape) == (chains, 100), f"{k} has shape {tuple(v.shape)}")
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
    blocks = kern.lowered.blocks
    want_push = sum(
        int(res.block_exec[b]) * (
            sum(isinstance(op, ir.LPush) for op in blk.ops)
            + isinstance(blk.term, ir.LPushJump))
        for b, blk in enumerate(blocks))
    want_peek = sum(
        int(res.block_exec[b]) * (
            sum(isinstance(op, ir.LPop) for op in blk.ops)
            + isinstance(blk.term, ir.LReturn))
        for b, blk in enumerate(blocks))
    check(push == want_push, f"masked_push launches {push} != {want_push} from block_exec")
    check(peek == want_peek, f"masked_peek launches {peek} != {want_peek} from block_exec")
    execs, active = res.tag_stats["grad"]
    grads = active * settings.grads_per_leaf
    util = kern.utilization["grad"]
    print(f"full: logistic_regression(10000, 100), {chains} chains, "
          f"{settings}, eps 0.01")
    print(f"full: wall {wall:.3f} s, {res.steps} dispatches, "
          f"{wall / res.steps * 1e3:.3f} ms/dispatch, {grads} gradient evaluations, "
          f"{grads / wall:.1f} grads/s, grad utilization {util:.3f}")
    print(f"full: launches masked_push={push} masked_peek={peek} "
          f"(= block_exec x per-block pushes/pops)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern(*args)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    dev_us = sum(e.self_device_time_total for e in avgs)
    n_kernels = sum(e.count for e in avgs)
    print(f"full: profiled run: device busy {dev_us / 1e3:.3f} ms of its own "
          f"{prof_wall * 1e3:.3f} ms wall ({dev_us / 1e6 / prof_wall:.4f} busy share); "
          f"against the unprofiled run's {wall * 1e3:.3f} ms wall "
          f"{dev_us / 1e6 / wall:.4f} (two runs); {n_kernels} device kernels "
          f"({n_kernels / res.steps:.1f} per dispatch)")
    for e in sorted(avgs, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}")
    return {"masked_push": push, "masked_peek": peek}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 2
    from repro_torch.mcmc import nuts

    settings = nuts.NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)
    smi = phase_env(torch)
    phase_build()
    kernels = phase_kernels(torch, nuts.recommended_max_depth(settings), CHAINS)
    phase_vm(torch, 256)
    phase_nuts(torch)
    launches = phase_full(torch, CHAINS, settings)

    replaces = {"masked_push": "src/repro/kernels/stack_ops/kernel.py:41",
                "masked_peek": "src/repro/kernels/stack_ops/kernel.py:83"}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/stack_ops/csrc/stack_ops.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": "bytes",
         "library_ms": kernels[name]["library_ms"]}
        for name in ("masked_push", "masked_peek")]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
