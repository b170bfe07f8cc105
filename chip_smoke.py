#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --model-sharding nccl`` on a four-card machine
runs phase 20 alone with one card a rank.)

Phases, in order; every phase checks its results and any failure exits
non-zero (nothing is caught):

1. environment: torch, the card, ``nvidia-smi``'s name and power limit,
   ``nvcc``; TF32 is switched off for matmuls and cuDNN;
2. build: the hand-written CUDA kernels (stack ops, flash attention on the
   CUDA cores and on the tensor cores, decode attention), one ``nvcc``
   each, all started together, for ``sm_90a`` into ``build/torch_kernels/``,
   with ``ptxas``'s register and spill lines, and the count of ``HGMMA``
   and ``UTMALDG`` (TMA load) instructions in the tensor-core kernel's SASS
   where ``cuobjdump`` is present (both must be there);
3. kernels: K1 ``masked_push`` and K2 ``masked_peek`` against their plain
   PyTorch versions at the VM's shapes (exact equality), with their device
   time (CUDA-graph replay) and time per call from Python (CUDA events)
   beside their byte bound, the plain version's and one PyTorch indexing
   call's device time; then the same kernels as the VM launches them,
   grouped: NUTS's block-6 push group and block-7 pop group (12 variables
   and the pc) at 1024 lanes, against ``ref.push_group``/``pop_group``
   (exact equality), with device time, time per call and byte bound (no
   single PyTorch call computes a group);
4. VM exactness: integer programs (fib, mutual recursion) through
   ``autobatch`` on the card, bit-exact against the unbatched oracle;
5. card vs CPU: NUTS on a 100-d correlated Gaussian, same control flow
   chain by chain and the same samples to 1e-4;
6. the slice at full width: NUTS on the paper's 10,000 x 100 logistic
   regression with 1024 chains, once to warm up and once measured, with the
   kernels' launch counts held to the counts the dispatched blocks imply
   (one launch per push or pop group of each dispatched block); a third,
   profiled run gives the device's busy time (beside its own wall time and
   the measured run's), its kernel count, top kernels and K1/K2's total;
7. attention kernels: K3 ``flash_attention`` at the prefill shape (B=8,
   S=T=2048, H=9, Hkv=3, Dh=64) in bf16 (tensor cores) and float32 (CUDA
   cores), at Dh=128, G=2, and in bf16 at the padded head dims: Zamba2-7B's
   heads (2 x 2,048, H=Hkv=32, Dh=112, causal) and HuBERT-XLarge's (2 x
   2,048, H=Hkv=16, Dh=80, not causal), each launch held to the route's
   kernel; K4 ``decode_attention`` at the serving
   shape (B=64, H=9, Hkv=3, Dh=64, W=512, ``count`` drawn from 0 to W) in
   bf16 and float32, each against its plain version (tolerances stated
   there), with device time per launch, time per call, the plain
   version's and one ``scaled_dot_product_attention`` call's device time,
   and the bound (K3's TFLOP/s; K4 timed with a cold L2, rotating over
   copies of the cache, with its share of the byte bound);
8. prefill at full width: SmolLM-135M on 8 x 2048 tokens through
   ``make_prefill_step`` with K3, a warm-up and one measured run (tokens/s,
   30 K3 launches, all on the tensor-core kernel), against the same
   weights with the plain blocked attention: float32 logits within 1e-3,
   bf16 largest difference and top-1 agreement reported;
9. the serving engine at full width: a float32 check (4 lanes x 2
   requests, 16-token prompts and completions) equal token for token to
   the sequential oracle on the card, then bf16 with 64 lanes x 2
   requests (prompts of 2 to 64 tokens, 64 new tokens, a 512-token
   cache), warmed up on one short request and measured (generated tokens/s,
   dispatches, decode utilization, K4 launches held to 30 x decode
   executions), the first request a lane alone, timed (phase 19's
   closed-loop workload), and a profiled run of it for the device's busy
   share and K4's device total;
10. the paper's evaluation: Fig. 5's arms on the 10,000 x 100 logistic
    regression (``num_steps=2`` as in phase 6) — the pc VM under every
    schedule (earliest, popular, lookahead, sweep) and earliest with lane
    compaction every dispatch, and the hand-batched iterative NUTS, all at
    1024 chains; local static batching with CUDA-graph segments and op by
    op (``local``, ``local_eager``) and the unbatched interpreter on one
    chain — each with grads/s, wall, dispatches, ms per dispatch and
    occupancy; the pc arms bit-identical to each other with K1/K2 launches
    held to block_exec x groups (iterations x all groups for sweep),
    ``local`` equal to ``local_eager``; then Fig. 6 at its ``--full``
    setting with batch 64 and 5 of its 10 steps (cut for the time limit;
    pc and local gradient utilization, their ratio);
11. segments and faults: phase 6's NUTS through a ``Stepper`` in segments
    of 7 dispatches, bit-identical to phase 6's single run (outputs,
    dispatches, ``block_exec``, K1/K2 launches); ``tools/torch_chaos.py``'s
    schedule x fuse matrix at batch 64 (every fault code as injected,
    healthy lanes bit-exact with a fault-free run); fib overflowing a
    5-deep stack under quarantine and a lane step budget with no
    ``max_steps`` bound, which must halt;
12. open-loop serving (``GenerationEngine.serve``), SmolLM-135M at full
    width: a float32 check (4 lanes, 8 requests arriving on a virtual
    clock and a hog request under a lane step budget: the hog faulted by
    the watchdog, every other completion equal to the sequential oracle),
    then bf16 with 64 lanes (prompts of 2 to 64 tokens, 64 new tokens,
    a 512-token cache, 16 dispatches a segment): a warm-up on 8 requests, a
    burst of 64 requests at t=0, then the burst again with the first 32
    prompts arriving behind it as new requests, Poisson at half the
    burst's completion rate: they queue while the burst holds every lane
    and go to the lanes it retires, each with the tokens of its prompt's
    first serving (tokens/s, completions by status, p50/p99 latency of
    the run's own completions, segments, dispatches, lane occupancy, lanes
    refilled, K4 launches held to 30 x decode executions), and a profiled
    burst of 8 for the busy share (the request counts cut for the time
    limit);
13. verify, trace, PGO: ``verify=True`` lowering of phase 6's NUTS and of
    the engine's program on the card (fake typing, K4 through its shape
    rule: no launch); phase 6's NUTS with ``trace=True``, bit-identical to
    phase 6's run (outputs, dispatches, ``block_exec``, K1/K2 launches),
    its Perfetto JSON validated and written to ``chiprun_out/`` and its
    block profile printed; the profile-guided NUTS (``optimize``): blocks,
    dispatches, masked updates, kernels a dispatch and K1/K2 launches
    before and after, outputs bit-identical to phase 6, K1/K2 launches =
    block_exec x the re-lowered blocks' groups, and every distinct stack
    group of the re-lowered program exact against the plain versions;
    grads/s of phase 6's kernel and the PGO'd one in turns (A B B A); one
    profiled run of each with the busy share and the five blocks with the
    most device time (``pcvm.block<i>`` scopes); a traced float32 engine
    check equal to the untraced one;
14. frontend: ``examples/torch_quickstart.py``'s handles on the card —
    the decorated restricted-Python ``fib`` over 65,536 lanes (``n`` in
    [0, 13) from a seeded generator, ``max_depth=16``), bit-exact with the
    builder's ``fib`` through ``autobatch`` (outputs, dispatches,
    ``block_exec``) with K1/K2 launched on its path; ``collatz`` over
    65,536 lanes with a ``Shared`` bound against a numpy loop; phase 6's
    NUTS kernel (built with ``batch_size=1024``) called again at the same
    avals: bit-identical to phase 6, one cache hit and still one lowering;
    ``fib(10)`` on the four backends (1024 lanes, 8 for ``reference``);
15. training: SmolLM-135M at full width (bf16 compute, f32 masters, AdamW)
    through ``launch.train.build_trainer`` at 2,048 x 8 tokens (cut from
    ``train_4k``'s 4,096 x 256), 2 microbatches, ``remat="dots"``: 15
    steps of ``ResilientLoop`` on the deterministic stream (checkpoints
    every 5 steps; 40 steps cut for the time limit) with a failure
    injected at step 12, which restores step 10 and replays, the replayed steps' losses bit-exact with their first
    pass (deterministic algorithms on); finite loss that falls by at least
    0.5, masters still float32, no K1-K4 launch; ms a step, tokens/s, the
    device busy share, peak memory and the step's FLOPs against the bf16
    peak; ms a step and peak memory of ``remat`` none, full and dots at one
    microbatch (4 x 2,048); the newest checkpoint restored onto the CPU,
    byte for byte; and a crash-resume of open-loop serving (bf16, 4 lanes,
    6 requests, a crash at the fifth completion after a snapshot that
    holds done requests) whose resume serves only the rest, with tokens
    equal to an uninterrupted run's;
16. families: DeepSeek-MoE-16B (MoE), Zamba2-7B (Mamba2 with a shared
    attention block) and xLSTM-350M (mLSTM and sLSTM), each at full width:
    the float32 engine at 4 lanes x 2 requests equal token for token to
    the sequential oracle at reduced depth (DeepSeek 3 layers, Zamba2 7,
    xLSTM all 24); bf16 serving at full depth, 16 lanes x 1 request a
    lane (cut from 2 for the smoke's time limit; 32 a lane
    would add about 10 minutes to the three models' serving), prompts of 2 to 32
    tokens, 16 new tokens (cut from 32), a 128-token cache (DeepSeek's weights in bf16,
    the others cast once from float32): warm-up, measured (generated
    tokens/s, dispatches, ms a dispatch, K4 launches held to attention
    sites x decode executions, peak memory) and profiled (busy share);
    DeepSeek's mean ``moe_dropped_frac`` at the 16-lane decode batch,
    read outside those runs; the bf16 prefill forward at 2 x 1,024 tokens
    (K3 launches held to the attention sites, every one on the tensor-core
    kernel, logits against the plain attention printed; xLSTM without a
    kernel, its ms printed); then K3 and K4 at each
    family's own attention shapes (DeepSeek's Dh 128, Zamba2's Dh 112),
    K4 in bf16 and float32, against their plain versions, timed as in
    phase 7;
17. multimodal and int8: Qwen2-VL-2B (M-RoPE) at full width: the float32
    engine at 4 of its 28 layers (4 lanes x 2 requests) equal token for
    token to the sequential oracle with the compute-dtype and with the
    int8 KV cache; bf16 serving at full depth as in phase 16 (16 lanes x 1
    request a lane) but of 32 new tokens, once with each cache (K4
    launches held to 28 x decode executions in both), the two runs'
    token agreement printed; the multimodal prefill at 2 x 2,048 (256
    patch embeddings on a 16 x 16 grid at t = 0, 1,792 text tokens after
    them, 3-axis positions) with its 28 K3 launches held to the
    tensor-core kernel, logits against the plain attention printed; K3
    and K4 at its heads (H 12, Hkv 2, Dh 128) against their plain
    versions, timed as in phase 7.  HuBERT-XLarge (48 layers, d 1280, an
    encoder) at full width: the bf16 forward over 2 x 2,048 frames (ms,
    peak memory, finite ``[2, 2048, 504]`` logits, no kernel launched: its
    attention is not causal, so it stays on the plain path, as in the
    reference), the float32 forward at 4 layers on 1 x 256 frames on the
    card against the CPU (within 1e-3), and two ``launch.train`` steps at
    2 x 1,024 frames (the second timed; finite losses, peak memory);
18. chaos and entry points: ``benchmarks/torch_serve_bench.py``'s
    ``chaos_sweep`` called in-process on SmolLM-135M at full width in bf16
    at 16 and 64 lanes: 64 requests arriving by a Poisson process at 32
    per s (seed 0), a fifth of them (13) NaN-poisoning or livelocking
    their lane through ``tools/torch_chaos.py``'s ``ChaosModel``, prompts
    of up to 6 tokens and 64 new tokens, under quarantine, the non-finite
    check and a watchdog calibrated on a fault-free 1-lane serve, one
    retry a request: no violation, the healthy requests bit-exact with a
    chaos-free serve, every injected request faulted with its own fault
    kind, 64 terminal statuses, K4 launches held to 30 x the sweep's decode
    executions (statuses, rates, p50/p99, tokens/s, the budget and the
    phase's seconds printed); ``Target.grad``/``value_and_grad`` on phase
    6's 10,000 x 100 logistic regression (one chain and 1024 through
    ``vmap``) against ``torch.autograd.grad`` of ``logp`` (within 1e-5 of
    the largest entry); and, as subprocesses on the card beside the sweep,
    ``examples/torch_serve_lm.py --check`` (closed loop, equal to the
    sequential oracle), ``examples/torch_serve_lm.py --open-loop`` and
    ``python -m benchmarks.torch_run --only fig6,serve --batches 8
    --serve-arrivals poisson --serve-requests 16`` with its records in
    ``chiprun_out/``, both strictly valid.

19. lanes over ranks: two processes share the card through
    ``repro_torch.distributed.spawn`` with a gloo default group (NCCL
    refuses two ranks on one card; the backend is printed), each holding
    half the lanes and agreeing on every dispatch through one integer
    all-reduce on the host: NUTS on phase 6's 10,000 x 100 logistic
    regression at 1024 chains (512 a rank) under earliest, lookahead and
    earliest with compaction every dispatch, K1/K2 on the card, outputs held
    bit-exact to phase 6's run (or, where the target's product rounds
    otherwise at 512 rows, the same control flow chain by chain and the
    samples within phase 5's 1e-4; which held is printed), ``steps`` and
    ``block_exec`` to the unsharded runs' and each rank's K1/K2 launches
    to block_exec x the blocks' groups; then SmolLM-135M in bf16 at full
    width with its 64 lanes over the ranks, on phase 9's first request a
    lane (closed loop) and phase 12's burst with its 32 Poisson arrivals
    behind it, at their times (open loop: admissions after t=0, queueing
    and refills of retired lanes, decided on the first rank's clock; at
    least one refill checked), tokens equal to those unsharded runs' (or,
    where bf16 GEMMs at 32 rows round otherwise, each rank's lanes equal to
    an unsharded 32-lane engine's, with the agreement printed) and each
    rank's K4 launches held to 30 x its decode executions; grads/s,
    tokens/s, dispatches and ms a dispatch printed beside those of the
    same workloads unsharded in the same call; then a lane-mesh snapshot:
    phase 9's first request a lane served with ``checkpoint_dir``, stopped
    after its first segment's snapshot, and resumed by a fresh engine,
    every token equal to the closed loop's.

20. model sharding: SmolLM-135M (full width, 4 of its 30 layers, 4 x
    1,024) and DeepSeek-MoE-16B (full width, 2 layers, capacity factor
    E/k, so nothing drops) unsharded on the card in float32 (the
    reference) and in bf16 (a control that must exceed each limit of
    ``SHARD_TOL``), and SmolLM at full depth in bf16; then four ranks on a
    ``(data 2, model 2)`` mesh over gloo: first a probe of the collectives
    gloo carries on CUDA tensors (c10d and functional), then SmolLM at
    full width and depth through ``build_trainer(mesh=)`` in bf16 (its
    collectives a step and ms a step), SmolLM at 4 layers in float32 held to the
    unsharded float32 run within ``SHARD_TOL`` (losses, the parameters'
    update and AdamW's first moment after the first step, shard by shard),
    its state saved after step 2, restored whole (bit-identical to the
    gathered DTensors) and back onto the mesh with step 3 replayed (the
    same loss), the same at two microbatches held likewise, with each
    rank's FLOPs in the first step at one and at two microbatches counted
    (``op_cost``) and held equal within 3 %, and DeepSeek-MoE in float32
    through the expert-parallel path (once a step on every rank) held
    likewise, with the tokens whose expert set differs from the unsharded
    run's in the first step counted.

21. the dry-run against the card: ``python -m repro_torch.launch.dryrun
    --arch smollm-135m --shape decode_32k`` and the same with
    ``--multi-pod`` as subprocesses, started beside phase 2's build (CPU
    work only) and read here (the production meshes, 32 x 8 and
    2 x 32 x 8, on a fake process group and meta tensors: each must exit
    0 with 256 / 512 chips, its mesh, a bottleneck and a positive peak);
    phase 8's prefill (SmolLM-135M, bf16, 8 x 2,048, K3) counted by the op
    counter (``launch/op_cost.py``) on meta tensors and then run on the
    card under the same counter: FLOPs, bytes, ops, counted peaks and K3's
    records equal between the two, K3's records equal to its 30 launches,
    the counted peak over ``torch.cuda.max_memory_allocated`` over the step
    held to ``DRYRUN_PEAK_RATIO``, and ``t_compute`` / ``t_memory`` (the
    dry-run's H100 constants) beside the measured ms; likewise a
    SmolLM-135M train step (4 x 1,024, two microbatches) and a decode step
    (64 sequences, a 512-row cache, K4's records) (``_hold_counted``);
    phase 6's NUTS through
    ``fn.lower(...)``: ``compile()`` and ``cost_analysis()``, then
    ``ProgramCounterVM.step_fn`` driven to the end, bit-exact with phase
    6's run (outputs, ``steps``, ``block_exec``, K1/K2 launches).

The output ends with three lines: a JSON object describing every kernel,
``nvidia-smi``'s name and power limit of the card, and
``{"ok": true, "device": {...}}``.  Without CUDA the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
L2_BYTES = 50e6  # H100 L2 cache
# H100 SXM dense peaks (NVIDIA data sheet, no sparsity): bf16 on the tensor
# cores; float32 outside them (the float32 kernels run on the CUDA cores).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
CHAINS = 1024  # the paper's widest batch (fig5_throughput.py --full)
ARCH = "smollm-135m"  # the repo's serving model (examples/serve_lm.py)


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
    """Build every kernel library at once (one ``nvcc`` per source), and
    count the tensor-core and TMA instructions of K3's Hopper kernel."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_decode import kernel as fd_kernel
    from repro_torch.kernels.stack_ops import kernel as sk_kernel

    libs = {"stack_ops": (sk_kernel.SOURCES, sk_kernel.library),
            "flash_attention": (fa_kernel.SOURCES, fa_kernel.library),
            "flash_attention_sm90": (fa_kernel.SM90_SOURCES, fa_kernel.library_sm90),
            "flash_decode": (fd_kernel.SOURCES, fd_kernel.library)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = dict(zip(libs, pool.map(lambda kv: _build.build(kv[0], kv[1][0]),
                                         libs.items())))
    for name, (_, library) in libs.items():
        library()
        path = paths[name]
        print(f"build: {name} -> {path.relative_to(ROOT)}")
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas: {line.strip()}")
    print(f"build: all libraries in {time.perf_counter() - t0:.2f} s (in parallel)")

    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print("build: cuobjdump not available")
        return
    sass = run([str(cuobjdump), "-sass", str(paths["flash_attention_sm90"])])
    hgmma, tma = sass.count("HGMMA"), sass.count("UTMALDG")
    print(f"build: flash_attention_sm90 SASS holds {hgmma} HGMMA and {tma} UTMALDG "
          f"instructions")
    check(hgmma > 0 and tma > 0, "K3's Hopper kernel has no HGMMA or no TMA load in its SASS")


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


def _rotating(fn, args: list):
    """A call of ``fn`` on the next of ``args`` (tuples) in turn each time it
    is called; captured in a CUDA graph, the calls keep that order."""
    state = {"i": 0}

    def call():
        a = args[state["i"] % len(args)]
        state["i"] += 1
        return fn(*a)

    return call


def phase_kernels(torch, depth: int, lanes: int) -> dict:
    """K1/K2 vs ref at the VM's shapes, one stack a launch and grouped as
    the VM launches them; returns per-kernel numbers of the groups."""
    from repro_torch.kernels.stack_ops import ops, ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    lanes_idx = torch.arange(lanes, device=dev)
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
    # The groups are held to exact equality, so they add no error.
    report = _stack_groups(torch, depth, lanes)
    for name in report:
        report[name]["max_abs_err"] = max_err[name]
    return report


def _row_bytes(spec) -> int:
    return int(np.prod(spec.shape, dtype=np.int64)) * spec.dtype.itemsize


def _push_group_bytes(specs, entries, mask) -> int:
    """Bytes a push group must move: per entry the old top where a lane
    keeps it or writes it to the stack, the src of masked lanes, the new
    top, the stack rows written, pointers in and out and the flag (9 B a
    lane); the mask once."""
    z, on = mask.numel(), int(mask.sum())
    total = z
    for spec, (_, ptr, _, src) in zip(specs, entries):
        row = _row_bytes(spec)
        w = int((mask & (ptr >= 0) & (ptr < spec.depth)).sum())
        total += 9 * z + 2 * w * row
        if src is not None:
            total += (z - on) * row + on * row + z * row
    return total


def _pop_group_bytes(specs, mask) -> int:
    """Per entry the stack row of masked lanes, the old top of the others,
    the new top and pointers in and out; the mask once."""
    z = mask.numel()
    return z + sum(2 * z * _row_bytes(spec) + 8 * z for spec in specs)


def _stack_groups(torch, depth: int, lanes: int) -> dict:
    """NUTS's block-6 push group and block-7 pop group, as the VM makes
    them, against the plain versions; their numbers for the kernels line."""
    from repro_torch.core import pc_vm
    from repro_torch.kernels.stack_ops import ref
    from repro_torch.mcmc import nuts, targets
    from repro_torch.testing import stack_group_inputs, to_torch

    settings = nuts.NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)
    target = targets.logistic_regression(num_data=10_000, dim=100, device="cuda")
    lowered = nuts.make_nuts_kernel(target, settings, device="cuda").lowered
    vm = pc_vm.ProgramCounterVM(lowered, pc_vm.VMConfig(batch_size=lanes, max_depth=depth),
                                "cuda")
    (push,), (pop,) = vm.stack_groups[6], vm.stack_groups[7]
    check(push.kind == "push" and push.pc and len(push) == 13, f"block 6 group {push}")
    check(pop.kind == "pop" and pop.pc and len(pop) == 13, f"block 7 group {pop}")
    dev = torch.device("cuda")

    def make(group, seed):
        np_entries, np_mask = stack_group_inputs(group.call.specs, lanes, seed)
        entries = [(to_torch(st, sp.dtype, dev), torch.from_numpy(p).to(dev),
                    to_torch(t, sp.dtype, dev), to_torch(src, sp.dtype, dev))
                   for (st, p, t, src), sp in zip(np_entries, group.call.specs)]
        if group.pc:  # the pc push has no src
            entries[-1] = entries[-1][:3] + (None,)
        return entries, torch.from_numpy(np_mask).to(dev)

    report = {}
    entries, mask = make(push, 20)
    clone = [(st.clone(), p, t, src) for st, p, t, src in entries]
    flags = torch.zeros(lanes, dtype=torch.bool, device=dev)
    want_flags = flags.clone()
    got = push.call(entries, mask, flags, depth)
    want = ref.push_group(clone, mask, want_flags, depth)
    torch.cuda.synchronize()
    check(torch.equal(flags, want_flags), "push group: overflow flags != ref")
    for i, spec in enumerate(push.call.specs):
        same = (torch.equal(entries[i][0], clone[i][0]) and torch.equal(got[0][i], want[0][i])
                and (got[1][i] is None) == (want[1][i] is None)
                and (got[1][i] is None or torch.equal(got[1][i], want[1][i])))
        check(same, f"push group entry {i} ({spec}) != ref.push_group")
    nbytes = _push_group_bytes(push.call.specs, entries, mask)
    report["masked_push"] = _time_group(
        torch, "push group (block 6)", len(push), lanes, nbytes,
        lambda: push.call(entries, mask, flags, depth),
        lambda: ref.push_group(clone, mask, want_flags, depth))

    entries, mask = make(pop, 21)
    pop_entries = [(st, p, t) for st, p, t, _ in entries]
    got = pop.call(pop_entries, mask)
    want = ref.pop_group(pop_entries, mask)
    torch.cuda.synchronize()
    for i, spec in enumerate(pop.call.specs):
        check(torch.equal(got[0][i], want[0][i]) and torch.equal(got[1][i], want[1][i]),
              f"pop group entry {i} ({spec}) != ref.pop_group")
    nbytes = _pop_group_bytes(pop.call.specs, mask)
    report["masked_peek"] = _time_group(
        torch, "pop group (block 7)", len(pop), lanes, nbytes,
        lambda: pop.call(pop_entries, mask), lambda: ref.pop_group(pop_entries, mask))
    return report


def _time_group(torch, what: str, n: int, lanes: int, nbytes: int, kern, plain) -> dict:
    call = _call_ms(torch, kern)
    kern_dev = _device_ms(torch, kern)
    plain_dev = _device_ms(torch, plain, 20)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel {what}: {n} stacks, Z={lanes}, exact vs plain: device "
          f"{kern_dev * 1e3:7.2f} us/launch, call {call * 1e3:7.2f} us (plain "
          f"{plain_dev * 1e3:8.2f}, library -, bound {bound * 1e3:6.3f} us for "
          f"{nbytes / 1e6:.3f} MB; {bound / kern_dev:.3f} of it)")
    return dict(ms=kern_dev, plain_ms=plain_dev, bound_ms=bound, bound_by="bytes",
                library_ms=None, call_ms=call)


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
    kern = nuts.make_nuts_kernel(target, settings, batch_size=chains, device="cuda")
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
    per_push = [_group_launches(blk, ir.LPush, ir.LPushJump) for blk in blocks]
    per_peek = [_group_launches(blk, ir.LPop, ir.LReturn) for blk in blocks]
    want_push = sum(int(n) * k for n, k in zip(res.block_exec, per_push))
    want_peek = sum(int(n) * k for n, k in zip(res.block_exec, per_peek))
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
    print(f"full: launches masked_push={push} masked_peek={peek} (= block_exec x "
          f"push/pop groups of each block; {sum(k > 0 for k in per_push)} blocks push, "
          f"{sum(k > 0 for k in per_peek)} pop)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern(*args)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = _device_kernels(torch, prof)
    dev_us = sum(ns for _, ns in kernels.values()) / 1e3
    n_kernels = sum(n for n, _ in kernels.values())
    print(f"full: profiled run: device busy {dev_us / 1e3:.3f} ms of its own "
          f"{prof_wall * 1e3:.3f} ms wall ({dev_us / 1e6 / prof_wall:.4f} busy share); "
          f"against the unprofiled run's {wall * 1e3:.3f} ms wall "
          f"{dev_us / 1e6 / wall:.4f} (two runs); {n_kernels} device kernels "
          f"({n_kernels / res.steps:.1f} per dispatch)")
    for key, (n, ns) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"  {ns / 1e6:9.3f} ms {n:6d}x  {key[:90]}")
    for name in ("push_kernel", "pop_kernel"):
        k = [v for key, v in kernels.items() if name in key]
        print(f"full: {name} device time {sum(ns for _, ns in k) / 1e6:.3f} "
              f"ms in {sum(n for n, _ in k)} launches of the profiled run")
    return {"masked_push": push, "masked_peek": peek}, dict(kern=kern, args=args, out=out,
                                                            res=res, wall=wall,
                                                            kpd=n_kernels / res.steps)


def _group_launches(blk, op_type, pc_term) -> int:
    """Stack-kernel launches of one dispatch of ``blk``: its runs of
    ``op_type`` ops, the pc's push or pop joining the last (or alone), one
    launch per 16 stacks."""
    runs, n = [], 0
    for op in blk.ops:
        if isinstance(op, op_type):
            n += 1
        elif n:
            runs, n = runs + [n], 0
    runs += [n] if n else []
    if isinstance(blk.term, pc_term):
        runs = runs[:-1] + [runs[-1] + 1] if runs else [1]
    return sum(-(-r // 16) for r in runs)


# ---------------------------------------------------------------------------
# 7. attention kernels against their plain versions
# ---------------------------------------------------------------------------


def _bound_ms(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: the larger of its FLOPs over the dense
    peak of its type and its bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Float32: the kernel and the plain version sum 2048-long rows in another
# order.  bf16: both compute float32 and round once, so they differ by
# about one bf16 ulp (2**-8 relative) of an O(1) output.
ATTN_TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=1e-2, atol=2e-2)}


def _k3_check(torch, b: int, s: int, h: int, hk: int, dh: int, dtype,
              causal: bool = True) -> dict:
    """K3 on seeded ``[B, S, H, Dh]`` operands against its plain version,
    and its device time a launch beside its call time, the plain
    version's, one SDPA call's and the bound; prints one line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.testing import attention_inputs

    name = str(dtype).replace("torch.", "")
    q, k, v = (x.to("cuda", dtype) for x in attention_inputs(b, s, s, h, hk, dh, seed=7))
    sm90_before = fa_ops.flash_attention.sm90_launches
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = fa_ref.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    on_sm90 = fa_ops.flash_attention.sm90_launches == sm90_before + 1
    # The tensor-core kernel takes bf16 at every head dim, the CUDA-core one float32.
    check(fa_kernel.route(dtype) == ("sm90" if dtype == torch.bfloat16 else "cuda_cores"),
          f"K3 {name} Dh={dh}: route {fa_kernel.route(dtype)}")
    check(on_sm90 == (fa_kernel.route(dtype) == "sm90"),
          f"K3 {name} Dh={dh} took the wrong kernel (tensor cores: {on_sm90})")
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[name])
    err = float((got.float() - want.float()).abs().max())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kern_dev = _device_ms(torch, lambda: fa_ops.flash_attention(q, k, v, causal=causal), 5, 3)
    call = _call_ms(torch, lambda: fa_ops.flash_attention(q, k, v, causal=causal), 10)
    plain = _device_ms(torch, lambda: fa_ref.attention(q, k, v, causal=causal), 3, 2)
    lib = _device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 5, 3)
    flops = 4 * b * h * s * s * dh / (2 if causal else 1)
    nbytes = (2 * b * s * h * dh + 2 * b * s * hk * dh) * q.element_size()
    bound, by = _bound_ms(flops, nbytes, name)
    kind = "tensor cores" if on_sm90 else "CUDA cores"
    print(f"kernel flash_attention {name:8s} ({kind}) B={b} S=T={s} H={h} Hkv={hk} Dh={dh} "
          f"{'causal' if causal else 'non-causal'}: "
          f"device {kern_dev * 1e3:9.1f} us/launch, call {call * 1e3:9.1f} us "
          f"(plain {plain * 1e3:9.1f}, sdpa {lib * 1e3:8.1f}, bound {bound * 1e3:7.1f} us "
          f"by {by}; {flops / kern_dev / 1e9:.1f} TFLOP/s, {bound / kern_dev:.3f} of the "
          f"bound); max |err| {err:.3g}")
    return dict(ms=kern_dev, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                call_ms=call, max_abs_err=err)


def _k4_check(torch, b: int, w: int, h: int, hk: int, dh: int, dtype, seed: int = 8) -> dict:
    """K4 on a seeded ``[B, W, Hkv, Dh]`` cache with ``count`` drawn from 0
    to W (one empty and one full cache) against its plain version, timed
    with a cold L2 (each timed call reads its own copy of the cache, and
    the copies read between two uses of one copy exceed twice the 50 MB
    L2) beside its call time, the plain version's, one masked SDPA call's
    and the byte bound; prints one line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    from repro_torch.testing import decode_inputs

    dev = torch.device("cuda")
    name = str(dtype).replace("torch.", "")
    q0, k0, v0, _ = decode_inputs(b, w, h, hk, dh, seed=seed)
    count = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, w + 1, b)
                             .astype(np.int32))
    count[0], count[-1] = 0, w  # an empty and a full cache
    count = count.to(dev)
    valid = (torch.arange(w, device=dev)[None] < count[:, None])[:, None, None, :]
    rows = int(count.sum())
    q, k, v = (x.to(dev, dtype) for x in (q0, k0, v0))
    got = fd_ops.decode_attention(q, k, v, count)
    want = fd_ref.decode_attention(q, k, v, count)
    torch.cuda.synchronize()
    check(bool((got[0] == 0).all()), "decode_attention: count == 0 must give zeros")
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[name])
    err = float((got.float() - want.float()).abs().max())
    s_el = q.element_size()
    nbytes = 2 * b * h * dh * s_el + 4 * b + 2 * rows * hk * dh * s_el
    copies = 2 + int(2 * L2_BYTES // nbytes)
    caches = [(k.clone(), v.clone()) for _ in range(copies)]
    sdpa_caches = [tuple(x.transpose(1, 2).contiguous() for x in kv) for kv in caches]
    qt = q[:, :, None]  # [B, H, 1, Dh]
    kern_dev = _device_ms(torch, _rotating(
        lambda kc, vc: fd_ops.decode_attention(q, kc, vc, count), caches))
    call = _call_ms(torch, _rotating(
        lambda kc, vc: fd_ops.decode_attention(q, kc, vc, count), caches))
    plain = _device_ms(torch, _rotating(
        lambda kc, vc: fd_ref.decode_attention(q, kc, vc, count), caches), 20)
    lib = _device_ms(torch, _rotating(
        lambda kt, vt: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid,
                                                      enable_gqa=True), sdpa_caches))
    warm = _device_ms(torch, lambda: fd_ops.decode_attention(q, k, v, count))
    bound, by = _bound_ms(4 * h * dh * rows, nbytes, name)
    print(f"kernel decode_attention {name:8s} B={b} W={w} H={h} Hkv={hk} Dh={dh} "
          f"(mean count {rows / b:.1f}; cold L2, {copies} cache copies): device "
          f"{kern_dev * 1e3:7.2f} us/launch ({bound / kern_dev:.3f} of its byte bound; "
          f"warm L2 {warm * 1e3:7.2f}), call {call * 1e3:7.2f} us (plain {plain * 1e3:8.2f}, "
          f"sdpa {lib * 1e3:7.2f}, bound {bound * 1e3:6.3f} us by {by}); max |err| {err:.3g}")
    return dict(ms=kern_dev, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                call_ms=call, max_abs_err=err)


K3_PADDED_SHAPES = ((2, 2048, 32, 32, 112, True), (2, 2048, 16, 16, 80, False))


def phase_attention_kernels(torch) -> dict:
    """K3 at the prefill shapes and K4 at the serving shape, against their
    plain versions; returns per-kernel numbers at the main path's shape
    (bf16, SmolLM-135M's heads)."""
    report = {}
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0}
    for b, s, h, hk, dh in ((8, 2048, 9, 3, 64), (2, 2048, 16, 8, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            if dh == 128 and dtype == torch.float32:
                continue
            row = _k3_check(torch, b, s, h, hk, dh, dtype)
            max_err["flash_attention"] = max(max_err["flash_attention"], row["max_abs_err"])
            if (dh, dtype) == (64, torch.bfloat16):
                report["flash_attention"] = row
    # The padded head dims: Zamba2-7B's heads (causal) and HuBERT-XLarge's
    # (its encoder attends both ways), each at 2 x 2,048.
    for b, s, h, hk, dh, causal in K3_PADDED_SHAPES:
        row = _k3_check(torch, b, s, h, hk, dh, torch.bfloat16, causal=causal)
        max_err["flash_attention"] = max(max_err["flash_attention"], row["max_abs_err"])
    for dtype in (torch.bfloat16, torch.float32):
        row = _k4_check(torch, 64, 512, 9, 3, 64, dtype)
        max_err["decode_attention"] = max(max_err["decode_attention"], row["max_abs_err"])
        if dtype == torch.bfloat16:
            report["decode_attention"] = row
    for name in report:
        report[name]["max_abs_err"] = max_err[name]
    return report


# ---------------------------------------------------------------------------
# 8. prefill at full width
# ---------------------------------------------------------------------------


def phase_prefill(torch) -> int:
    """SmolLM-135M prefill through K3; returns K3's launches in the
    measured run."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import get_model
    from repro_torch.serve.steps import make_prefill_step

    cfg = configs.get_config(ARCH)
    b, s = 8, 2048  # cut from prefill_32k's 32 x 32768 for the time limit
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()
    batch = {"tokens": tokens}
    flash = get_model(cfg, use_flash=True, device="cuda")
    params = flash.init(torch.Generator(device="cuda").manual_seed(0))
    step = make_prefill_step(flash)
    t0 = time.perf_counter()
    step(params, batch)
    torch.cuda.synchronize()
    print(f"prefill: warm-up {time.perf_counter() - t0:.3f} s")
    fa_ops.flash_attention.launches = fa_ops.flash_attention.sm90_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_ops.flash_attention.launches
    sm90 = fa_ops.flash_attention.sm90_launches
    check(launches == cfg.num_layers, f"K3 launched {launches} times, want {cfg.num_layers}")
    check(sm90 == launches, f"only {sm90} of {launches} K3 launches took the tensor-core kernel")
    check(tuple(out.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          f"prefill logits {tuple(out.shape)} not finite")
    print(f"prefill: {ARCH} full width ({cfg.num_layers} layers, d={cfg.d_model}), "
          f"{cfg.compute_dtype}, {b} x {s} tokens: {wall * 1e3:.3f} ms, "
          f"{b * s / wall:.1f} tokens/s, K3 launches {launches} (tensor-core kernel {sm90})")

    for dtype in ("float32", "bfloat16"):
        c = replace(cfg, compute_dtype=dtype)
        lf, _ = get_model(c, use_flash=True, device="cuda").forward(params, batch)
        lp, _ = get_model(c, use_flash=False, device="cuda").forward(params, batch)
        diff = float((lf.float() - lp.float()).abs().max())
        top1 = float((lf.argmax(-1) == lp.argmax(-1)).float().mean())
        if dtype == "float32":
            # TF32 is off: both run in float32 and differ by summation order.
            torch.testing.assert_close(lf, lp, rtol=1e-3, atol=1e-3)
        check(bool(torch.isfinite(lf).all()), f"{dtype} flash logits not finite")
        print(f"prefill: {dtype} K3 vs plain blocked attention, all {b * s} positions: "
              f"max |logit diff| {diff:.3g}, top-1 agreement {top1:.4f}"
              + (" (held to 1e-3)" if dtype == "float32" else ""))
        del lf, lp
    return launches


# ---------------------------------------------------------------------------
# 9. the serving engine at full width
# ---------------------------------------------------------------------------


def phase_engine(torch) -> tuple[int, dict]:
    """The closed-loop engine on SmolLM-135M; returns K4's launches in the
    measured run, and the tokens, lengths and figures of a run of the
    first request a lane (phase 19 holds the sharded engine to them)."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine
    from repro_torch.testing import engine_inputs

    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = get_model(cfg, device="cuda").init(gen)

    # Check: float32 (TF32 off), 4 lanes x 2 requests, against the oracle.
    model32 = get_model(replace(cfg, compute_dtype="float32"), device="cuda")
    ecfg = EngineConfig(lanes=4, max_context=64, max_prompt_len=16, max_new_tokens=16,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(model32, params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=11)
    t0 = time.perf_counter()
    res = eng.generate(prompts, plens)
    ref = eng.reference_generate(prompts, plens)
    check(np.array_equal(res["tokens"], ref["tokens"]), "engine tokens != sequential oracle")
    check(np.array_equal(res["lengths"], ref["lengths"]), "engine lengths != sequential oracle")
    print(f"engine check: {ARCH} full width float32, 4 lanes x 2 requests: equal to the "
          f"sequential oracle token for token ({int(res['lengths'].sum())} tokens, "
          f"{eng.batched.last_result.steps} dispatches; {time.perf_counter() - t0:.2f} s)")

    # Measure: bf16, 64 lanes x 2 requests.
    ecfg = EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(get_model(cfg, device="cuda"), params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=12)
    # Warm-up: the lowering and one short request on one lane.
    one = np.zeros(ecfg.lanes, np.int32)
    one[0] = 1
    t0 = time.perf_counter()
    eng.generate(prompts, np.full_like(plens, 2), n_req=one)
    torch.cuda.synchronize()
    print(f"engine: warm-up (type inference and one short request) "
          f"{time.perf_counter() - t0:.2f} s")
    fd_ops.decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, plens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd_ops.decode_attention.launches
    res = eng.batched.last_result
    execs, active = eng.batched.tag_stats["decode"]
    check(res.converged, "engine run did not converge")
    check(launches == cfg.num_layers * execs,
          f"K4 launched {launches} times, want {cfg.num_layers} x {execs} decode executions")
    n_tok = int(out["lengths"].sum())
    check(n_tok > 0 and bool((out["lengths"] <= ecfg.max_new_tokens).all()),
          f"engine generated {n_tok} tokens")
    print(f"engine: {ARCH} full width bf16, 64 lanes x 2 requests, prompts 2-64, "
          f"64 new tokens, cache 512: wall {wall:.3f} s, {n_tok} tokens generated, "
          f"{n_tok / wall:.1f} tokens/s, {res.steps} dispatches, "
          f"{wall / res.steps * 1e3:.3f} ms/dispatch, decode executions {execs} "
          f"(active lane-steps {active}), decode utilization {out['utilization']:.4f}, "
          f"K4 launches {launches}")

    # The first request a lane, timed: phase 19 serves the same workload
    # over two ranks.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = eng.generate(prompts, plens, n_req=np.ones(ecfg.lanes, np.int32))
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    first_tok, first_steps = int(first["lengths"].sum()), eng.batched.last_result.steps
    print(f"engine: the first request a lane: wall {first_wall:.3f} s, {first_tok} tokens, "
          f"{first_tok / first_wall:.1f} tokens/s, {first_steps} dispatches, "
          f"{first_wall / first_steps * 1e3:.3f} ms/dispatch")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, plens, n_req=np.ones(ecfg.lanes, np.int32))
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    kernels = _device_kernels(torch, prof)
    dev_us = sum(ns for _, ns in kernels.values()) / 1e3
    n_kernels = sum(n for n, _ in kernels.values())
    print(f"engine: profiled run: device busy {dev_us / 1e3:.3f} ms of its own "
          f"{prof_wall * 1e3:.3f} ms wall ({dev_us / 1e6 / prof_wall:.4f} busy share); "
          f"{n_kernels} device kernels ({n_kernels / first_steps:.1f} per dispatch)")
    for key, (n, ns) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"  {ns / 1e6:9.3f} ms {n:7d}x  {key[:90]}")
    k4 = [v for key, v in kernels.items() if "decode_split" in key or "decode_combine" in key]
    print(f"engine: K4 device time {sum(ns for _, ns in k4) / 1e6:.3f} ms "
          f"in {sum(n for n, _ in k4)} kernel launches (split and combine) of the "
          f"profiled run")
    return launches, dict(tokens=first["tokens"], lengths=first["lengths"],
                          tok_s=first_tok / first_wall, steps=first_steps, wall=first_wall)


# ---------------------------------------------------------------------------
# 10. the paper's evaluation: Fig. 5 arms and Fig. 6
# ---------------------------------------------------------------------------

#: Fig. 5's pc arms: (schedule, compact_every).
PC_ARMS = (("earliest", None), ("popular", None), ("lookahead", None), ("sweep", None),
           ("earliest", 1))
#: Chains of the arms that run below full width (printed as cuts).
LOCAL_CHAINS = CHAINS
UNBATCHED_CHAINS = 1


def _timed_run(torch, fn):
    """``fn()``'s result and wall seconds, the card idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _device_kernels(torch, prof) -> dict:
    """The device events (kernels, copies, fills) of a finished profile by
    name, ``{name: [count, ns]}``, read straight from its trace: the
    profiler's own per-op tables take minutes to build for the 10^5-10^6
    events of a serving run."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            entry = out.setdefault(e.name(), [0, 0])
            entry[0] += 1
            entry[1] += e.duration_ns()
    return out


def _busy(torch, fn) -> tuple[float, int, float]:
    """Device busy ms, device kernels and wall s of one profiled ``fn()``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = _timed_run(torch, fn)
    kernels = _device_kernels(torch, prof).values()
    return sum(ns for _, ns in kernels) / 1e6, sum(n for n, _ in kernels), wall


def _compaction_cost(torch, kern, args) -> None:
    """One lane compaction of the full-width NUTS state: time per call
    (CUDA events), device time (profiled) and the bytes it must move."""
    from repro_torch.core import ir

    vm = kern._last_executor.vm
    inputs, _ = kern._bind(args)
    state = vm.init_state({ir.qualify(kern.main, k): v for k, v in inputs.items()})
    lane_major = [state[k] for k in ("pc_top", "pc_ptr", "depth_exceeded", "lane_steps",
                                     "lane_ids", "pc_stack")]
    for group in ("tops", "ptrs", "stacks"):
        lane_major += list(state[group].values())
    nbytes = 2 * sum(t.numel() * t.element_size() for t in lane_major)
    call = _call_ms(torch, lambda: vm._compact(state), iters=50)
    dev_ms, kernels, _ = _busy(torch, lambda: [vm._compact(state) for _ in range(10)])
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"paper: one compaction at {CHAINS} lanes: {len(lane_major)} tensors, "
          f"{nbytes / 1e6:.1f} MB moved; device {dev_ms / 10 * 1e3:.1f} us in "
          f"{kernels // 10} kernels, call {call * 1e3:.1f} us, byte bound {bound * 1e3:.1f} us")


def phase_paper(torch, settings) -> None:
    """Fig. 5's arms at full width and Fig. 6 at ``--full``, batch 64."""
    from repro_torch.core import ir
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.mcmc import iterative, nuts, targets

    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_fig6

    t_phase = time.perf_counter()
    gpl = settings.grads_per_leaf
    target = targets.logistic_regression(num_data=10_000, dim=100, device="cuda")
    args = nuts.initial_state(target, CHAINS, eps=0.01, seed=0, device="cuda")
    print(f"paper: Fig. 5 arms, logistic_regression(10000, 100), {settings}, eps 0.01")

    def report(arm, z, grads, wall, dispatches, what, occupancy):
        print(f"paper: {arm:22s} {z:5d} chains: {grads / wall:12.1f} grads/s, wall "
              f"{wall:.3f} s, {dispatches} {what} at {wall / dispatches * 1e3:.3f} ms "
              f"each, occupancy {occupancy:.4f}")

    outs = {}
    for schedule, ce in PC_ARMS:
        arm = f"pc[{schedule}" + (f",ce{ce}]" if ce else "]")
        kern = nuts.make_nuts_kernel(target, settings, schedule=schedule, compact_every=ce,
                                     device="cuda")
        kern(*args)  # warm-up
        ops.masked_push.launches = ops.masked_peek.launches = 0
        outs[arm], wall = _timed_run(torch, lambda: kern(*args))
        push, peek = ops.masked_push.launches, ops.masked_peek.launches
        res, st = kern.last_result, kern.scheduler_stats
        check(res.converged, f"{arm} did not converge")
        per_push = [_group_launches(blk, ir.LPush, ir.LPushJump) for blk in kern.lowered.blocks]
        per_peek = [_group_launches(blk, ir.LPop, ir.LReturn) for blk in kern.lowered.blocks]
        if schedule == "sweep":
            runs = [res.steps] * len(per_push)  # every block, every iteration
        else:
            runs = [int(n) for n in res.block_exec]
        want = (sum(n * k for n, k in zip(runs, per_push)),
                sum(n * k for n, k in zip(runs, per_peek)))
        check((push, peek) == want, f"{arm}: K1/K2 launches {(push, peek)} != {want}")
        _, active = res.tag_stats["grad"]
        what = "sweeps" if schedule == "sweep" else "dispatches"
        report(arm, CHAINS, active * gpl, wall, res.steps, what, st.mean_occupancy)
        dev_ms, kernels, prof_wall = _busy(torch, lambda: kern(*args))
        print(f"paper: {arm}: lane occupancy {st.mean_lane_occupancy:.4f}, block runs "
              f"with residents {int(res.block_exec.sum())}, masked updates "
              f"{st.masked_updates}, K1/K2 launches {push}/{peek} (= {want}); profiled "
              f"run: device busy {dev_ms:.3f} ms of {prof_wall * 1e3:.3f} ms "
              f"({dev_ms / 1e3 / prof_wall:.4f}), {kernels} kernels")
        if ce:
            _compaction_cost(torch, kern, args)
    base = outs["pc[earliest]"]
    for arm, out in outs.items():
        same = all(torch.equal(out[k], base[k]) for k in base)
        err = max(float((out[k] - base[k]).abs().max()) for k in base)
        check(same, f"{arm} differs from pc[earliest] (max |diff| {err:.3g})")
    print(f"paper: the {len(outs)} pc arms are bit-identical")
    for k, v in base.items():
        check(tuple(v.shape) == (CHAINS, 100) and bool(torch.isfinite(v).all()),
              f"pc {k}: shape {tuple(v.shape)} or non-finite values")

    run_it = iterative.make_batched(target, settings, device="cuda")
    run_it(*args)  # warm-up
    out, wall = _timed_run(torch, lambda: run_it(*args))
    grads, iters = int(out["grads"].sum()), run_it.chain.iterations
    for k in ("theta", "sum_theta", "sum_sq"):
        check(bool(torch.isfinite(out[k]).all()), f"iterative {k} not finite")
    report("iterative", CHAINS, grads, wall, iters, "leaf steps", grads / (gpl * iters * CHAINS))
    dev_ms, kernels, prof_wall = _busy(torch, lambda: run_it(*args))
    print(f"paper: iterative: profiled run: device busy {dev_ms:.3f} ms of "
          f"{prof_wall * 1e3:.3f} ms ({dev_ms / 1e3 / prof_wall:.4f}), {kernels} kernels")

    local_args = tuple(a[:LOCAL_CHAINS] if a.dim() else a for a in args)
    if LOCAL_CHAINS != CHAINS:
        print(f"paper: cut: local and local_eager run {LOCAL_CHAINS} chains, not {CHAINS}")
    local_outs, local_tags = {}, {}
    for backend in ("local", "local_eager"):
        kern = nuts.make_nuts_kernel(target, settings, backend=backend, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        _, first = _timed_run(torch, lambda: kern(*local_args))
        peak = torch.cuda.max_memory_allocated() / 2**20
        local_outs[backend], wall = _timed_run(torch, lambda: kern(*local_args))
        local_tags[backend] = kern.tag_stats
        execs, active = kern.tag_stats["grad"]
        st = kern.local_stats
        report(backend, LOCAL_CHAINS, active * gpl, wall, st.block_execs, "blocks",
               active / (execs * LOCAL_CHAINS))
        dev_ms, kernels, prof_wall = _busy(torch, lambda: kern(*local_args))
        print(f"paper: {backend}: first call {first:.2f} s"
              + (" (captures the graphs)" if backend == "local" else "")
              + f", peak memory {peak:.1f} MiB, {st.primitive_execs} primitive executions; "
              f"profiled run: device busy {dev_ms:.3f} ms of {prof_wall * 1e3:.3f} ms "
              f"({dev_ms / 1e3 / prof_wall:.4f}), {kernels} kernels")
    check(local_tags["local"] == local_tags["local_eager"], "local and local_eager counted "
          f"differently: {local_tags}")
    for k, v in local_outs["local_eager"].items():
        check(torch.equal(local_outs["local"][k], v), f"local {k} != local_eager {k}")
    pc_same = all(torch.equal(local_outs["local"][k], base[k][:LOCAL_CHAINS]) for k in base)
    print(f"paper: local equals local_eager bit for bit; equal to pc[earliest]: {pc_same}")

    one = tuple(a[:UNBATCHED_CHAINS] if a.dim() else a for a in args)
    print(f"paper: cut: unbatched runs {UNBATCHED_CHAINS} chain (the reference interpreter)")
    counter = nuts.make_nuts_kernel(target, settings, device="cuda")
    want = counter(*one)
    _, active = counter.tag_stats["grad"]
    ref = nuts.make_nuts_kernel(target, settings, backend="reference", device="cuda")
    out, wall = _timed_run(torch, lambda: ref(*one))
    err = max(float((out[k] - want[k]).abs().max()) for k in want)
    check(all(bool(torch.isfinite(v).all()) for v in out.values()), "unbatched not finite")
    print(f"paper: {'unbatched':22s} {UNBATCHED_CHAINS:5d} chains: "
          f"{active * gpl / wall:12.1f} grads/s, wall {wall:.3f} s; max |diff| from the pc "
          f"VM on the same chain {err:.3g}")

    # fig6_utilization --full, its num_steps 10 cut to 3 for the time limit.
    full6 = dict(dim=100, num_steps=3, max_tree_depth=10)
    t0 = time.perf_counter()
    _, (rec,) = torch_fig6.utilization_sweep([64], device="cuda", **full6)
    check(0 < rec["local"] <= rec["pc"]["pc"] <= 1, f"Fig. 6 utilizations {rec}")
    print(f"paper: Fig. 6, correlated_gaussian(100, 0.95), {full6}, eps 0.1, 64 chains: "
          f"grad utilization pc {rec['pc']['pc']:.4f}, local {rec['local']:.4f}, ratio "
          f"{rec['ratio']:.3f} ({time.perf_counter() - t0:.1f} s)")
    print(f"paper: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 11. segments and faults on the card
# ---------------------------------------------------------------------------


def phase_segments(torch, run6: dict, launches6: dict) -> None:
    """Phase 6's NUTS in segments; the chaos matrix; an overflow that halts."""
    from repro_torch.core import batching, pc_vm
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.testing import build_fib

    sys.path.insert(0, str(ROOT))
    from tools import torch_chaos

    t_phase = time.perf_counter()
    kern, args = run6["kern"], run6["args"]
    st = kern.stepper(*args)
    state = st.init()
    ops.masked_push.launches = ops.masked_peek.launches = 0
    segments = 0
    t0 = time.perf_counter()
    while not st.done(state):
        state = st.step(state, 7)
        segments += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    push, peek = ops.masked_push.launches, ops.masked_peek.launches
    out, res, want = st.result(state), st.vm.result(state), run6["res"]
    for k, v in run6["out"].items():
        check(torch.equal(out[k], v), f"segmented NUTS {k} differs from phase 6's run")
    check(res.steps == want.steps, f"segmented NUTS ran {res.steps} dispatches, not {want.steps}")
    check(np.array_equal(res.block_exec, want.block_exec), "segmented NUTS block_exec differs")
    check((push, peek) == (launches6["masked_push"], launches6["masked_peek"]),
          f"segmented NUTS K1/K2 launches {(push, peek)} != phase 6's "
          f"{(launches6['masked_push'], launches6['masked_peek'])}")
    check(not res.fault_code.any(), "segmented NUTS reported faults")
    print(f"segments: NUTS {CHAINS} chains in {segments} segments of 7 dispatches: "
          f"bit-identical to phase 6 (outputs, {res.steps} dispatches, block_exec, K1/K2 "
          f"launches {push}/{peek}); wall {wall:.3f} s")

    t0 = time.perf_counter()
    records = torch_chaos.run_matrix(batch=64, rate=0.25, seed=0, device="cuda")
    for r in records:
        check(r["ok"], f"chaos cell {r['schedule']} fuse={r['fuse']}: {r['violations']}")
    print(f"segments: chaos matrix, batch 64, {len(records)} cells (schedule x fuse), "
          f"{records[0]['injected']} injected: every code as injected, healthy lanes "
          f"bit-exact; dispatches {[r['steps'] for r in records]} "
          f"({time.perf_counter() - t0:.1f} s)")

    n = np.random.default_rng(1).integers(0, 11, 9).astype(np.int32)
    fn = batching.autobatch(build_fib(), max_depth=5, on_fault="quarantine",
                            lane_step_budget=10_000, device="cuda")
    fn(torch.from_numpy(n).cuda())
    res = fn.last_result
    codes = res.fault_code.cpu().numpy()
    check(res.converged and res.steps < fn.max_steps, "the overflow program did not halt")
    check(codes.any() and bool((codes[codes != 0] == pc_vm.FAULT_STACK_OVERFLOW).all()),
          f"overflow codes {codes}")
    check(np.array_equal(codes != 0, res.depth_exceeded.cpu().numpy()),
          "overflow codes and depth_exceeded disagree")
    print(f"segments: fib({n.tolist()}) at max_depth=5, quarantine, lane_step_budget=10000, "
          f"no max_steps bound: halted after {res.steps} dispatches, lanes "
          f"{np.flatnonzero(codes).tolist()} stack_overflow")
    print(f"segments: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 12. open-loop serving at full width
# ---------------------------------------------------------------------------


#: Phase 12's burst, the first requests of this seeded draw, the Poisson
#: arrivals behind it (phase 19's too) and its profiled run's (cut from
#: 128 each for the smoke's time limit).
SERVE_BURST, SERVE_POISSON, SERVE_PROFILED = 64, 32, 8


def _requests(engine_mod, n: int, lo: int, hi: int, vocab: int, seed: int, arrivals=None):
    rng = np.random.default_rng(seed)
    return [engine_mod.Request(rid=i, prompt=rng.integers(1, vocab, int(rng.integers(lo, hi + 1)))
                               .astype(np.int32),
                               arrival=0.0 if arrivals is None else float(arrivals[i]))
            for i in range(n)]


def _overload(engine_mod, vocab: int, arrivals) -> list:
    """Phase 12's burst at t=0 and, behind it, its first prompts again as
    new requests arriving at ``arrivals``: they queue while the burst holds
    every lane and go to the lanes it retires."""
    burst = _requests(engine_mod, SERVE_BURST, 2, 64, vocab, seed=14)
    return burst + [engine_mod.Request(rid=SERVE_BURST + i, prompt=r.prompt, arrival=float(a))
                    for i, (r, a) in enumerate(zip(burst, arrivals))]


def _refills(comps) -> int:
    """Completions served on a lane that an earlier request had retired."""
    return len(comps) - len({c.lane for c in comps})


def _latency(comps) -> tuple[float, float]:
    """p50 and p99 latency of one ``serve()`` call's ok completions (the
    engine's own figures aggregate every call made on its registry)."""
    p50, p99 = np.percentile([c.latency for c in comps if c.status == "ok"], (50, 99))
    return float(p50), float(p99)


def _clock(tick: float):
    t = {"now": 0.0}

    def now():
        t["now"] += tick
        return t["now"]

    return now


def phase_serve(torch) -> tuple[int, dict]:
    """Open-loop serving of SmolLM-135M; returns K4's launches in the
    measured burst run and the Poisson run's arrivals, tokens by request
    and figures (phase 19 holds the sharded engine to them)."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import get_model
    from repro_torch.serve import engine as E

    t_phase = time.perf_counter()
    cfg = configs.get_config(ARCH)
    params = get_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))

    # Check: float32 (TF32 off), 4 lanes, 8 requests arriving over a
    # virtual clock and a hog (a 16-token prompt among 2..8-token ones)
    # under a lane step budget between the hog's and the longest healthy
    # request's step counts, measured one request at a time; every healthy
    # completion is held to the oracle, request by request.
    t0 = time.perf_counter()
    model32 = get_model(replace(cfg, compute_dtype="float32"), device="cuda")
    kw = dict(lanes=4, max_context=64, max_prompt_len=16, max_new_tokens=16,
              requests_per_lane=1, eos_id=0, segment_steps=16)
    reqs = _requests(E, 8, 2, 8, cfg.vocab_size, seed=13, arrivals=np.arange(8) * 1.5)
    hog = E.Request(rid=8, prompt=np.full((16,), 7, np.int32), arrival=2.0)
    one = E.GenerationEngine(model32, params, E.EngineConfig(**dict(kw, lanes=1)))
    steps = []
    for r in (max(reqs, key=lambda r: len(r.prompt)), hog):
        one.serve([E.Request(rid=0, prompt=r.prompt)])
        steps.append(int(one.last_serve_result.lane_steps[0]))
    check(steps[0] < steps[1], f"hog lane steps {steps[1]} not above the healthy {steps[0]}")
    budget = sum(steps) // 2
    eng = E.GenerationEngine(model32, params, E.EngineConfig(**kw, lane_step_budget=budget))
    comps, stats = eng.serve(reqs + [hog], now_fn=_clock(1.0))
    t_serve = time.perf_counter() - t0
    oracle = E.GenerationEngine(model32, params, E.EngineConfig(**dict(kw, lanes=len(reqs))))
    prompts = np.zeros((len(reqs), 1, 16), np.int32)
    plens = np.zeros((len(reqs), 1), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, 0, : len(r.prompt)] = r.prompt
        plens[i, 0] = len(r.prompt)
    ref = oracle.reference_generate(prompts, plens)
    by = {c.rid: c for c in comps}
    check((by[8].status, by[8].fault) == ("faulted", "watchdog"),
          f"hog resolved {by[8].status} ({by[8].fault})")
    for r in reqs:
        c = by[r.rid]
        check(c.status == "ok" and np.array_equal(
            c.tokens, ref["tokens"][c.rid, 0, : ref["lengths"][c.rid, 0]]),
              f"serve check: request {c.rid} ({c.status}) != the sequential oracle")
    print(f"serve check: {ARCH} full width float32, 4 lanes, 8 requests arriving every 1.5 "
          f"ticks of a virtual clock and a 16-token hog under lane_step_budget={budget} "
          f"(lane steps: longest healthy {steps[0]}, hog {steps[1]}): the hog faulted "
          f"(watchdog), every healthy completion equal to the sequential oracle "
          f"({stats.generated_tokens} tokens, {stats.segments} segments, {stats.vm_steps} "
          f"dispatches, lanes {sorted({c.lane for c in comps})}; serving {t_serve:.1f} s, "
          f"oracle {time.perf_counter() - t0 - t_serve:.1f} s)")

    # Measure: bf16, 64 lanes, 64 requests (cut from 128).
    ecfg = E.EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                          requests_per_lane=1, eos_id=0, segment_steps=16)
    eng = E.GenerationEngine(get_model(cfg, device="cuda"), params, ecfg)
    burst = _requests(E, SERVE_BURST, 2, 64, cfg.vocab_size, seed=14)
    t0 = time.perf_counter()
    eng.serve(burst[:8])
    torch.cuda.synchronize()
    print(f"serve: warm-up (8 requests, type inference included) "
          f"{time.perf_counter() - t0:.2f} s")

    def measured(what, reqs):
        fd_ops.decode_attention.launches = 0
        torch.cuda.synchronize()
        comps, st = eng.serve(reqs)
        torch.cuda.synchronize()
        launches = fd_ops.decode_attention.launches
        res = eng.last_serve_result
        execs, active = res.tag_stats["decode"]
        check(launches == cfg.num_layers * execs,
              f"{what}: K4 launched {launches} times, want {cfg.num_layers} x {execs}")
        statuses = {s: getattr(st, s) for s in E.COMPLETION_STATUSES}
        check(statuses["ok"] == len(reqs), f"{what}: statuses {statuses}")
        check(all(0 < c.tokens.size <= 64 for c in comps), f"{what}: token counts")
        p50, p99 = _latency(comps)
        print(f"serve: {ARCH} full width bf16, 64 lanes, {what}: wall {st.wall_time:.3f} s, "
              f"{st.generated_tokens} tokens, {st.generated_tokens / st.wall_time:.1f} "
              f"tokens/s, {len(reqs) / st.wall_time:.2f} completions/s {statuses}, latency "
              f"p50 {p50:.3f} s p99 {p99:.3f} s, {st.segments} "
              f"segments, {st.vm_steps} dispatches, {st.wall_time / st.vm_steps * 1e3:.3f} "
              f"ms/dispatch, lane occupancy {st.occupancy:.4f} a segment "
              f"({res.sched.mean_lane_occupancy:.4f} a dispatch), decode executions "
              f"{execs}, K4 launches {launches}, lanes refilled {_refills(comps)}")
        record = dict(tokens={c.rid: c.tokens for c in comps},
                      tok_s=st.generated_tokens / st.wall_time, steps=st.vm_steps,
                      wall=st.wall_time, refills=_refills(comps))
        return st, launches, record

    bstats, launches, _ = measured(f"{len(burst)} requests at t=0", burst)
    rate = 0.5 * len(burst) / bstats.wall_time
    arrivals = np.cumsum(np.random.default_rng(15).exponential(1.0 / rate, SERVE_POISSON))
    _, _, overload = measured(
        f"the burst and {SERVE_POISSON} Poisson arrivals at {rate:.2f}/s behind it",
        _overload(E, cfg.vocab_size, arrivals))
    tokens = overload["tokens"]
    check(overload["refills"] > 0 and all(
        np.array_equal(tokens[SERVE_BURST + i], tokens[i]) for i in range(SERVE_POISSON)),
          f"the overload run refilled {overload['refills']} lanes, or a prompt served again on "
          "a refilled lane gave other tokens")
    overload["arrivals"] = arrivals.tolist()
    first = burst[:SERVE_PROFILED]

    # The profiled burst: the first SERVE_PROFILED requests (processing the
    # profile of 128, ~595k kernels, took about 100 s; of 8, 25 s).
    t0 = time.perf_counter()
    dev_ms, kernels, wall = _busy(torch, lambda: eng.serve(first))
    steps = eng.last_serve_result.steps
    print(f"serve: profiled burst of {len(first)} requests: device busy {dev_ms:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall ({dev_ms / 1e3 / wall:.4f} busy share), {kernels} "
          f"kernels ({kernels / steps:.1f} per dispatch); with the profile's processing "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"serve: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, overload


# ---------------------------------------------------------------------------
# 13. verify, trace, PGO
# ---------------------------------------------------------------------------


def _groups_exact(torch, vm, depth: int, lanes: int) -> int:
    """Every distinct stack group of ``vm`` (by kind, stacks and pc)
    against ``ref.push_group``/``pop_group`` on seeded operands at the
    VM's lanes, exactly; returns how many were checked."""
    from repro_torch.kernels.stack_ops import ref
    from repro_torch.testing import stack_group_inputs, to_torch

    dev = torch.device("cuda")
    seen = {}
    for groups in vm.stack_groups:
        for g in groups:
            seen.setdefault((g.kind, g.pc, tuple(g.call.specs)), g)
    for i, g in enumerate(seen.values()):
        np_entries, np_mask = stack_group_inputs(g.call.specs, lanes, 40 + i)
        entries = [(to_torch(st, sp.dtype, dev), torch.from_numpy(p).to(dev),
                    to_torch(t, sp.dtype, dev), to_torch(src, sp.dtype, dev))
                   for (st, p, t, src), sp in zip(np_entries, g.call.specs)]
        if g.pc:  # the pc push has no src
            entries[-1] = entries[-1][:3] + (None,)
        mask = torch.from_numpy(np_mask).to(dev)
        if g.kind == "push":
            clone = [(st.clone(), p, t, src) for st, p, t, src in entries]
            flags = torch.zeros(lanes, dtype=torch.bool, device=dev)
            want_flags = flags.clone()
            got = g.call(entries, mask, flags, depth)
            want = ref.push_group(clone, mask, want_flags, depth)
            ok = torch.equal(flags, want_flags) and all(
                torch.equal(entries[j][0], clone[j][0]) and torch.equal(got[0][j], want[0][j])
                and (got[1][j] is None) == (want[1][j] is None)
                and (got[1][j] is None or torch.equal(got[1][j], want[1][j]))
                for j in range(len(entries)))
        else:
            pops = [(st, p, t) for st, p, t, _ in entries]
            got, want = g.call(pops, mask), ref.pop_group(pops, mask)
            ok = all(torch.equal(got[0][j], want[0][j]) and torch.equal(got[1][j], want[1][j])
                     for j in range(len(pops)))
        check(ok, f"PGO'd stack group {g.kind} of {len(g)} stacks (pc={g.pc}) != plain version")
    torch.cuda.synchronize()
    return len(seen)


def _block_profile_ms(torch, fn) -> tuple[float, float, dict, list]:
    """One ``fn()`` profiled on the host and the card: device busy ms, wall
    s, the device kernels by name (device events only, the scopes' own
    device spans left out), and (ms, name) of the ``pcvm.block<i>`` scopes
    by the device time of the kernels they launched, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = _timed_run(torch, fn)
    busy, kernels, blocks = 0.0, {}, {}
    for e in prof.events():
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        if e.name.startswith("pcvm.block"):
            if not on_device:
                blocks[e.name] = blocks.get(e.name, 0.0) + e.device_time_total / 1e3
        elif on_device and e.self_device_time_total > 0:
            busy += e.self_device_time_total / 1e3
            kernels[e.name] = kernels.get(e.name, 0) + 1
    return busy, wall, kernels, sorted(((ms, n) for n, ms in blocks.items()), reverse=True)


def phase_pgo(torch, run6: dict, launches6: dict, settings, smi: str) -> None:
    """Verify, trace and PGO on phase 6's NUTS, and trace the engine."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.core import ir
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.models import get_model
    from repro_torch.obs import block_profile, format_profile, validate_perfetto, write_perfetto
    from repro_torch.serve.engine import EngineConfig, GenerationEngine
    from repro_torch.testing import engine_inputs

    t_phase = time.perf_counter()
    kern, args, out6, res6 = run6["kern"], run6["args"], run6["out"], run6["res"]
    gpl = settings.grads_per_leaf

    # Verify: the NUTS lowering, and the engine's (its decode prim reaches
    # K4, which answers fake tensors by its shape rule and launches nothing).
    t0 = time.perf_counter()
    vlow = kern.with_options(verify=True).lowered
    check(len(vlow.blocks) == len(kern.lowered.blocks), "verified NUTS lowering differs")
    t_nuts = time.perf_counter() - t0
    cfg = configs.get_config(ARCH)
    params = get_model(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(1))
    ecfg = EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(get_model(cfg, device="cuda"), params, ecfg)
    fd_ops.decode_attention.launches = 0
    t0 = time.perf_counter()
    elow = eng.batched.with_options(verify=True).lowered
    k4 = fd_ops.decode_attention.launches
    check(k4 == 0, f"typing the engine's program launched K4 {k4} times")
    print(f"pgo: verify=True lowering on the card: NUTS {len(vlow.blocks)} blocks in "
          f"{t_nuts:.2f} s; {ARCH} engine (bf16, 64 lanes) {len(elow.blocks)} blocks in "
          f"{time.perf_counter() - t0:.2f} s, K4 launches while typing: {k4} (shape rule)")

    # Traced run: bit-identical to phase 6, the ring drained once.
    traced = kern.with_options(trace=True)
    ops.masked_push.launches = ops.masked_peek.launches = 0
    out, wall = _timed_run(torch, lambda: traced(*args))
    push, peek = ops.masked_push.launches, ops.masked_peek.launches
    res = traced.last_result
    for k, v in out6.items():
        check(torch.equal(out[k], v), f"traced NUTS {k} differs from phase 6's run")
    check(res.steps == res6.steps and np.array_equal(res.block_exec, res6.block_exec),
          "traced NUTS dispatches or block_exec differ from phase 6's")
    check((push, peek) == (launches6["masked_push"], launches6["masked_peek"]),
          f"traced NUTS K1/K2 launches {(push, peek)} != phase 6's")
    tr = traced.last_trace
    check(len(tr) == res.steps and tr.dropped == 0, f"trace holds {len(tr)} of {res.steps}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "phase13_nuts_trace.json"
    write_perfetto(str(path), tr)
    n_ev = validate_perfetto(str(path))
    prof = block_profile(tr)
    _, kern_t, _ = _busy(torch, lambda: traced(*args))
    print(f"pgo: traced NUTS bit-identical to phase 6 (outputs, {res.steps} dispatches, "
          f"block_exec, K1/K2 {push}/{peek}); wall {wall:.3f} s; {n_ev} Perfetto events "
          f"valid -> chiprun_out/{path.name}; kernels a dispatch {kern_t / res.steps:.2f} "
          f"traced against phase 6's {run6['kpd']:.2f} untraced "
          f"({kern_t / res.steps - run6['kpd']:+.2f}; {time.perf_counter() - t_phase:.1f} s)")
    print(format_profile(prof))

    # PGO: re-lower through the profile-guided passes.
    t0 = time.perf_counter()
    opt = kern.optimize(prof)
    opt(*args)  # warm-up: the lowering and the VM
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    vm = opt._last_executor.vm
    n_groups = _groups_exact(torch, vm, vm.config.max_depth, CHAINS)
    ops.masked_push.launches = ops.masked_peek.launches = 0
    out, wall_o = _timed_run(torch, lambda: opt(*args))
    push_o, peek_o = ops.masked_push.launches, ops.masked_peek.launches
    res_o, st6, st_o = opt.last_result, kern.scheduler_stats, opt.scheduler_stats
    for k, v in out6.items():
        check(torch.equal(out[k], v), f"PGO'd NUTS {k} differs from phase 6's run")
    blocks = opt.lowered.blocks
    want = tuple(sum(int(n) * _group_launches(blk, op, term)
                     for n, blk in zip(res_o.block_exec, blocks))
                 for op, term in ((ir.LPush, ir.LPushJump), (ir.LPop, ir.LReturn)))
    check((push_o, peek_o) == want, f"PGO'd K1/K2 launches {(push_o, peek_o)} != {want} "
          "from block_exec x groups")
    check(st_o.steps < st6.steps and st_o.masked_updates < st6.masked_updates,
          f"PGO did not cut dispatches ({st6.steps} -> {st_o.steps}) and masked updates "
          f"({st6.masked_updates} -> {st_o.masked_updates})")
    layout = opt.lowered.state_layout
    print(f"pgo: optimize (lowering, VM, first run) {t_opt:.2f} s; blocks {st6.num_blocks} -> "
          f"{st_o.num_blocks} ({len(layout.groups) if layout else 0} layout groups), "
          f"dispatches {st6.steps} -> {st_o.steps}, masked updates {st6.masked_updates} -> "
          f"{st_o.masked_updates}, K1/K2 launches {launches6['masked_push']}/"
          f"{launches6['masked_peek']} -> {push_o}/{peek_o} (= block_exec x groups); "
          f"outputs bit-identical to phase 6; {n_groups} distinct stack groups exact "
          f"against the plain versions ({time.perf_counter() - t_phase:.1f} s)")

    # Speed in turns, then one profiled run of each.
    grads = {}
    for name, fn in (("phase 6", kern), ("pgo", opt), ("pgo", opt), ("phase 6", kern)):
        _, w = _timed_run(torch, lambda: fn(*args))
        grads.setdefault(name, []).append(fn.tag_stats["grad"][1] * gpl / w)
    print(f"pgo: grads/s in turns (A B B A) on {smi}: phase 6 "
          f"{', '.join(f'{g:.1f}' for g in grads['phase 6'])}; pgo "
          f"{', '.join(f'{g:.1f}' for g in grads['pgo'])}")
    names = {}
    for name, fn, steps in (("phase 6", kern, st6.steps), ("pgo", opt, st_o.steps)):
        busy, w, by_name, top = _block_profile_ms(torch, lambda: fn(*args))
        names[name] = by_name
        nk = sum(by_name.values())
        shown = ", ".join(f"{n[len('pcvm.'):]} {ms:.3f}" for ms, n in top[:5]) or "not measured"
        in_blocks = sum(ms for ms, _ in top)
        print(f"pgo: profiled {name} (host and card): device busy {busy:.3f} ms of "
              f"{w * 1e3:.3f} ms wall ({busy / 1e3 / w:.4f}); {nk} kernels ({nk / steps:.2f} a "
              f"dispatch); {in_blocks:.3f} ms inside pcvm.block scopes; top blocks by device "
              f"ms: {shown} ({time.perf_counter() - t_phase:.1f} s)")
    delta = {k: names["pgo"].get(k, 0) - names["phase 6"].get(k, 0)
             for k in set(names["pgo"]) | set(names["phase 6"])}
    moved = sorted(delta.items(), key=lambda kv: -abs(kv[1]))[:6]
    print("pgo: kernel launches pgo - phase 6 by name: "
          + "; ".join(f"{d:+d} {k[:60]}" for k, d in moved if d))

    # The engine traced: equal to the untraced engine.
    model32 = get_model(replace(cfg, compute_dtype="float32"), device="cuda")
    ecfg = EngineConfig(lanes=4, max_context=64, max_prompt_len=16, max_new_tokens=16,
                        requests_per_lane=2, eos_id=0)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=11)
    plain = GenerationEngine(model32, params, ecfg).generate(prompts, plens)
    teng = GenerationEngine(model32, params, replace(ecfg, trace=True))
    fd_ops.decode_attention.launches = 0
    got = teng.generate(prompts, plens)
    etr = teng.batched.last_trace
    execs = teng.batched.tag_stats["decode"][0]
    check(np.array_equal(got["tokens"], plain["tokens"]), "traced engine tokens differ")
    check(etr is not None and len(etr) == teng.batched.last_result.steps, "engine trace")
    check(fd_ops.decode_attention.launches == cfg.num_layers * execs, "traced engine K4 count")
    print(f"pgo: traced engine ({ARCH} float32, 4 lanes x 2 requests): tokens equal to the "
          f"untraced engine, {len(etr)} dispatches traced, K4 launches "
          f"{fd_ops.decode_attention.launches} = {cfg.num_layers} x {execs}")
    print(f"pgo: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 14. the restricted-Python frontend and the pytree API
# ---------------------------------------------------------------------------

FRONTEND_LANES = 65_536


def _collatz_numpy(n: np.ndarray, bound: int) -> tuple[np.ndarray, np.ndarray]:
    """``collatz``'s steps and peaks with a vectorized numpy loop."""
    n = n.astype(np.int64)
    steps, peak = np.zeros_like(n), n.copy()
    live = (n > 1) & (steps < bound)
    while live.any():
        n = np.where(live, np.where(n % 2 == 0, n // 2, 3 * n + 1), n)
        peak = np.where(live, np.maximum(peak, n), peak)
        steps = steps + live
        live = (n > 1) & (steps < bound)
    return steps, peak


def phase_frontend(torch, run6: dict, smi: str) -> None:
    """The quickstart's decorated and builder handles on the card, the
    NUTS kernel's executor cache, and the four backends on one program."""
    import importlib.util

    from repro_torch.core import batching
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.testing import build_fib

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    gen = torch.Generator().manual_seed(14)

    # Decorated fib against the builder's, over 65,536 lanes.
    n = torch.randint(0, 13, (FRONTEND_LANES,), generator=gen, dtype=torch.int32).cuda()
    dec = qs.fib.with_options(max_depth=16, device="cuda")
    built = batching.autobatch(build_fib(), max_depth=16, device="cuda")
    dec(n)  # warm-up: the frontend's trace, the lowering and the VM
    ops.masked_push.launches = ops.masked_peek.launches = 0
    out, wall = _timed_run(torch, lambda: dec(n))
    push, peek = ops.masked_push.launches, ops.masked_peek.launches
    want = built(n)["out"]
    res, res_b = dec.last_result, built.last_result
    check(torch.equal(out, want), "decorated fib differs from the builder's fib")
    check(res.steps == res_b.steps and np.array_equal(res.block_exec, res_b.block_exec),
          f"decorated fib dispatches {res.steps} != builder's {res_b.steps} (or block_exec)")
    check(push > 0 and peek > 0, f"decorated fib launched K1/K2 {push}/{peek} times")
    check(dec.cache_info().traces == 1, f"decorated fib traced {dec.cache_info().traces} times")
    print(f"frontend: decorated fib, {FRONTEND_LANES} lanes, n in [0, 13), max_depth 16: "
          f"bit-exact with the builder's fib ({res.steps} dispatches, block_exec equal); "
          f"wall {wall * 1e3:.1f} ms, {wall / res.steps * 1e3:.3f} ms/dispatch, K1/K2 "
          f"launches {push}/{peek} on {smi}")

    # Collatz (builder, Shared bound) against numpy.
    x = torch.randint(1, 100_000, (FRONTEND_LANES,), generator=gen, dtype=torch.int32)
    col = qs.collatz.with_options(device="cuda")
    col(x, np.int32(1000))
    got, wall_c = _timed_run(torch, lambda: col(x, np.int32(1000)))
    steps, peak = _collatz_numpy(x.numpy(), 1000)
    check(np.array_equal(got["steps"].cpu().numpy(), steps), "collatz steps differ from numpy")
    check(np.array_equal(got["peak"].cpu().numpy(), peak), "collatz peaks differ from numpy")
    print(f"frontend: collatz, {FRONTEND_LANES} lanes, n in [1, 100000), Shared bound 1000: "
          f"steps and peaks equal to numpy (max {steps.max()} steps); "
          f"{col.last_result.steps} dispatches, wall {wall_c * 1e3:.1f} ms on {smi}")

    # Phase 6's NUTS (batch_size=1024) again at the same avals: a cache hit.
    kern, args = run6["kern"], run6["args"]
    before = kern.cache_info()
    again, wall_n = _timed_run(torch, lambda: kern(*args))
    after = kern.cache_info()
    for k, v in run6["out"].items():
        check(torch.equal(again[k], v), f"NUTS {k} differs from phase 6's run")
    check(after.hits == before.hits + 1 and after.misses == before.misses
          and after.lowerings == 1 and after.entries == 1,
          f"NUTS cache {before} -> {after}: want one more hit, one lowering, one entry")
    print(f"frontend: phase 6's NUTS (batch_size={kern.batch_size}) again: bit-identical, "
          f"cache {after}; wall {wall_n:.3f} s on {smi}")

    # fib(10) on the four backends.
    results = {}
    for backend in ("pc", "local", "local_eager", "reference"):
        lanes = 8 if backend == "reference" else CHAINS
        fn = batching.autobatch(dec.program, backend=backend, max_depth=16, device="cuda")
        got, w = _timed_run(torch, lambda: fn(torch.full((lanes,), 10, dtype=torch.int32)))
        vals = got["out"].cpu()
        check(bool((vals == 55).all()), f"fib(10) on {backend} gave {vals.unique().tolist()}")
        results[backend] = f"{lanes} lanes {w * 1e3:.1f} ms"
    print("frontend: fib(10) = 55 on every backend (first call, incl. set-up): "
          + "; ".join(f"{b} {r}" for b, r in results.items()) + f" on {smi}")
    print(f"frontend: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 15. training
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 2048, 8, 2  # cut from train_4k's 4,096 x 256
# Cut from 40 steps (a failure at 25), then 15 (at 12), for the smoke's
# time limit.
TRAIN_STEPS, TRAIN_SAVE_EVERY, TRAIN_FAIL_AT = 10, 5, 7
TRAIN_TIMED = 3  # steps in the timed window (cut from 5 for the time limit)


def _train_flops(cfg, seq: int, batch: int) -> float:
    """The FLOPs one training step must do: forward and backward (3 x the
    forward) of every weight product and of causal attention (half the
    score matrix), at 2 FLOPs a multiply-add; no recompute counted."""
    dh = cfg.resolved_head_dim
    d, h, hk = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    per_layer = d * h * dh + 2 * d * hk * dh + h * dh * d + 3 * d * cfg.d_ff
    weights = cfg.num_layers * per_layer + d * cfg.vocab_size  # tied unembedding
    attn = cfg.num_layers * 2 * seq * seq * h * dh  # QK^T and PV, causal half
    return 3 * (2 * weights * seq * batch + attn * batch)


def _kernel_launches() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.stack_ops import ops as sk_ops

    return {"masked_push": sk_ops.masked_push.launches, "masked_peek": sk_ops.masked_peek.launches,
            "flash_attention": fa_ops.flash_attention.launches,
            "decode_attention": fd_ops.decode_attention.launches}


def _reset_kernel_launches() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.stack_ops import ops as sk_ops

    sk_ops.masked_push.launches = sk_ops.masked_peek.launches = 0
    fa_ops.flash_attention.launches = fa_ops.flash_attention.sm90_launches = 0
    fd_ops.decode_attention.launches = 0


def _train_serve_resume(torch, params, ckpt_root: Path, smi: str) -> None:
    """Crash-resume of open-loop serving at full width (bf16, pc backend):
    one engine serves the requests uninterrupted, then again with a crash
    of the host loop at the next-to-last completion, then resumes.  Six
    requests on four lanes: the fifth is admitted only after a completion,
    so the newest snapshot before the crash holds done requests, which the
    resume must not serve again."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve import engine as E

    cfg = configs.get_config(ARCH)
    d = ckpt_root / "serve"
    eng = E.GenerationEngine(get_model(cfg, device="cuda"), params, E.EngineConfig(
        lanes=4, max_context=32, max_prompt_len=8, max_new_tokens=8, requests_per_lane=1,
        eos_id=0, segment_steps=8, checkpoint_dir=str(d), checkpoint_every_segments=1))
    reqs = _requests(E, 6, 2, 8, cfg.vocab_size, seed=15)
    t0 = time.perf_counter()
    clean, _ = eng.serve(reqs)
    ref = {c.rid: c.tokens for c in clean}
    shutil.rmtree(d)

    class Crash(Exception):
        pass

    seen = []

    def boom(c):
        seen.append(c)
        if len(seen) == len(reqs) - 1:
            raise Crash

    try:
        eng.serve(reqs, on_finish=boom)
        check(False, "serve crash-resume: the injected crash did not happen")
    except Crash:
        pass
    snap = E.Checkpointer(str(d))
    extra = snap.manifest(snap.latest_step())["extra"]
    done = set(extra["done_rids"])
    comps, stats = eng.serve(reqs, resume=True)
    again, stats2 = eng.serve(reqs, resume=True)
    check({c.rid for c in seen} | {c.rid for c in comps} == {r.rid for r in reqs},
          "serve crash-resume: a request was lost")
    check(done and len(comps) < len(reqs) and not done & {c.rid for c in comps},
          f"serve crash-resume: the snapshot held done {sorted(done)}, the resume served "
          f"{sorted(c.rid for c in comps)}")
    check(all(c.status == "ok" and np.array_equal(c.tokens, ref[c.rid]) for c in comps + seen),
          "serve crash-resume: tokens differ from the uninterrupted run")
    check(again == [] and stats2.completions == 0, "serve: a resume after completion served")
    print(f"train: serve crash-resume, {ARCH} full width bf16, 4 lanes, 6 requests, a crash "
          f"at completion {len(seen)}: the newest snapshot held {len(done)} done and "
          f"{len(extra['active'])} in flight; {len(comps)} served after the resume, none of "
          f"them done before "
          f"(snapshots every segment, {stats.checkpoints} in the resumed run), every token equal to the "
          f"uninterrupted run; a resume after completion served none "
          f"({time.perf_counter() - t0:.1f} s) on {smi}")


def phase_train(torch, smi: str) -> None:
    """Full-width SmolLM-135M training through the launcher and the
    restart loop, with an injected failure; remat policies; a card ->
    CPU checkpoint; crash-resume of serving."""
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch.train import build_trainer
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train import train_step as ts

    t_phase = time.perf_counter()
    ckpt_root = ROOT / "build" / "phase15_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    base_mem = torch.cuda.memory_allocated()
    model, params, opt_state, step, stream = build_trainer(
        ARCH, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, steps=TRAIN_STEPS, lr=1e-3,
        microbatches=TRAIN_MICRO, remat="dots", smoke=False, device="cuda")
    cfg = model.cfg
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    tokens = TRAIN_SEQ * TRAIN_BATCH
    print(f"train: {ARCH} full width ({n_params / 1e6:.2f}M params, {cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.compute_dtype} compute, f32 masters), {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens a step (cut from train_4k's 256 x 4096), {TRAIN_MICRO} "
          f"microbatches, remat dots, AdamW lr 1e-3")

    def step_fn(state, i):
        p, o = state
        p, o, metrics = step(p, o, stream.batch(i))
        return (p, o), metrics

    # The main path: one run of the restart loop with a failure injected
    # after a checkpoint.  Deterministic algorithms are on, so the replayed
    # steps must equal their first pass bit for bit (CUDA's embedding and
    # gather backward otherwise accumulate with atomics).
    fails = {TRAIN_FAIL_AT}

    def failure_hook(i):
        if i in fails:
            fails.remove(i)
            raise RuntimeError("simulated node failure")

    torch.use_deterministic_algorithms(True)
    try:
        _reset_kernel_launches()
        t0 = time.perf_counter()
        state, rep = ft.ResilientLoop(
            step_fn, ckpt_lib.Checkpointer(str(ckpt_root), keep=2),
            save_every=TRAIN_SAVE_EVERY).run((params, opt_state), TRAIN_STEPS,
                                             failure_hook=failure_hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _kernel_launches()
    finally:
        torch.use_deterministic_algorithms(False)
    restart_at = TRAIN_FAIL_AT // TRAIN_SAVE_EVERY * TRAIN_SAVE_EVERY
    replayed = TRAIN_FAIL_AT - restart_at
    first_pass, after = rep.losses[:TRAIN_FAIL_AT], rep.losses[TRAIN_FAIL_AT:]
    losses = first_pass[:restart_at] + after  # one loss a step, 0 .. TRAIN_STEPS - 1
    check(rep.restarts == 1 and rep.final_step == TRAIN_STEPS
          and len(losses) == TRAIN_STEPS, f"train: restarts {rep.restarts}, final step "
          f"{rep.final_step}, {len(rep.losses)} losses")
    check(all(np.isfinite(rep.losses)), f"train: losses not all finite: {rep.losses}")
    check(after[:replayed] == first_pass[restart_at:],
          f"train: the replayed steps' losses {after[:replayed]} differ from their first "
          f"pass {first_pass[restart_at:]}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    check(last < first - 0.5, f"train: loss did not fall by 0.5: first five {first:.4f}, "
          f"last five {last:.4f}")
    check(all(x.dtype == torch.float32 for x in tree_flatten(state[0])[0]),
          "train: the masters are no longer float32")
    check(all(v == 0 for v in launched.values()), f"train: kernels launched {launched}")
    print(f"train: {TRAIN_STEPS} steps through ResilientLoop with a failure injected at step "
          f"{TRAIN_FAIL_AT}: restored step {restart_at}, replayed {replayed} steps with losses "
          f"bit-exact with their first pass (deterministic algorithms on), final step "
          f"{rep.final_step}, {rep.restarts} restart; {len(rep.losses)} steps in {wall:.2f} s "
          f"(data and checkpoints every {TRAIN_SAVE_EVERY} steps included); loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (first five {first:.4f}, last five "
          f"{last:.4f}), all finite, masters float32, K1-K4 launches {launched}")
    print("train: losses " + json.dumps([round(x, 4) for x in losses]))

    # The card -> CPU checkpoint: the newest snapshot onto the CPU, bytes equal.
    ck = ckpt_lib.Checkpointer(str(ckpt_root))
    latest = ck.latest_step()
    check(latest == TRAIN_STEPS, f"train: newest checkpoint {latest}, want {TRAIN_STEPS}")
    t0 = time.perf_counter()
    on_cpu = ck.restore(latest, like=ft.reshard(state, "cpu"))
    t_restore = time.perf_counter() - t0
    check(all(b.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a.cpu(), b)
              for a, b in zip(tree_flatten(state)[0], tree_flatten(on_cpu)[0])),
          "train: the checkpoint restored on the CPU differs from the card's state")
    nbytes = sum(x.numel() * x.element_size() for x in tree_flatten(state)[0])
    print(f"train: checkpoint of step {latest} ({nbytes / 1e9:.3f} GB, params and AdamW "
          f"state) written from the card, restored onto the CPU in {t_restore:.2f} s: "
          f"identical bytes")
    del on_cpu

    # ms a step, tokens/s, busy share and peak memory (deterministic off;
    # the loop above warmed the step up).
    p, o = state
    batches = [stream.batch(i) for i in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_TIMED)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches:
        p, o, m = step(p, o, b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    peak = torch.cuda.max_memory_allocated()
    dev_ms, kernels, wall = _busy(torch, lambda: step(p, o, batches[0]))
    flops = _train_flops(cfg, TRAIN_SEQ, TRAIN_BATCH)
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    check(bool(torch.isfinite(m["loss"])), "train: a timed step's loss is not finite")
    print(f"train: {ms:.3f} ms a step ({len(batches)} steps, batches made before), "
          f"{tokens / ms * 1e3:.1f} tokens/s; profiled step: device busy {dev_ms:.3f} ms of "
          f"{wall * 1e3:.3f} ms wall ({dev_ms / 1e3 / wall:.4f} busy share), {kernels} kernels; "
          f"peak memory {peak / 1e9:.3f} GB ({(peak - base_mem) / 1e9:.3f} GB above the "
          f"phase's start); {flops / 1e12:.3f} TFLOP a step (forward and backward, causal "
          f"attention) -> bound {bound_ms:.3f} ms at the bf16 peak, {bound_ms / ms:.4f} of "
          f"it reached, on {smi}")

    # remat policies at one microbatch (4 x 2048).
    half = {k: v[: TRAIN_BATCH // TRAIN_MICRO] for k, v in batches[0].items()}
    rows = []
    for mode in ("none", "full", "dots"):
        fn = ts.make_train_step(model, ts.TrainConfig(microbatches=1, remat=mode,
                                                      opt=ts.opt.OptimizerConfig()))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(p, o, half)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            _, _, mm = fn(p, o, half)
        torch.cuda.synchronize()
        rows.append(f"{mode} {(time.perf_counter() - t0) / 2 * 1e3:.3f} ms, peak "
                    f"{(torch.cuda.max_memory_allocated() - before) / 1e9:.3f} GB above "
                    f"{before / 1e9:.3f} GB")
        check(bool(torch.isfinite(mm["loss"])), f"train: remat {mode} loss not finite")
    print(f"train: remat at one microbatch ({TRAIN_BATCH // TRAIN_MICRO} x {TRAIN_SEQ}), "
          f"ms a step and peak memory: " + "; ".join(rows) + f" on {smi}")
    del p, o, state, batches, half

    _train_serve_resume(torch, params, ckpt_root, smi)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    print(f"train: phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 16. the MoE, xLSTM and Mamba2-hybrid families
# ---------------------------------------------------------------------------

#: (arch, layers of the float32 oracle check, param dtype of the bf16 run).
#: DeepSeek-MoE-16B: its dense first layer and 2 MoE layers; its weights in
#: bf16, the dtype its published checkpoint ships in (65.5 GB in float32).
#: Zamba2-7B: one group of 6 mamba layers with the shared block and a tail
#: layer.  xLSTM-350M: all 24 layers.
FAMILIES = (("deepseek-moe-16b", 3, "bfloat16"), ("zamba2-7b", 7, "float32"),
            ("xlstm-350m", 24, "float32"))
FAMILY_PREFILL = (2, 1024)  # batch x tokens of the prefill forward (cut from 2,048)
FAMILY_REQUESTS = 1  # bf16 requests a lane (cut from 2 for the time limit)
FAMILY_NEW_TOKENS = 16  # bf16 new tokens a request (cut from 32 for the time limit)


def _family_oracle(torch, arch: str, depth: int, kv_cache_dtype: str = "compute") -> None:
    """Float32, full width at ``depth`` layers: the engine at 4 lanes x 2
    requests gives the sequential oracle's tokens (4 lanes drop no MoE
    assignment: capacity max(ceil(4 x 6 x 1.25 / 64), 4) = 4 and a token
    puts at most one of its 6 on an expert)."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine
    from repro_torch.testing import engine_inputs

    cfg = replace(configs.get_config(arch), num_layers=depth, compute_dtype="float32",
                  kv_cache_dtype=kv_cache_dtype)
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(20))
    ecfg = EngineConfig(lanes=4, max_context=32, max_prompt_len=16, max_new_tokens=8,
                        requests_per_lane=2, eos_id=0)
    eng = GenerationEngine(model, params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=21)
    t0 = time.perf_counter()
    res = eng.generate(prompts, plens)
    ref = eng.reference_generate(prompts, plens)
    check(np.array_equal(res["tokens"], ref["tokens"])
          and np.array_equal(res["lengths"], ref["lengths"]),
          f"families: {arch} float32 engine tokens != the sequential oracle")
    print(f"families: {arch} full width float32 at {depth} of {configs.get_config(arch).num_layers}"
          f" layers, {kv_cache_dtype} KV cache, 4 lanes x 2 requests: equal to the sequential "
          f"oracle token for token "
          f"({int(res['lengths'].sum())} tokens, {eng.batched.last_result.steps} dispatches; "
          f"{time.perf_counter() - t0:.2f} s)")


def _family_serve(torch, arch: str, param_dtype: str, smi: str, kv_cache_dtype: str = "compute",
                  params=None, new_tokens: int = FAMILY_NEW_TOKENS):
    """bf16 at full depth: 16 lanes x 1 request a lane of ``new_tokens``
    measured and profiled (on ``params`` if given, else on seeded weights);
    returns the model, its
    compute weights and the measured run's output."""
    from dataclasses import replace

    from repro_torch import configs
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine
    from repro_torch.testing import engine_inputs

    cfg = replace(configs.get_config(arch), param_dtype=param_dtype,
                  kv_cache_dtype=kv_cache_dtype)
    model = get_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    at = "before serving (weights passed in)"
    if params is None:
        # The compute copy alone: the float32 masters go once it is made.
        params = model.cast_for_compute(model.init(
            torch.Generator(device="cuda").manual_seed(23)))
        at = "at init"
    leaves = tree_flatten(params)[0]
    n_params = sum(x.numel() for x in leaves)
    weight_gb = sum(x.numel() * x.element_size() for x in leaves) / 1e9
    init_peak = torch.cuda.max_memory_allocated()
    ecfg = EngineConfig(lanes=16, max_context=128, max_prompt_len=32,
                        max_new_tokens=new_tokens, requests_per_lane=FAMILY_REQUESTS,
                        eos_id=0)
    eng = GenerationEngine(model, params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=22)
    # Warm-up: the lowering and one short request, on one lane.
    one = np.zeros(ecfg.lanes, np.int32)
    one[0] = 1
    _, warm = _timed_run(torch, lambda: eng.generate(prompts, np.full_like(plens, 2), n_req=one))
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_launches()
    out, wall = _timed_run(torch, lambda: eng.generate(prompts, plens))
    launched = _kernel_launches()
    res = eng.batched.last_result
    execs, active = eng.batched.tag_stats["decode"]
    n_tok = int(out["lengths"].sum())
    check(res.converged and n_tok > 0, f"families: {arch} engine run: {n_tok} tokens")
    check(launched["decode_attention"] == model.attention_sites * execs,
          f"families: {arch} K4 launched {launched['decode_attention']} times, want "
          f"{model.attention_sites} attention sites x {execs} decode executions")
    check(launched["flash_attention"] == 0, f"families: {arch} serving launched {launched}")
    peak = torch.cuda.max_memory_allocated()
    # The profiled run: the first request of every lane.
    dev_ms, kernels, prof_wall = _busy(torch, lambda: eng.generate(
        prompts, plens, n_req=np.ones(ecfg.lanes, np.int32)))
    prof_steps = eng.batched.last_result.steps
    drop = (", mean moe_dropped_frac " + _moe_dropped_frac(torch, model, params, prompts)
            if cfg.family == "moe" else "")
    print(f"families: {arch} full width bf16 ({n_params / 1e9:.3f} B params, {weight_gb:.2f} GB "
          f"of compute weights, {cfg.param_dtype} params, {kv_cache_dtype} KV cache), 16 lanes x "
          f"{FAMILY_REQUESTS} request(s) a lane, prompts "
          f"2-32, {new_tokens} new tokens, cache 128: wall {wall:.3f} s (warm-up on one lane "
          f"{warm:.2f} s), "
          f"{n_tok} tokens, {n_tok / wall:.1f} tokens/s, {res.steps} dispatches, "
          f"{wall / res.steps * 1e3:.3f} ms/dispatch, decode executions {execs} (active "
          f"lane-steps {active}), K4 launches {launched['decode_attention']} = "
          f"{model.attention_sites} x {execs} (K1/K2 {launched['masked_push']}/"
          f"{launched['masked_peek']}: the program's return); peak memory {peak / 1e9:.3f} GB "
          f"serving, {init_peak / 1e9:.3f} GB {at}; profiled run (1 request a lane, "
          f"{prof_steps} dispatches): busy {dev_ms:.3f} of {prof_wall * 1e3:.3f} ms "
          f"({dev_ms / 1e3 / prof_wall:.4f} busy share), {kernels} kernels "
          f"({kernels / prof_steps:.1f} a dispatch){drop} on {smi}")
    return model, params, out


def _moe_dropped_frac(torch, model, params, prompts: np.ndarray) -> str:
    """The MoE layers' ``moe_dropped_frac`` at the serving batch, outside
    the timed runs: the lanes' first prompts go through ``decode_step``'s
    layers in lockstep, one token of every lane a step, as in the engine's
    batched decode (capacity from the lane count), each MoE layer's aux
    read.  Returns the mean and the count of layer calls, as text."""
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = model.cfg
    lanes, steps = prompts.shape[0], prompts.shape[2]
    cache = model.init_cache(lanes, steps)
    dropped = []
    with torch.no_grad():
        for t in range(steps):
            tokens = torch.from_numpy(prompts[:, 0, t].copy()).to(model.device)
            pos = torch.full((lanes,), t, dtype=torch.int32, device=model.device)
            h = L.embed(params["embed"], tokens[:, None], cfg)
            for i, lp in enumerate(params["dense_layers"]):
                h, cache["dense_kv"][i] = T.attn_block_decode(lp, h, cfg, cache["dense_kv"][i],
                                                              pos)
            for i in range(cache["kv"]["k"].shape[0]):
                lp = T._index(params["layers"], i)
                out, lc = L.attention_decode(lp["attn"], L.norm(lp["ln1"], h, cfg), cfg,
                                             T._index(cache["kv"], i), pos)
                for name, x in lc.items():
                    cache["kv"][name][i] = x
                h = h + out
                y, aux = T._ffn(lp, h, cfg)
                h = h + y
                dropped.append(aux["moe_dropped_frac"])
    return (f"{float(torch.stack(dropped).mean()):.6f} over {len(dropped)} MoE layer calls "
            f"({lanes} lanes' first prompts, {steps} tokens in lockstep)")


def _family_prefill(torch, model, params, smi: str, batch=None, what: str = "",
                    prefill=FAMILY_PREFILL) -> None:
    """bf16 forward at ``prefill`` (batch x tokens; of ``batch`` where it is
    given, made at that size): through K3 where
    the family has attention (against the plain blocked attention), else
    the plain forward alone."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import get_model

    cfg = model.cfg
    b, s = prefill
    if batch is None:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(24).integers(
            0, cfg.vocab_size, (b, s)).astype(np.int32)).cuda()}
    flash = get_model(cfg, use_flash=model.attention_sites > 0, device="cuda")
    with torch.no_grad():
        if model.attention_sites:  # warm K3 up (serving warmed the rest)
            flash.forward(params, batch)
        _reset_kernel_launches()
        (lf, _), wall = _timed_run(torch, lambda: flash.forward(params, batch))
        launches = fa_ops.flash_attention.launches
        check(launches == model.attention_sites,
              f"families: {cfg.name} prefill launched K3 {launches} times, want "
              f"{model.attention_sites}")
        check(fa_ops.flash_attention.sm90_launches == launches,
              f"families: {cfg.name} prefill launched the tensor-core K3 "
              f"{fa_ops.flash_attention.sm90_launches} of {launches} times")
        check(bool(torch.isfinite(lf).all()), f"families: {cfg.name} prefill logits not finite")
        line = (f"families: {cfg.name} prefill forward bf16, {b} x {s} tokens{what}: "
                f"{wall * 1e3:.3f} ms, "
                f"{b * s / wall:.1f} tokens/s, K3 launches {launches} "
                f"(tensor-core kernel {fa_ops.flash_attention.sm90_launches})")
        if launches:
            lp, _ = model.forward(params, batch)
            diff = float((lf.float() - lp.float()).abs().max())
            top1 = float((lf.argmax(-1) == lp.argmax(-1)).float().mean())
            line += f"; against the plain attention: max |logit diff| {diff:.3g}, top-1 " \
                    f"agreement {top1:.4f}"
            del lp
    print(line + f" on {smi}")
    del lf


def _family_kernel_checks(torch, arch: str, prefill=FAMILY_PREFILL) -> dict:
    """K3 and K4 at the family's own attention shapes (none in xLSTM),
    against their plain versions: K3 at the prefill forward's bf16 shape
    (``prefill``, batch x tokens),
    K4 at the serving batch and cache in bf16 and in float32 (the oracle
    check's dtype).  Returns each kernel's largest error."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    if cfg.family == "ssm":
        return {}
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    err = {"flash_attention": _k3_check(torch, *prefill, *heads,
                                        torch.bfloat16)["max_abs_err"]}
    err["decode_attention"] = max(_k4_check(torch, 16, 128, *heads, dtype, seed=25)["max_abs_err"]
                                  for dtype in (torch.bfloat16, torch.float32))
    return err


def phase_families(torch, smi: str) -> dict:
    """DeepSeek-MoE-16B, Zamba2-7B and xLSTM-350M: the float32 oracle check
    at reduced depth, bf16 serving at full depth, the prefill forward, and
    K3 and K4 at each family's attention shapes (Zamba2's head dim 112);
    returns each kernel's largest error in those checks."""
    import gc

    t_phase = time.perf_counter()
    max_err = {"flash_attention": 0.0, "decode_attention": 0.0}
    for arch, depth, param_dtype in FAMILIES:
        t0 = time.perf_counter()
        _family_oracle(torch, arch, depth)
        gc.collect()
        torch.cuda.empty_cache()
        model, params, _ = _family_serve(torch, arch, param_dtype, smi)
        _family_prefill(torch, model, params, smi)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        for name, err in _family_kernel_checks(torch, arch).items():
            max_err[name] = max(max_err[name], err)
        print(f"families: {arch} took {time.perf_counter() - t0:.1f} s")
    print(f"families: phase took {time.perf_counter() - t_phase:.1f} s")
    return max_err


# ---------------------------------------------------------------------------
# 17. multimodal and int8: Qwen2-VL-2B (M-RoPE) and HuBERT-XLarge
# ---------------------------------------------------------------------------

VLM = "qwen2-vl-2b"
VLM_ORACLE_DEPTH = 4  # of 28 layers, for the float32 oracle checks
VLM_GRID = 16  # the prefill's patches: one image on a 16 x 16 (h, w) grid
AUDIO = "hubert-xlarge"
AUDIO_ORACLE = (4, 1, 256)  # layers, batch, frames of the float32 card-vs-CPU forward
AUDIO_TRAIN = (2, 1024)  # batch x frames of the train step
MULTIMODAL_PREFILL = (2, 2048)  # batch x positions of the VLM prefill and the HuBERT forward
MULTIMODAL_NEW_TOKENS = 32  # bf16 new tokens a request of the VLM's serving


def _vlm_batch(torch, cfg) -> dict:
    """The multimodal prefill's inputs, ``MULTIMODAL_PREFILL`` positions:
    256 patch embeddings (one image, t = 0 on a 16 x 16 (h, w) grid), then
    the text tokens at ``16 + j`` on all three axes, as Qwen2-VL numbers
    them."""
    b, s = MULTIMODAL_PREFILL
    si = VLM_GRID * VLM_GRID
    i = np.arange(si)
    grid = np.stack([np.zeros(si), i // VLM_GRID, i % VLM_GRID])
    text = np.broadcast_to(VLM_GRID + np.arange(s - si), (3, s - si))
    pos = np.broadcast_to(np.concatenate([grid, text], axis=1), (b, 3, s)).astype(np.int32)
    rng = np.random.default_rng(26)
    gen = torch.Generator(device="cuda").manual_seed(26)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s - si))
                                       .astype(np.int32)).cuda(),
            "patch_embeds": torch.randn((b, si, cfg.d_model), generator=gen, device="cuda",
                                        dtype=torch.bfloat16),
            "positions": torch.from_numpy(pos.copy()).cuda()}


def _vlm(torch, smi: str) -> dict:
    """Qwen2-VL-2B: the float32 oracle checks with either cache, bf16
    serving at full depth with the compute and the int8 cache, the
    multimodal prefill through K3, and K3/K4 at its heads; returns each
    kernel's largest error in those checks."""
    import gc

    from repro_torch.kernels.flash_attention import ops as fa_ops

    for kv in ("compute", "int8"):
        _family_oracle(torch, VLM, VLM_ORACLE_DEPTH, kv_cache_dtype=kv)
        gc.collect()
        torch.cuda.empty_cache()
    model, params, out = _family_serve(torch, VLM, "float32", smi,
                                       new_tokens=MULTIMODAL_NEW_TOKENS)
    _, _, out8 = _family_serve(torch, VLM, "float32", smi, kv_cache_dtype="int8", params=params,
                               new_tokens=MULTIMODAL_NEW_TOKENS)
    n = min(out["tokens"].shape[-1], out8["tokens"].shape[-1])
    same = float((out["tokens"][..., :n] == out8["tokens"][..., :n]).mean())
    whole = int(sum(np.array_equal(a[:la], c[:lc]) for a, c, la, lc in zip(
        out["tokens"].reshape(-1, out["tokens"].shape[-1]),
        out8["tokens"].reshape(-1, out8["tokens"].shape[-1]),
        out["lengths"].reshape(-1), out8["lengths"].reshape(-1))))
    print(f"multimodal: {VLM} bf16 serving, int8 against the compute KV cache: token "
          f"agreement {same:.4f} over the output slots, {whole} of {out['lengths'].size} "
          f"requests identical (printed, not checked: int8 rounding changes greedy picks)")
    batch = _vlm_batch(torch, model.cfg)
    _family_prefill(torch, model, params, smi, batch=batch, prefill=MULTIMODAL_PREFILL,
                    what=f" ({VLM_GRID * VLM_GRID} patches on a {VLM_GRID} x {VLM_GRID} grid "
                         f"and {MULTIMODAL_PREFILL[1] - VLM_GRID * VLM_GRID} text tokens, "
                         "3-axis M-RoPE positions)")
    check(fa_ops.flash_attention.sm90_launches == model.attention_sites,
          f"multimodal: the prefill launched the tensor-core K3 "
          f"{fa_ops.flash_attention.sm90_launches} times, want {model.attention_sites}")
    del model, params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return _family_kernel_checks(torch, VLM, MULTIMODAL_PREFILL)


def _hubert(torch, smi: str) -> None:
    """HuBERT-XLarge at full width: the bf16 forward over ``MULTIMODAL_PREFILL`` frames,
    the float32 forward at 4 layers on the card against the CPU, and the
    launcher's train step at 2 x 1,024 frames."""
    import gc
    from dataclasses import replace

    import torch.utils._pytree as pytree

    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch.train import build_trainer
    from repro_torch.mcmc import prng
    from repro_torch.models import get_model

    cfg = configs.get_config(AUDIO)
    b, s = MULTIMODAL_PREFILL
    model = get_model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    params = model.cast_for_compute(model.init(torch.Generator(device="cuda").manual_seed(27)))
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    batch = model.make_batch(prng.prng_key(27).cuda(), ShapeSpec("p", s, b, "prefill"))
    with torch.no_grad():
        model.forward(params, batch)  # warm-up
        _reset_kernel_launches()
        (logits, _), wall = _timed_run(torch, lambda: model.forward(params, batch))
    launched = _kernel_launches()
    check(tuple(logits.shape) == (b, s, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"multimodal: {AUDIO} logits {tuple(logits.shape)} not finite or of the wrong shape")
    check(all(v == 0 for v in launched.values()),
          f"multimodal: {AUDIO}'s non-causal attention launched {launched}")
    print(f"multimodal: {AUDIO} full width ({cfg.num_layers} layers, d {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params) bf16 forward over {b} x {s} frames: "
          f"{wall * 1e3:.3f} ms, {b * s / wall:.1f} frames/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, logits {tuple(logits.shape)} "
          f"finite, no kernel launched (the encoder's attention is not causal, so it stays on "
          f"the plain path, as in the reference) on {smi}")
    del model, params, batch, logits
    gc.collect()
    torch.cuda.empty_cache()

    depth, ob, os_ = AUDIO_ORACLE
    small = replace(cfg, num_layers=depth, compute_dtype="float32")
    cpu_model = get_model(small, device="cpu")
    cpu_params = cpu_model.init(torch.Generator().manual_seed(28))
    frames = torch.randn((ob, os_, cfg.d_model), generator=torch.Generator().manual_seed(29))
    with torch.no_grad():
        want, _ = cpu_model.forward(cpu_params, {"frames": frames})
        got, _ = get_model(small, device="cuda").forward(
            pytree.tree_map(lambda t: t.cuda(), cpu_params), {"frames": frames.cuda()})
    err = float((got.cpu() - want).abs().max())
    check(err < 1e-3, f"multimodal: {AUDIO} float32 forward on the card differs from the CPU "
                      f"by {err:.3g}")
    print(f"multimodal: {AUDIO} float32 forward at {depth} of {cfg.num_layers} layers, {ob} x "
          f"{os_} frames: card against CPU max |logit diff| {err:.3g} (limit 1e-3)")

    torch.cuda.reset_peak_memory_stats()
    tb, ts_ = AUDIO_TRAIN
    tmodel, tparams, opt_state, step, stream = build_trainer(
        AUDIO, seq_len=ts_, global_batch=tb, steps=2, lr=1e-4, microbatches=1, remat="none",
        smoke=False, device="cuda")
    losses, times = [], []
    for i in range(2):  # the first step warms up
        data = stream.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tparams, opt_state, metrics = step(tparams, opt_state, data)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"multimodal: {AUDIO} train losses {losses}")
    print(f"multimodal: {AUDIO} full width launch.train step, {tb} x {ts_} frames (bf16 "
          f"compute, float32 masters, AdamW, remat none): loss {losses[0]:.4f} then "
          f"{losses[1]:.4f}, finite; {times[1] * 1e3:.1f} ms a step (warm-up step "
          f"{times[0] * 1e3:.1f} ms), peak memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"on {smi}")
    del tmodel, tparams, opt_state, step, stream
    gc.collect()
    torch.cuda.empty_cache()


def phase_multimodal(torch, smi: str) -> dict:
    """Qwen2-VL-2B and HuBERT-XLarge; returns each kernel's largest error
    in the checks at Qwen2-VL-2B's heads."""
    t_phase = time.perf_counter()
    err = _vlm(torch, smi)
    print(f"multimodal: {VLM} took {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    _hubert(torch, smi)
    print(f"multimodal: {AUDIO} took {time.perf_counter() - t0:.1f} s")
    print(f"multimodal: phase took {time.perf_counter() - t_phase:.1f} s")
    return err


# ---------------------------------------------------------------------------
# 18. chaos and entry points
# ---------------------------------------------------------------------------

CHAOS_LANES = [16, 64]
CHAOS = dict(rate=32.0, chaos_rate=0.2, num_requests=64, segment_steps=64, max_new=64,
             prompt_len=6, seed=0)  # benchmarks/serve_bench.py's chaos defaults, at 32/s


def _entry_points(out_dir: Path) -> dict:
    """The port's serving example in both modes and the benchmark driver,
    each a subprocess on the card, all started together; their output goes
    to ``out_dir``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {
        "serve_lm_check": [sys.executable, "examples/torch_serve_lm.py", "--check"],
        "serve_lm_open_loop": [sys.executable, "examples/torch_serve_lm.py", "--open-loop"],
        "torch_run": [sys.executable, "-m", "benchmarks.torch_run", "--only", "fig6,serve",
                      "--batches", "8", "--serve-arrivals", "poisson", "--serve-requests",
                      "16", "--fig6-json-out", str(out_dir / "phase18_fig6.json"),
                      "--serve-json-out", str(out_dir / "phase18_serve.json")],
    }
    procs = {}
    for name, cmd in cmds.items():
        with open(out_dir / f"phase18_{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                           stderr=subprocess.STDOUT)
    return procs


def _grad_check(torch) -> None:
    """``Target.grad``/``value_and_grad`` against ``torch.autograd.grad``."""
    from repro_torch.mcmc import targets

    target = targets.logistic_regression(num_data=10_000, dim=100, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    xs = torch.randn(CHAINS, 100, generator=gen, device="cuda") * 0.1
    xr = xs.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(torch.func.vmap(target.logp)(xr).sum(), xr)
    value, grad = target.value_and_grad()(xs[0])
    errs = {
        "grad": (target.grad()(xs[0]) - want[0]).abs().max().item(),
        "value_and_grad": (grad - want[0]).abs().max().item(),
        "vmap(grad)": (torch.func.vmap(target.grad())(xs) - want).abs().max().item(),
    }
    scale = want.abs().max().item()
    check(abs(value.item() - target.logp(xs[0]).item()) <= 1e-5 * abs(value.item()),
          "value_and_grad's value differs from logp")
    for name, err in errs.items():
        check(err <= 1e-5 * scale, f"Target.{name} differs from autograd by {err:.3e} "
                                   f"(largest entry {scale:.3e})")
    print("chaos: Target.grad/value_and_grad on logistic_regression(10000, 100), one chain "
          f"and {CHAINS} through vmap, against torch.autograd.grad of logp: largest "
          f"differences {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (largest "
          f"entry {scale:.3e})")


def phase_chaos(torch) -> None:
    """Fault-injected serving at full width, Target.grad, and the serving
    example and benchmark driver as subprocesses."""
    from benchmarks import torch_serve_bench as sb
    from benchmarks.common import validate_bench_json
    from repro_torch.kernels.flash_decode import ops as fd_ops

    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    # The subprocesses run beside the sweep (the phase's budget is 60 s; one
    # after the other they took 70 s on an H100 at 700 W), so the sweep's
    # wall-clock numbers are taken with three more processes on the card
    # and the host.
    procs = _entry_points(out_dir)
    try:
        model = sb.load_model(True, torch.device("cuda"))
        cfg = model[0]
        fd_ops.decode_attention.launches = 0
        tab, records = sb.chaos_sweep(model, CHAOS_LANES, device=torch.device("cuda"), **CHAOS)
        torch.cuda.synchronize()
        launches = fd_ops.decode_attention.launches
        print(tab.render())
        execs = records[0]["calibration"]["decode_executions"] + sum(
            sum(r["decode_executions"].values()) for r in records)
        check(launches == cfg.num_layers * execs,
              f"chaos: K4 launched {launches} times, want {cfg.num_layers} x {execs}")
        for r in records:
            what = f"chaos at {r['lanes']} lanes"
            check(r["violations"] == [], f"{what}: violations {r['violations']}")
            check(r["healthy_bitexact"], f"{what}: healthy requests not bit-exact")
            check(len(r["injected_rids"]) == 13, f"{what}: injected {r['injected_rids']}")
            ended = {rid: r["faults"].get(rid) for rid in r["injected_rids"]}
            check(ended == r["injected_rids"],
                  f"{what}: injected requests ended {ended}, want {r['injected_rids']}")
            check(sum(r["statuses"].values()) == CHAOS["num_requests"],
                  f"{what}: statuses {r['statuses']}")
            print(f"chaos: {ARCH} full width bf16, {r['lanes']} lanes, 64 Poisson arrivals at "
                  f"32/s, 13 injected {r['injected']}: statuses {r['statuses']}, error rate "
                  f"{r['error_rate']:.4f}, retry rate {r['retry_rate']:.4f}, shed rate "
                  f"{r['shed_rate']:.4f}, timeout rate {r['timeout_rate']:.4f}, latency p50 "
                  f"{r['p50_latency_s']:.3f} s p99 {r['p99_latency_s']:.3f} s, "
                  f"{r['tok_s']:.1f} tokens/s ({r['generated_tokens']} tokens in "
                  f"{r['wall_s']:.3f} s), {r['vm_steps']} dispatches, {r['segments']} "
                  f"segments, lane_step_budget {r['lane_step_budget']} (2 x "
                  f"{r['calibration']['vm_steps']}), faults {sorted(set(r['faults'].values()))}"
                  f", healthy bit-exact")
        print(f"chaos: K4 launches {launches} = {cfg.num_layers} x {execs} decode executions "
              f"(calibration, chaos-free and chaotic serves); sweep "
              f"{time.perf_counter() - t_phase:.1f} s")
        _grad_check(torch)
        for name, proc in procs.items():
            rc = proc.wait(timeout=300)
            log = (out_dir / f"phase18_{name}.log").read_text()
            check(rc == 0, f"{name} exited {rc}: {log[-2000:]}")
        lines = {name: (out_dir / f"phase18_{name}.log").read_text().splitlines()
                 for name in procs}
        check("matches sequential oracle: True" in lines["serve_lm_check"],
              "torch_serve_lm --check: not equal to the sequential oracle")
        check(any(ln.startswith("served 16 requests") for ln in lines["serve_lm_open_loop"]),
              "torch_serve_lm --open-loop: not every request served")
        paths = [str(out_dir / "phase18_fig6.json"), str(out_dir / "phase18_serve.json")]
        validate_bench_json(paths)
        check(any(ln.startswith("[validated strict JSON:") for ln in lines["torch_run"]),
              "torch_run did not validate its records")
        for name in ("serve_lm_check", "serve_lm_open_loop"):
            for ln in lines[name]:
                if not ln.startswith("  request "):
                    print(f"chaos: {name}: {ln}")
        print(f"chaos: torch_run --only fig6,serve: records {', '.join(paths)} strictly "
              f"valid; {lines['torch_run'][-1].strip()}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"chaos: phase took {time.perf_counter() - t_phase:.1f} s")

# ---------------------------------------------------------------------------
# 19. lanes over ranks
# ---------------------------------------------------------------------------

MESH_RANKS = 2
#: (schedule, compact_every) of the sharded NUTS runs.
MESH_NUTS = (("earliest", None), ("lookahead", None), ("earliest", 1))
MESH_BACKEND = "gloo"  # NCCL refuses two ranks on one card


def _sync_all(torch) -> None:
    """Wait for this rank's card, then for every rank (the host group)."""
    torch.cuda.synchronize()
    torch.distributed.barrier()


def _mesh_rank(rank: int, device, work: str) -> dict:
    """One rank of phase 19: NUTS at 1024 chains and SmolLM-135M's engine
    with their lanes over the ranks, each held to its unsharded run of the
    same call (written to ``work`` by the parent).  Checks raise; the
    figures come back."""
    import torch

    from repro_torch import configs
    from repro_torch.core import ir
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.stack_ops import ops
    from repro_torch.mcmc import nuts, targets
    from repro_torch.models import get_model
    from repro_torch.serve import engine as E
    from repro_torch.testing import engine_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = torch.load(Path(work) / "unsharded.pt", weights_only=False)
    half = slice(rank * CHAINS // MESH_RANKS, (rank + 1) * CHAINS // MESH_RANKS)
    out: dict = {"rank": rank, "device": str(device), "nuts": {}, "held": {}}

    # (a) NUTS on the 10,000 x 100 logistic regression, 1024 chains.
    settings = nuts.NutsSettings(**ref["settings"])
    target = targets.logistic_regression(num_data=10_000, dim=100, device=device)
    args = nuts.initial_state(target, CHAINS, eps=0.01, seed=0, device=device)
    # One lowering (type inference) for the three: with_options shares it.
    base = nuts.make_nuts_kernel(target, settings, batch_size=CHAINS, mesh=MESH_RANKS,
                                 device=device)
    for schedule, ce in MESH_NUTS:
        kern = base.with_options(schedule=schedule, compact_every=ce)
        kern(*args)  # warm-up: the executor
        ops.masked_push.launches = ops.masked_peek.launches = 0
        _sync_all(torch)
        t0 = time.perf_counter()
        got = kern(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        push, peek = ops.masked_push.launches, ops.masked_peek.launches
        res = kern.last_result
        want = ref["nuts"][(schedule, ce)]
        check(res.converged and res.sched.num_devices == MESH_RANKS,
              f"rank {rank} {schedule}/{ce}: converged {res.converged}, "
              f"{res.sched.num_devices} devices")
        check(res.steps == want["steps"] and np.array_equal(res.block_exec, want["block_exec"]),
              f"rank {rank} {schedule}/{ce}: steps {res.steps} / block_exec differ from the "
              f"unsharded run's {want['steps']}")
        blocks = kern.lowered.blocks
        want_push = sum(int(n) * _group_launches(b, ir.LPush, ir.LPushJump)
                        for n, b in zip(res.block_exec, blocks))
        want_peek = sum(int(n) * _group_launches(b, ir.LPop, ir.LReturn)
                        for n, b in zip(res.block_exec, blocks))
        check((push, peek) == (want_push, want_peek),
              f"rank {rank} {schedule}/{ce}: K1/K2 launches {push}/{peek}, the dispatched "
              f"blocks imply {want_push}/{want_peek}")
        mine = {k: got[k].to_local().cpu() for k in ref["nuts_out"]}
        differ = [k for k in mine if not torch.equal(mine[k], ref["nuts_out"][k][half])]
        lane_steps = res.lane_steps.to_local().cpu()
        held = "bit-exact"
        if differ:
            # The target's [512, 100] x [100, 10000] product may reduce in
            # another order than at 1024 rows: hold the control flow chain
            # by chain and the samples to phase 5's tolerance instead.
            check(torch.equal(lane_steps, ref["lane_steps"][half]),
                  f"rank {rank} {schedule}/{ce}: chains took other paths than unsharded")
            for k in mine:
                torch.testing.assert_close(mine[k], ref["nuts_out"][k][half], rtol=1e-4,
                                           atol=1e-5)
            diff = max(float((mine[k] - ref["nuts_out"][k][half]).abs().max()) for k in mine)
            held = (f"the same control flow chain by chain, samples within 1e-4 ({differ} "
                    f"not bit-exact, largest difference {diff:.3g})")
        _, active = res.tag_stats["grad"]
        out["held"][f"nuts {schedule}/{ce}"] = held
        out["nuts"][(schedule, ce)] = dict(wall=wall, grads=active * settings.grads_per_leaf,
                                           steps=res.steps, push=push, peek=peek)

    # (b) SmolLM-135M, bf16, full width, 64 lanes: phase 9's first request
    # a lane and phase 12's burst with Poisson arrivals behind it.
    cfg = configs.get_config(ARCH)
    gen = torch.Generator(device=device).manual_seed(1)
    params = get_model(cfg, device=device).init(gen)
    ecfg = E.EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                          requests_per_lane=2, eos_id=0, mesh=MESH_RANKS)
    eng = E.GenerationEngine(get_model(cfg, device=device), params, ecfg)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=12)
    eng.batched.lowered  # type inference before the clock
    fd_ops.decode_attention.launches = 0
    _sync_all(torch)
    t0 = time.perf_counter()
    # The first of phase 9's two requests a lane (a request's tokens do not
    # depend on the lane's others: each starts from a reset cache).
    res9 = eng.generate(prompts, plens, n_req=np.ones(ecfg.lanes, np.int32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = fd_ops.decode_attention.launches
    execs, _ = eng.batched.tag_stats["decode"]
    check(k4 == cfg.num_layers * execs,
          f"rank {rank} engine: K4 launched {k4} times, want {cfg.num_layers} x {execs}")
    n_tok = int(res9["lengths"].sum())
    out["closed"] = dict(tokens=res9["tokens"], lengths=res9["lengths"], wall=wall,
                         tokens_total=n_tok, steps=eng.batched.last_result.steps, k4=k4,
                         execs=execs)

    ecfg = E.EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                          requests_per_lane=1, eos_id=0, segment_steps=16, mesh=MESH_RANKS)
    eng = E.GenerationEngine(get_model(cfg, device=device), params, ecfg)
    eng.serve_batched.lowered
    overload = _overload(E, cfg.vocab_size, ref["arrivals"])
    fd_ops.decode_attention.launches = 0
    _sync_all(torch)
    comps, st = eng.serve(overload)
    torch.cuda.synchronize()
    k4 = fd_ops.decode_attention.launches
    execs, _ = eng.last_serve_result.tag_stats["decode"]
    check(k4 == cfg.num_layers * execs,
          f"rank {rank} serve: K4 launched {k4} times, want {cfg.num_layers} x {execs}")
    check(st.ok == len(overload), f"rank {rank} serve: {st.ok} of {len(overload)} ok")
    out["open"] = dict(tokens={c.rid: c.tokens for c in comps}, wall=st.wall_time,
                       tokens_total=st.generated_tokens, steps=st.vm_steps, k4=k4,
                       execs=execs, **dict(zip(("p50", "p99"), _latency(comps))),
                       refills=_refills(comps), admitted=sorted(c.admitted for c in comps))

    import dataclasses

    # (c) Snapshots under the lane mesh: phase 9's first request a lane
    # served with checkpoint_dir, stopped after its first segment's
    # snapshot, and resumed by a fresh engine.
    from repro_torch.train.checkpoint import Checkpointer

    snap = Path(work) / "lane_snapshots"
    scfg = E.EngineConfig(lanes=64, max_context=512, max_prompt_len=64, max_new_tokens=64,
                          requests_per_lane=1, eos_id=0, segment_steps=16, mesh=MESH_RANKS,
                          checkpoint_dir=str(snap), checkpoint_every_segments=1)
    reqs = [E.Request(rid=z, prompt=prompts[z, 0, :plens[z, 0]]) for z in range(ecfg.lanes)]
    t0 = time.perf_counter()

    def clock():  # every rank stops at the same read: once a snapshot is published
        if Checkpointer(str(snap)).all_steps():
            raise _Stopped
        return time.perf_counter() - t0

    try:
        E.GenerationEngine(get_model(cfg, device=device), params, scfg).serve(reqs, now_fn=clock)
        check(False, f"rank {rank}: the serve was not stopped")
    except _Stopped:
        pass
    t_stop = time.perf_counter() - t0
    fd_ops.decode_attention.launches = ops.masked_push.launches = ops.masked_peek.launches = 0
    # (a snapshot only at the end: each is every lane's cache, ~0.75 GB)
    eng = E.GenerationEngine(get_model(cfg, device=device), params,
                             dataclasses.replace(scfg, checkpoint_every_segments=10**6))
    comps, st = eng.serve(reqs, resume=True)
    torch.cuda.synchronize()
    ok = len(comps) == ecfg.lanes and all(np.array_equal(
        c.tokens, res9["tokens"][c.rid, 0, :res9["lengths"][c.rid, 0]]) for c in comps)
    check(ok, f"rank {rank}: the resumed requests' tokens differ from the closed loop's")
    out["resume"] = dict(stopped_s=t_stop, resume_s=time.perf_counter() - t0 - t_stop,
                         k4=fd_ops.decode_attention.launches, k1=ops.masked_push.launches,
                         k2=ops.masked_peek.launches, checkpoints=st.checkpoints,
                         n=len(comps))
    return out


class _Stopped(Exception):
    pass


def _agreement(a: np.ndarray, b: np.ndarray) -> float:
    return float((a == b).mean())


def phase_mesh(torch, settings, run6: dict, run9: dict, run12: dict, smi: str) -> None:
    """Two ranks share the card, each serving half the lanes, through
    ``repro_torch.distributed.spawn`` with a gloo default group."""
    from dataclasses import asdict

    from repro_torch import configs, distributed
    from repro_torch.models import get_model
    from repro_torch.serve import engine as E
    from repro_torch.testing import engine_inputs

    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase19"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # The unsharded runs the ranks are held to: phase 6's NUTS (earliest),
    # the other configurations' own runs (all timed beside the sharded
    # ones), phases 9's and 12's tokens.
    res6 = run6["res"]
    nuts_ref, plain = {}, {}
    for schedule, ce in MESH_NUTS:
        kern = run6["kern"].with_options(schedule=schedule, compact_every=ce)
        kern(*run6["args"])  # warm-up: the executor
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kern(*run6["args"])
        torch.cuda.synchronize()
        res = kern.last_result
        plain[(schedule, ce)] = (time.perf_counter() - t0, res.steps,
                                 res.tag_stats["grad"][1] * settings.grads_per_leaf)
        nuts_ref[(schedule, ce)] = dict(steps=res.steps,
                                        block_exec=np.asarray(res.block_exec))
    check(nuts_ref[("earliest", None)]["steps"] == res6.steps, "phase 6's NUTS did not repeat")
    torch.save({"settings": asdict(settings), "nuts": nuts_ref, "arrivals": run12["arrivals"],
                "nuts_out": {k: v.cpu() for k, v in run6["out"].items()},
                "lane_steps": res6.lane_steps.cpu()}, work / "unsharded.pt")
    del kern
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"mesh: {MESH_RANKS} ranks on {torch.cuda.device_count()} card(s) "
          f"({smi}), default process group backend {MESH_BACKEND}; the VM's per-dispatch "
          f"reduction runs on a gloo group of the host")
    t0 = time.perf_counter()
    ranks = distributed.spawn(_mesh_rank, MESH_RANKS, rendezvous_dir=work,
                              backend=MESH_BACKEND, args=(str(work),), timeout=600)
    t_ranks = time.perf_counter() - t0
    for r in ranks:
        print(f"mesh: rank {r['rank']} on {r['device']}: " + ", ".join(
            f"{k} held {v}" for k, v in r["held"].items()))
    # Whether the target's gradient over half the chains rounds as the
    # same rows of it over all of them (cuBLAS may pick its reduction by
    # the GEMM's shape).
    from repro_torch.mcmc import targets

    grad = torch.func.vmap(targets.logistic_regression(num_data=10_000, dim=100,
                                                       device="cuda").grad())
    theta = run6["args"][0]
    half = CHAINS // MESH_RANKS
    g_all, g_half = grad(theta)[:half], grad(theta[:half].contiguous())
    print(f"mesh: the target's gradient of the first {half} chains computed over {half} rows "
          f"{'equals' if torch.equal(g_all, g_half) else 'differs from'} the same rows over "
          f"{CHAINS} (largest difference {float((g_all - g_half).abs().max()):.3g})")

    # NUTS figures: rank 0's wall around the whole batch's gradients.
    _, active6 = res6.tag_stats["grad"]
    print(f"mesh: phase 6 in this call: {active6 * settings.grads_per_leaf / run6['wall']:.1f} "
          f"grads/s, {run6['wall'] / res6.steps * 1e3:.3f} ms/dispatch")
    for (schedule, ce), f in ranks[0]["nuts"].items():
        push, peek = (ranks[1]["nuts"][(schedule, ce)][k] for k in ("push", "peek"))
        wall, steps, grads = plain[(schedule, ce)]
        print(f"mesh: NUTS 10,000 x 100, {CHAINS} chains over {MESH_RANKS} ranks "
              f"({CHAINS // MESH_RANKS} a rank), {schedule}"
              f"{'' if ce is None else f' + compaction every {ce}'}: wall {f['wall']:.3f} s, "
              f"{f['steps']} dispatches, {f['wall'] / f['steps'] * 1e3:.3f} ms/dispatch, "
              f"{f['grads'] / f['wall']:.1f} grads/s; K1/K2 launches a rank "
              f"{f['push']}/{f['peek']} and {push}/{peek} (= block_exec x groups); unsharded "
              f"just before: wall {wall:.3f} s, {wall / steps * 1e3:.3f} ms/dispatch, "
              f"{grads / wall:.1f} grads/s")

    # The engine: every rank returns every lane's tokens.
    for r in ranks[1:]:
        check(np.array_equal(r["closed"]["tokens"], ranks[0]["closed"]["tokens"]) and all(
            np.array_equal(r["open"]["tokens"][rid], t)
            for rid, t in ranks[0]["open"]["tokens"].items()), "the ranks' tokens differ")
    closed, opened = ranks[0]["closed"], ranks[0]["open"]
    same_closed = (np.array_equal(closed["tokens"], run9["tokens"])
                   and np.array_equal(closed["lengths"], run9["lengths"]))
    same_open = opened["tokens"].keys() == run12["tokens"].keys() and all(
        np.array_equal(t, run12["tokens"][rid]) for rid, t in opened["tokens"].items())
    print(f"mesh: engine tokens equal to the unsharded 64-lane engine's: closed loop "
          f"{same_closed} (agreement "
          f"{_agreement(closed['tokens'], run9['tokens']):.4f}), "
          f"open loop {same_open}")
    if not (same_closed and same_open):
        # bf16 GEMMs at 32 rows may round otherwise than at 64: hold each
        # rank's lanes to an unsharded 32-lane engine given the same
        # requests (the same GEMM shapes).
        cfg = configs.get_config(ARCH)
        params = get_model(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(1))
        half = 64 // MESH_RANKS
        ecfg = E.EngineConfig(lanes=64, max_context=512, max_prompt_len=64,
                              max_new_tokens=64, requests_per_lane=2, eos_id=0)
        prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=12)
        eng = E.GenerationEngine(get_model(cfg, device="cuda"), params,
                                 E.EngineConfig(**dict(asdict(ecfg), lanes=half)))
        for q in range(MESH_RANKS):
            lanes = slice(q * half, (q + 1) * half)
            want = eng.generate(prompts[lanes], plens[lanes], n_req=np.ones(half, np.int32))
            check(np.array_equal(closed["tokens"][lanes, :1], want["tokens"][:, :1]),
                  f"closed loop: rank {q}'s lanes differ from a {half}-lane engine's")
        eng = E.GenerationEngine(get_model(cfg, device="cuda"), params, E.EngineConfig(
            lanes=half, max_context=512, max_prompt_len=64, max_new_tokens=64,
            requests_per_lane=1, eos_id=0, segment_steps=16))
        comps, _ = eng.serve(_overload(E, cfg.vocab_size, run12["arrivals"]))
        check(all(np.array_equal(opened["tokens"][c.rid], c.tokens) for c in comps),
              f"open loop: tokens differ from a {half}-lane engine's")
        print(f"mesh: held instead: each rank's lanes equal to an unsharded {half}-lane "
              f"engine's, closed and open loop")
    for what, f, base in (("closed loop, phase 9's first request a lane", closed, run9),
                          (f"open loop, phase 12's burst of {SERVE_BURST} and "
                           f"{len(run12['arrivals'])} Poisson arrivals behind it", opened, run12)):
        print(f"mesh: SmolLM-135M bf16 full width, 64 lanes over {MESH_RANKS} ranks, "
              f"{what}: wall {f['wall']:.3f} s, {f['tokens_total']} tokens, "
              f"{f['tokens_total'] / f['wall']:.1f} tokens/s, {f['steps']} dispatches, "
              f"{f['wall'] / f['steps'] * 1e3:.3f} ms/dispatch; the same workload unsharded "
              f"in this call: wall {base['wall']:.3f} s, {base['tok_s']:.1f} tokens/s, "
              f"{base['steps']} dispatches, {base['wall'] / base['steps'] * 1e3:.3f} "
              f"ms/dispatch")
    admitted = opened["admitted"]
    late = sum(a > admitted[0] for a in admitted)
    print(f"mesh: open loop on the first rank's clock: {late} of {len(admitted)} requests "
          f"admitted after the first admission, {opened['refills']} on a lane an earlier "
          f"request had retired (unsharded: {run12['refills']})")
    check(late > 0 and opened["refills"] > 0,
          "phase 19's open loop admitted every request at once or refilled no lane")
    layers = configs.get_config(ARCH).num_layers
    for r in ranks:
        print(f"mesh: rank {r['rank']} K4 launches closed {r['closed']['k4']} = "
              f"{layers} x {r['closed']['execs']}, open {r['open']['k4']} = {layers} x "
              f"{r['open']['execs']} decode executions (open loop p50 "
              f"{r['open']['p50']:.3f} s, p99 {r['open']['p99']:.3f} s)")
    for r in ranks:
        f = r["resume"]
        print(f"mesh: rank {r['rank']} lane-mesh snapshot: phase 9's first request a lane "
              f"served with checkpoint_dir, stopped after its first segment's snapshot "
              f"({f['stopped_s']:.1f} s), resumed by a fresh engine ({f['resume_s']:.1f} s, "
              f"{f['checkpoints']} snapshots, K1/K2/K4 launches {f['k1']}/{f['k2']}/{f['k4']}): "
              f"all {f['n']} requests' tokens equal to the closed loop's")
    shutil.rmtree(work, ignore_errors=True)
    print(f"mesh: phase took {time.perf_counter() - t_phase:.1f} s (ranks {t_ranks:.1f} s)")



SHARD_MESH = ((2, 2), ("data", "model"))
SHARD_SEQ, SHARD_BATCH, SHARD_STEPS, MOE_STEPS = 1024, 4, 3, 2
# SmolLM-135M's float32 runs: full width cut to F32_LAYERS layers (for the
# time limit), SHARD_STEPS steps at one microbatch and MB_STEPS at
# SHARD_MICROBATCHES (each microbatch one sequence a data rank), each held
# to the same steps unsharded; each rank counts its FLOPs in the first
# step of each.
F32_LAYERS, SHARD_MICROBATCHES, MB_STEPS = 4, 2, 2
MOE_ARCH = "deepseek-moe-16b"
# Phase 20's limits for the float32 sharded runs against the unsharded
# float32 runs: the largest loss difference, the update gap
# (:func:`_update_gap`) and the first-moment gap (:func:`_mu_gap`).  Each
# sits about 10x above those runs' readings on the card and below the bf16
# control's (bf16 against float32 compute, unsharded), which must exceed
# it (PERF.md §6).  DeepSeek's first-moment limit is wider: its
# router's gradient, a sum over every token through the softmax's
# Jacobian, reads 2.6e-3 there with no token routed differently.
SHARD_TOL = {"smollm": {"loss": 1e-5, "update": 1e-3, "mu": 1e-4},
             "moe": {"loss": 2e-5, "update": 5e-3, "mu": 2e-2}}
# The collectives the sharded step issues on CUDA tensors (DTensor's
# redistributions, through the functional API) and their c10d forms.
PROBE_CALLS = (tuple(("c10d", op) for op in (
    "all_reduce", "broadcast", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "barrier")) + tuple(("funcol", op) for op in (
        "all_reduce", "reduce_scatter_tensor", "all_to_all_single", "all_gather_into_tensor")))


def _probe_call(torch, api: str, name: str, rank: int, n: int, device) -> bool:
    """One collective on a CUDA tensor through ``api`` (``c10d`` or the
    functional ``funcol``); whether every rank got the right values."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc

    world = dist.group.WORLD
    x = torch.arange(4 * n, dtype=torch.float32, device=device) + 100 * rank
    parts = [torch.arange(4 * n, device=device) + 100 * r for r in range(n)]
    if name == "all_reduce":
        want = sum(parts)
        y = fc.all_reduce(x, "sum", world) if api == "funcol" else x.clone()
        if api == "c10d":
            dist.all_reduce(y)
    elif name == "broadcast":
        y, want = x.clone(), parts[0]
        dist.broadcast(y, src=0)
    elif name == "all_gather_into_tensor":
        want = torch.cat(parts)
        if api == "funcol":
            y = fc.all_gather_tensor(x, 0, world)
        else:
            y = torch.empty(4 * n * n, device=device)
            dist.all_gather_into_tensor(y, x)
    elif name == "reduce_scatter_tensor":
        want = sum(parts)[4 * rank:4 * rank + 4]
        if api == "funcol":
            y = fc.reduce_scatter_tensor(x, "sum", 0, world)
        else:
            y = torch.empty(4, device=device)
            dist.reduce_scatter_tensor(y, x)
    elif name == "all_to_all_single":
        want = torch.cat([p[4 * rank:4 * rank + 4] for p in parts])
        if api == "funcol":
            y = fc.all_to_all_single(x, None, None, world)
        else:
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
    else:
        dist.barrier()
        y = want = x
    y = y * 1  # waits for a functional collective
    torch.cuda.synchronize()
    return bool(torch.equal(y.float(), want.float()))


def _probe_rank(rank: int, device, calls: tuple) -> dict:
    """One rank of phase 20: each ``(api, collective)`` on a CUDA tensor
    over every rank, checked, and its time a call (ms, after a warm-up)."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    out = {}
    for api, name in calls:
        ok = _probe_call(torch, api, name, rank, n, device)
        t0 = time.perf_counter()
        for _ in range(10):
            _probe_call(torch, api, name, rank, n, device)
        out[(api, name)] = ("ok" if ok else "wrong values",
                            (time.perf_counter() - t0) / 10 * 1e3)
    return out


def _probe_report(ranks: list) -> None:
    """Phase 20's probe, run by its ranks first: which collectives gloo
    carries on CUDA tensors, the ranks sharing the card, through c10d and
    through the functional API that DTensor uses (its all-gather routed by
    ``spawn``, ``distributed.route_gloo_all_gather``)."""
    for api, op in PROBE_CALLS:
        res = [r["probe"][(api, op)] for r in ranks]
        ok = all(v == "ok" for v, _ in res)
        print(f"shard: probe {MESH_BACKEND} {api} {op} on CUDA tensors, {len(ranks)} ranks on "
              f"one card: " + (f"ok, {max(ms for _, ms in res):.3f} ms a call" if ok
                               else res[0][0]))
        check(ok, f"gloo does not carry {api} {op} on CUDA tensors")
    print("shard: (gloo's own coalesced all-gather, which the functional one calls unrouted, "
          "crashes its rank on CUDA tensors: PERF.md §6); probe "
          f"{max(r['probe_s'] for r in ranks):.1f} s in the ranks")


def _train_parts(torch, cfg, device, steps: int, init: bool = True, microbatches: int = 1):
    """``build_trainer``'s parts for a config of our own (same seed, same
    optimizer), unsharded, at phase 20's batch (no parameters or optimizer
    state without ``init``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_model
    from repro_torch.train import data as data_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    model = get_model(cfg, device=device)
    tcfg = ts.TrainConfig(microbatches=microbatches, remat="none", opt=opt_lib.OptimizerConfig(
        peak_lr=1e-3, warmup_steps=max(10, steps // 20), total_steps=steps))
    params = model.init(torch.Generator().manual_seed(0)) if init else None
    return (model, params, None if params is None else opt_lib.init_opt_state(params, tcfg.opt),
            ts.make_train_step(model, tcfg),
            data_lib.SyntheticStream(model, ShapeSpec("p20", SHARD_SEQ, SHARD_BATCH, "train")))


def _moe_cfg(configs, compute: str = "bfloat16"):
    """DeepSeek-MoE-16B at full width, 2 layers (layer 0 dense, layer 1 of
    64 experts), with the capacity factor at E / k: an expert's capacity
    is then every token it may get, so no assignment drops on either path."""
    import dataclasses

    cfg = configs.get_config(MOE_ARCH)
    return dataclasses.replace(cfg, num_layers=2, capacity_factor=cfg.num_experts / cfg.top_k,
                               compute_dtype=compute)


def _run_steps(torch, parts, n: int, before_last=None, first=None
               ) -> tuple[list, float, object]:
    """``n`` steps: (losses, ms a step over all but the first, final state);
    ``first(state)`` runs after the first step and ``before_last(state)``
    before the last, both outside the clock."""
    _, params, opt_state, step, stream = parts
    losses, t0, t_out = [], None, 0.0
    for i in range(n):
        if i == 1:
            _sync_all(torch) if torch.distributed.is_initialized() else torch.cuda.synchronize()
            t0 = time.perf_counter()
        if before_last is not None and i == n - 1:
            t = time.perf_counter()
            before_last((params, opt_state))
            t_out += time.perf_counter() - t
        params, opt_state, m = step(params, opt_state, stream.batch(i))
        losses.append(float(m["loss"]))
        if first is not None and i == 0:
            first((params, opt_state))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0 - t_out) / max(n - 1, 1) * 1e3
    return losses, ms, (params, opt_state)


def _unsharded_run(torch, parts, n: int, moe: bool = False) -> dict:
    """``n`` unsharded steps: losses, the final parameters and AdamW's
    first moment after the first step on the host, ms a step (and the MoE
    layer's moe_dropped_frac at phase 20's batch)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.layers import cdtype

    mu, ids = {}, []
    undo = _record_routing(moe_lib, ids)
    try:
        losses, ms, (params, _) = _run_steps(
            torch, parts, n, first=lambda st: mu.update(_host_params(st[1]["mu"])))
    finally:
        undo()
    out = dict(losses=losses, params=_host_params(params), mu=mu, ms=ms)
    if moe:
        out["routing"] = ids[0]
        cfg = parts[0].cfg
        x = torch.randn((SHARD_BATCH, 64, cfg.d_model), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(3)).to(cdtype(cfg))
        out["dropped"] = float(moe_lib.moe_ffn(_layer0(params["layers"]["moe"]), x, cfg)[1][
            "moe_dropped_frac"])
    return out


def _record_routing(moe_lib, ids: list):
    """Make ``moe_lib.router_probs`` keep its first call's expert ids ``[T,
    k]`` (gathered, on the host) in ``ids``; returns what undoes it."""
    route = moe_lib.router_probs

    def record(*args, **kw):
        out = route(*args, **kw)
        if not ids:
            e = out[1]
            ids.append((e.full_tensor() if hasattr(e, "full_tensor") else e).cpu())
        return out

    moe_lib.router_probs = record
    return lambda: setattr(moe_lib, "router_probs", route)


def _flips(a, b) -> int:
    """Tokens whose expert sets differ between two ``[T, k]`` routings."""
    return int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())


def _update_gap(torch, got: dict, want: dict, init: dict) -> float:
    """How far ``got``'s update from ``init`` is from ``want``'s, relative
    to ``want``'s: ``|got - want| / |want - init|`` over every parameter.
    (The largest elementwise difference saturates: AdamW's first steps
    move a parameter whose gradient is rounding noise by about ``lr``
    whichever way the noise falls.)"""
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float(((want[k] - init[k]) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def _host_params(params) -> dict:
    from repro_torch.core.tree import tree_flatten_with_path

    return {"/".join(p): x.detach().float().cpu() for p, x in tree_flatten_with_path(params)[0]}


def _mu_gap(got: dict, want: dict, scale: dict) -> tuple[float, str]:
    """The largest elementwise difference of AdamW's first moment after the
    first step, ``(1 - b1) * g`` of the clipped gradient at the initial
    parameters, each leaf's over ``scale``'s (the unsharded leaf's largest
    magnitude): (the largest over leaves, its leaf).
    tests/test_torch_model_sharding.py holds it to 1e-5 on the CPU.  Unlike
    the update and the next loss, it moves with a gradient scaled by a
    constant (a combine counted twice)."""
    return max((float((got[k] - want[k]).abs().max()) / max(scale[k], 1e-30), k) for k in want)


def _shards(tree, *whole: dict) -> tuple:
    """This rank's shard of each DTensor leaf of ``tree`` on the host, and
    the same slices of each dict of whole arrays in ``whole`` (keyed by
    the leaves' paths): one dict each."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.core.tree import tree_flatten_with_path

    outs = tuple({} for _ in range(len(whole) + 1))
    for path, x in tree_flatten_with_path(tree)[0]:
        key = "/".join(path)
        shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                              x.placements)
        outs[0][key] = x.to_local().float().cpu()
        for out, w in zip(outs[1:], whole):
            w = w[key]
            for d, (o, n) in enumerate(zip(offset, shape)):
                w = w.narrow(d, o, n)
            out[key] = w
    return outs


def _local_gaps(torch, params, mu: tuple, ref: dict, init: dict) -> dict:
    """This rank's shards of the final parameters and of ``mu``, AdamW's
    first moment after the first step (its shards and the unsharded run's
    slices), against the unsharded run's: the update gap of
    :func:`_update_gap`, the largest elementwise parameter difference and
    the first-moment gap of :func:`_mu_gap`."""
    got, want, start = _shards(params, ref["params"], init)
    gap, leaf = _mu_gap(*mu, ref["mu_scale"])
    return dict(update=_update_gap(torch, got, want, start),
                worst=max(float((got[k] - want[k]).abs().max()) for k in want),
                mu=gap, mu_leaf=leaf)


def _shard_rank(rank: int, device, work: str) -> dict:
    """One rank of phase 20 on the ``(data 2, model 2)`` mesh: SmolLM-135M
    through ``build_trainer(mesh=)``, a checkpoint resharded off and back
    onto the mesh, and DeepSeek-MoE's expert-parallel steps, each held to
    the parent's unsharded run (written to ``work``)."""
    import gc

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as moe_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"rank": rank, "device": str(device)}
    if torch.distributed.get_backend() == MESH_BACKEND:  # (0) the probe
        t0 = time.perf_counter()
        out["probe"] = _probe_rank(rank, device, PROBE_CALLS)
        out["probe_s"] = time.perf_counter() - t0
    ref = torch.load(Path(work) / "unsharded.pt", weights_only=False, mmap=True)
    mesh = mesh_lib.make_mesh(*SHARD_MESH, device_type="cuda")

    # (a) SmolLM-135M, full width and depth, through the launcher (bf16):
    # its collectives and its time a step.
    t0 = time.perf_counter()
    _, params, opt_state, step, stream = launch_train.build_trainer(
        ARCH, seq_len=SHARD_SEQ, global_batch=SHARD_BATCH, steps=SHARD_STEPS, lr=1e-3,
        microbatches=1, remat="none", smoke=False, mesh=mesh)
    with CommDebugMode() as comm:
        params, opt_state, m1 = step(params, opt_state, stream.batch(0))
    out["comm"] = {str(k): v for k, v in comm.get_comm_counts().items()}
    _sync_all(torch)
    t1 = time.perf_counter()
    params, opt_state, m2 = step(params, opt_state, stream.batch(1))
    losses = [float(m1["loss"]), float(m2["loss"])]  # (reading the loss waits for the card)
    out["smollm"] = dict(losses=losses, ms=(time.perf_counter() - t1) * 1e3,
                         seconds=time.perf_counter() - t0)
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()

    # (b) SmolLM at F32_LAYERS layers in float32 compute, its state saved
    # after step 2, restored whole and back onto the mesh, and step 3
    # replayed; the same at SHARD_MICROBATCHES; (c) DeepSeek-MoE-16B's
    # expert-parallel path at full width, 2 layers, in float32.  Each is
    # held to its unsharded float32 run, where only the order of the sums
    # differs.
    cfg32 = _f32(_smollm_cfg(configs))
    out["smollm32"] = _sharded_run(torch, cfg32, device, mesh, SHARD_STEPS, ref["smollm"],
                                   ckpt=Path(work) / "ckpt", count=True)
    out["mb"] = _sharded_run(torch, cfg32, device, mesh, MB_STEPS, ref["mb"],
                             microbatches=SHARD_MICROBATCHES, count=True)
    calls = []
    ep = moe_lib._moe_ep
    moe_lib._moe_ep = lambda *a, **k: calls.append(1) or ep(*a, **k)
    out["moe"] = _sharded_run(torch, _moe_cfg(configs, "float32"), device, mesh, MOE_STEPS,
                              ref["moe"], moe=True)
    moe_lib._moe_ep = ep
    out["moe"]["ep_calls"] = len(calls)
    return out


def _f32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, compute_dtype="float32")


def _smollm_cfg(configs):
    import dataclasses

    return dataclasses.replace(configs.get_config(ARCH), num_layers=F32_LAYERS)


def _sharded_run(torch, cfg, device, mesh, n: int, ref: dict, moe: bool = False,
                 ckpt: Path | None = None, microbatches: int = 1, count: bool = False) -> dict:
    """``n`` steps of ``cfg`` on the mesh, the weights made on the host
    (placing them moves one leaf at a time to the card, so four ranks do
    not each hold the whole model there): losses, ms a step, its
    parameters' and first moment's shards against the unsharded run's
    ``ref`` (:func:`_local_gaps`; and the MoE layer's moe_dropped_frac).  With
    ``ckpt``, the state after step ``n - 1`` is saved there, restored whole
    (held to the gathered DTensors) and back onto the mesh, and step ``n``
    replayed from it.  With ``count``, this rank's FLOPs in the first
    step (untimed) are counted (``op_cost``)."""
    import gc

    from repro_torch.launch import op_cost
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import shard_ctx
    from repro_torch.models.layers import cdtype
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import fault_tolerance as ft

    t0 = time.perf_counter()
    _, params, opt_state, _, _ = _train_parts(torch, cfg, "cpu", n)
    init = _host_params(params)
    model, _, _, step, stream = _train_parts(torch, cfg, device, n, init=False,
                                             microbatches=microbatches)
    params, opt_state, step = launch_train.shard_trainer(model, params, opt_state, step, mesh,
                                                         SHARD_BATCH)
    kept: dict = {}
    flops: list = []

    def first_counted(*args):
        if flops or not count:
            return step(*args)
        out, cost = op_cost.count(step, *args, meshes=[mesh])
        flops.append(cost.flops)
        return out

    def save(state):
        t = time.perf_counter()
        ckpt_lib.Checkpointer(str(ckpt)).save(n - 1, state)
        kept.update(save_s=time.perf_counter() - t, gathered=ft.reshard(state, "cpu"))

    ids: list = []
    undo = _record_routing(moe_lib, ids)
    try:
        losses, ms, (params, opt_state) = _run_steps(
            torch, (model, params, opt_state, first_counted, stream), n,
            before_last=None if ckpt is None else save,
            first=lambda st: kept.update(mu=_shards(st[1]["mu"], ref["mu"])))
    finally:
        undo()
    out = dict(losses=losses, ms=ms, gaps=_local_gaps(torch, params, kept["mu"], ref, init),
               flops=flops[0] if flops else None)
    if ckpt is not None:
        ck, gathered = ckpt_lib.Checkpointer(str(ckpt)), kept["gathered"]
        whole = ck.restore(n - 1, like=gathered)
        out["restore_unsharded_exact"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(whole), _leaves(gathered)))
        back = ck.restore(n - 1, like=gathered, shardings=(
            sh.param_shardings(gathered[0], mesh),
            sh.opt_state_shardings(gathered[1], gathered[0], mesh)))
        _, _, m = step(*back, stream.batch(n - 1))
        out.update(replay=(float(m["loss"]), losses[-1]), save_s=kept["save_s"])
    if moe:
        x = torch.randn((SHARD_BATCH, 64, cfg.d_model), device=device,
                        generator=torch.Generator(device).manual_seed(3)).to(cdtype(cfg))
        x = sh.distribute({"x": x}, {"x": sh.NamedSharding(mesh, ("data", None, None))})["x"]
        with shard_ctx.use_rules(model.axis_rules):
            _, aux = moe_lib.moe_ffn(_layer0(params["layers"]["moe"]), x, cfg)
        out["dropped"] = float(aux["moe_dropped_frac"])
        out["flips"] = _flips(ids[0], ref["routing"])
    out["seconds"] = time.perf_counter() - t0
    del params, opt_state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _leaves(tree) -> list:
    from repro_torch.core.tree import tree_flatten

    return tree_flatten(tree)[0]


def _layer0(tree):
    """The first layer of a dict of stacked tensors."""
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t[0], tree)


def phase_model_sharding(torch, smi: str, backend: str = MESH_BACKEND) -> None:
    """Phase 20: model sharding.  Four ranks share the card over gloo on a
    ``(data 2, model 2)`` mesh: SmolLM-135M at full width and depth through
    ``build_trainer(mesh=)``, a checkpoint resharded off the mesh and back
    with a replayed step, and DeepSeek-MoE-16B's expert-parallel path at
    full width, each held to the same steps unsharded on the card.  With
    ``backend="nccl"`` on four cards (``--model-sharding nccl``) each rank
    has a card of its own and gloo is not probed."""
    from repro_torch import configs, distributed

    t_phase = time.perf_counter()
    work = ROOT / "build" / "phase20"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # (1) The unsharded runs on the card in float32 compute (the
    # reference) and in bf16 (the control that the limits must tell from
    # it), each freed before the next (and what earlier phases left cached,
    # before the first).
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    ref, control, plain_ms, dropped, flips = {}, {}, {}, (), 0
    # SmolLM at full depth in bf16, beside the ranks' build_trainer steps.
    full = _train_parts(torch, configs.get_config(ARCH), "cuda", SHARD_STEPS)
    ref["full_bf16_losses"], plain_ms["full"] = _run_steps(torch, full, 2)[:2]
    del full
    gc.collect()
    torch.cuda.empty_cache()
    for what, cfg, n in (("smollm", _smollm_cfg(configs), SHARD_STEPS),
                         ("moe", _moe_cfg(configs), MOE_STEPS)):
        # One set of initial weights for both (they do not depend on the
        # compute dtype, and a step does not write its inputs).
        model, params, opt_state, step, stream = _train_parts(torch, cfg, "cuda", n)
        init = _host_params(params)
        bf16 = _unsharded_run(torch, (model, params, opt_state, step, stream), n,
                              moe=what == "moe")
        gc.collect()
        torch.cuda.empty_cache()
        model, _, _, step, stream = _train_parts(torch, _f32(cfg), "cuda", n, init=False)
        f32 = _unsharded_run(torch, (model, params, opt_state, step, stream), n,
                             moe=what == "moe")
        del model, params, opt_state, step, stream
        scale = {k: float(v.abs().max()) for k, v in f32["mu"].items()}
        ref[what] = dict(losses=f32["losses"], params=f32["params"], mu=f32["mu"],
                         mu_scale=scale)
        ref[f"{what}_bf16_losses"], plain_ms[what] = bf16["losses"], (bf16["ms"], f32["ms"])
        if what == "moe":
            dropped = (bf16["dropped"], f32["dropped"])
            ref[what]["routing"] = f32["routing"]
            flips = _flips(bf16["routing"], f32["routing"])
        control[what] = dict(
            loss=max(abs(a - b) for a, b in zip(bf16["losses"], f32["losses"])),
            update=_update_gap(torch, bf16["params"], f32["params"], init),
            mu=_mu_gap(bf16["mu"], f32["mu"], scale)[0])
        del bf16, f32
        gc.collect()
        torch.cuda.empty_cache()
    # The reference of the ranks' steps at SHARD_MICROBATCHES.
    f32 = _unsharded_run(torch, _train_parts(torch, _f32(_smollm_cfg(configs)), "cuda",
                                             MB_STEPS, microbatches=SHARD_MICROBATCHES),
                         MB_STEPS)
    ref["mb"] = dict(losses=f32["losses"], params=f32["params"], mu=f32["mu"],
                     mu_scale={k: float(v.abs().max()) for k, v in f32["mu"].items()})
    plain_ms["mb"] = f32["ms"]
    del f32
    gc.collect()
    torch.cuda.empty_cache()  # (the ranks need the card)
    torch.save(ref, work / "unsharded.pt")
    for what in ("smollm", "moe", "mb"):  # the ranks read the files
        ref[what] = {"losses": ref[what]["losses"]}
    gc.collect()
    print(f"shard: unsharded on the card ({smi}): SmolLM-135M full width and depth, "
          f"{SHARD_BATCH} x {SHARD_SEQ}, bf16: {plain_ms['full']:.1f} ms a step, losses "
          f"{ref['full_bf16_losses']}")
    for what, name, n in (("smollm", f"SmolLM-135M full width, {F32_LAYERS} layers, "
                           f"{SHARD_BATCH} x {SHARD_SEQ}", SHARD_STEPS),
                          ("moe", f"DeepSeek-MoE-16B full width, 2 layers, {SHARD_BATCH} x "
                           f"{SHARD_SEQ}, capacity factor {_moe_cfg(configs).capacity_factor:.3f}",
                           MOE_STEPS)):
        c = control[what]
        print(f"shard: unsharded on the card ({smi}): {name}: bf16 {plain_ms[what][0]:.1f} "
              f"ms a step, float32 {plain_ms[what][1]:.1f}; losses bf16 "
              f"{ref[f'{what}_bf16_losses']}, float32 {ref[what]['losses']}; the bf16 control "
              f"against float32 compute over {n} steps: losses within {c['loss']!r}, update "
              f"gap {c['update']!r}, first-moment gap {c['mu']!r} (limits {SHARD_TOL[what]})")
        check(all(c[k] > SHARD_TOL[what][k] for k in c),
              f"{what}: the bf16 control is within a float32 limit, which then cannot tell "
              f"bf16 from float32 compute")
    print(f"shard: unsharded moe_dropped_frac bf16 {dropped[0]}, float32 {dropped[1]}; the "
          f"first step's routing: {flips} of {SHARD_BATCH * SHARD_SEQ} tokens take another "
          f"expert set in bf16 than in float32")
    check(dropped == (0.0, 0.0), "the unsharded MoE dropped assignments")

    # (2) The ranks.
    t0 = time.perf_counter()
    ranks = distributed.spawn(_shard_rank, int(np.prod(SHARD_MESH[0])), rendezvous_dir=work,
                              backend=backend, args=(str(work),), timeout=900)
    t_ranks = time.perf_counter() - t0
    if backend == MESH_BACKEND:
        _probe_report(ranks)
    r0 = ranks[0]
    print(f"shard: {len(ranks)} ranks on {torch.cuda.device_count()} card(s) over {backend}, "
          f"on {sorted({r['device'] for r in ranks})}, mesh "
          f"{dict(zip(SHARD_MESH[1], SHARD_MESH[0]))}; collectives in SmolLM's first step "
          f"(rank 0, DTensor's CommDebugMode): {r0['comm']}")
    for r in ranks:
        s = r["smollm"]
        dl = max(abs(a - b) for a, b in zip(s["losses"], ref["full_bf16_losses"]))
        print(f"shard: rank {r['rank']} SmolLM-135M through build_trainer(mesh=), bf16: "
              f"{s['ms']:.1f} ms a step (unsharded {plain_ms['full']:.1f}), losses "
              f"{s['losses']}, within {dl:.3g} of the unsharded bf16 run's (two bf16 runs "
              f"that round their sums in other places; not held)")
        one, more = r["smollm32"]["flops"], r["mb"]["flops"]
        print(f"shard: rank {r['rank']} SmolLM-135M float32 at {F32_LAYERS} layers, this "
              f"rank's counted FLOPs in a step: {one:.6e} at one microbatch, {more:.6e} at "
              f"{SHARD_MICROBATCHES} ({more / one:.4f}x)")
        check(abs(more - one) <= 0.03 * one, f"rank {r['rank']}: {more:.6e} FLOPs at "
              f"{SHARD_MICROBATCHES} microbatches against {one:.6e} at one")
        runs = [(f"SmolLM-135M float32 at {F32_LAYERS} layers", r["smollm32"], "smollm",
                 "smollm", SHARD_STEPS),
                (f"SmolLM-135M float32 at {F32_LAYERS} layers, {SHARD_MICROBATCHES} "
                 f"microbatches (unsharded {plain_ms['mb']:.1f} ms a step)", r["mb"], "mb",
                 "smollm", MB_STEPS),
                ("DeepSeek-MoE-16B float32", r["moe"], "moe", "moe", MOE_STEPS)]
        for what, got, key, tol, n in runs:
            gaps = dict(got["gaps"], loss=max(abs(a - b) for a, b in zip(
                got["losses"], ref[key]["losses"])))
            print(f"shard: rank {r['rank']} {what} sharded: {got['ms']:.1f} ms a step, losses "
                  f"{got['losses']}; against the unsharded float32 run after {n} steps, its "
                  f"shards: losses within {gaps['loss']!r}, update gap {gaps['update']!r}, "
                  f"first-moment gap {gaps['mu']!r} ({gaps['mu_leaf']}) (limits {SHARD_TOL[tol]}; "
                  f"largest elementwise parameter difference {gaps['worst']!r}); "
                  f"{got['seconds']:.1f} s")
            check(all(gaps[k] <= v for k, v in SHARD_TOL[tol].items()),
                  f"rank {r['rank']} {what}: the sharded steps left the float32 limits")
        check(r["moe"]["ep_calls"] == MOE_STEPS + 1, f"rank {r['rank']}: "
              f"{r['moe']['ep_calls']} expert-parallel calls in {MOE_STEPS} steps and the "
              f"moe_dropped_frac read")
        s32 = r["smollm32"]
        check(s32["restore_unsharded_exact"], f"rank {r['rank']}: the unsharded restore differs")
        check(s32["replay"][0] == s32["replay"][1],
              f"rank {r['rank']}: the replayed step {SHARD_STEPS} lost {s32['replay']}")
    print(f"shard: moe_dropped_frac expert-parallel {r0['moe']['dropped']} (not tracked there, "
          f"as in the reference); the expert-parallel path ran once a step on every rank, and "
          f"once for that read; the first step's routing: {r0['moe']['flips']} of "
          f"{SHARD_BATCH * SHARD_SEQ} tokens take another expert set than unsharded (float32)")
    s32 = r0["smollm32"]
    print(f"shard: SmolLM float32, checkpoint of step {SHARD_STEPS - 1} saved in "
          f"{s32['save_s']:.2f} s (gathered, rank 0 writes), restored unsharded bit-identical to "
          f"the gathered DTensors and back onto the mesh; step {SHARD_STEPS} replayed with loss "
          f"{s32['replay'][0]!r} = {s32['replay'][1]!r}; SmolLM bf16 part "
          f"{r0['smollm']['seconds']:.1f} s on rank 0")
    shutil.rmtree(work, ignore_errors=True)
    print(f"shard: phase took {time.perf_counter() - t_phase:.1f} s (ranks {t_ranks:.1f} s)")


# ---------------------------------------------------------------------------
# 21. the dry-run against the card
# ---------------------------------------------------------------------------

# The dry-run's peak of each counted step over the card's
# (``max_memory_allocated`` over the step, the arguments added back): the
# counter sees storages, the allocator rounds blocks and keeps its own
# workspaces (PERF.md, PR 25, fixed before the first run).
DRYRUN_PEAK_RATIO = (0.9, 1.1)
# Phase 21's train step (one card, SmolLM-135M, bf16, remat none) and
# decode step (phase 9's K4 shape: 64 sequences, a 512-row cache).
COUNT_TRAIN = dict(batch=4, seq=1024, microbatches=2)
COUNT_DECODE = dict(batch=64, window=512)


# Phase 21's production-mesh dry-runs, ``(arch, shape, mesh)``: SmolLM-135M's
# decode on both meshes, and DeepSeek-MoE-16B's prefill of 32 sequences on
# 2 x 32 x 8, whose 64 data ranks do not divide its batch (it shards over
# ``data`` alone, ``launch.mesh.batch_axes``).
DRYRUN_CELLS = ((ARCH, "decode_32k", "32x8"), (ARCH, "decode_32k", "2x32x8"),
                (MOE_ARCH, "prefill_32k", "2x32x8"))


def _dryrun_cells() -> dict:
    """``DRYRUN_CELLS`` as subprocesses started together (CPU work only:
    ``main`` starts them before the build and phase 21 reads them; they are
    stopped at exit whatever happens)."""
    import atexit

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for cell in DRYRUN_CELLS:
        arch, shape, mesh = cell
        name = f"phase21_dryrun_{arch}_{shape}_{mesh}"
        out = out_dir / f"{name}.json"
        with open(out_dir / f"{name}.log", "w") as log:
            procs[cell] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--out", str(out)]
                + (["--multi-pod"] if mesh == "2x32x8" else []),
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT), out)
            atexit.register(procs[cell][0].kill)
    return procs


def _hold_counted(torch, name: str, fake_step, fake_args, step, args, smi: str,
                  kernel: str | None = None, counter=None, want: int = 0):
    """``name``'s step counted by the op counter on meta tensors (the
    dry-run: ``fake_step(*fake_args)`` within ``fake.modeling()``) and on the
    card (``step(*args)``, after a warm-up and one timed call): FLOPs,
    bytes, ops, counted peaks and ``kernel``'s records equal, the records
    equal to the ``want`` launches that ``counter`` saw in the counted call;
    the dry-run's peak over the card allocator's within
    ``DRYRUN_PEAK_RATIO``; ``t_compute`` / ``t_memory`` beside the measured
    ms.  Returns the card's output."""
    from repro_torch import fake
    from repro_torch.launch import dryrun, op_cost

    with fake.modeling():
        t0 = time.perf_counter()
        _, fake_cost = op_cost.count(fake_step, *fake_args)
        t_fake = time.perf_counter() - t0
    step(*args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if counter is not None:
        counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out, real_cost = op_cost.count(step, *args)
    torch.cuda.synchronize()
    counted_ms = (time.perf_counter() - t0) * 1e3
    card_peak = torch.cuda.max_memory_allocated() - before + real_cost.argument_bytes
    launches = counter.launches if counter is not None else 0
    k_fake, k_real = fake_cost.kernels.get(kernel, {}), real_cost.kernels.get(kernel, {})
    ratio = fake_cost.peak_bytes / card_peak
    print(f"dryrun: {name}: counted on meta tensors in {t_fake:.2f} s: {fake_cost.flops:.6e} "
          f"FLOPs, {fake_cost.bytes_accessed:.6e} bytes, {fake_cost.op_count} ops, peak "
          f"{fake_cost.peak_bytes} bytes; on the card: {real_cost.flops:.6e} FLOPs, "
          f"{real_cost.bytes_accessed:.6e} bytes, {real_cost.op_count} ops, peak "
          f"{real_cost.peak_bytes} bytes"
          + (f"; {kernel} records {k_fake} (dry-run) / {k_real} (card), {launches} launches"
             if kernel else ""))
    print(f"dryrun: {name}: card max_memory_allocated over the step + arguments "
          f"{card_peak / 1e9:.4f} GB (arguments {real_cost.argument_bytes / 1e9:.4f} GB); "
          f"dry-run / card {ratio:.4f} (held to {DRYRUN_PEAK_RATIO})")
    t_c = fake_cost.flops / dryrun.PEAK_FLOPS * 1e3
    t_m = fake_cost.bytes_accessed / dryrun.HBM_BW * 1e3
    print(f"dryrun: {name}: t_compute {t_c:.3f} ms, t_memory {t_m:.3f} ms (datasheet "
          f"constants) against {plain_ms:.3f} ms measured ({counted_ms:.3f} ms under the "
          f"counter); measured / max term {plain_ms / max(t_c, t_m):.2f} ({smi})")
    for what, a, c in (("FLOPs", fake_cost.flops, real_cost.flops),
                       ("bytes", fake_cost.bytes_accessed, real_cost.bytes_accessed),
                       ("ops", fake_cost.op_count, real_cost.op_count),
                       ("counted peaks", fake_cost.peak_bytes, real_cost.peak_bytes),
                       (f"{kernel} records", k_fake, k_real)):
        check(a == c, f"{name}: {what} differ: dry-run {a}, card {c}")
    if kernel:
        check(k_real.get("count") == launches == want,
              f"{name}: {kernel} records {k_real.get('count')}, launches {launches}, "
              f"want {want}")
    check(DRYRUN_PEAK_RATIO[0] <= ratio <= DRYRUN_PEAK_RATIO[1],
          f"{name}: dry-run peak / card peak {ratio:.4f} outside {DRYRUN_PEAK_RATIO}")
    return out


def _counted_steps(torch, smi: str) -> None:
    """Phase 8's prefill, a SmolLM-135M train step at two microbatches and a
    decode step at phase 9's K4 shape, each held by :func:`_hold_counted`."""
    from repro_torch import configs, fake
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models import get_model
    from repro_torch.serve.steps import make_prefill_step, make_serve_step
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    cfg = configs.get_config(ARCH)
    host = get_model(cfg, device="cpu")
    meta_params = fake.build_meta(lambda: host.init(torch.Generator().manual_seed(0)))
    model = get_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    meta = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")  # noqa: E731

    def tokens(seed, *shape, high=cfg.vocab_size):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, high, shape).astype(np.int32)).cuda()

    b, s = 8, 2048
    out = _hold_counted(
        torch, f"prefill {ARCH} bf16 {b} x {s}",
        make_prefill_step(get_model(cfg, use_flash=True, device="meta")),
        (meta_params, {"tokens": meta(b, s)}),
        make_prefill_step(get_model(cfg, use_flash=True, device="cuda")),
        (params, {"tokens": tokens(10, b, s)}),
        smi, "flash_attention", fa_ops.flash_attention, cfg.num_layers)
    check(tuple(out.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(out).all()),
          "counted prefill logits not finite")

    b, s, n = COUNT_TRAIN["batch"], COUNT_TRAIN["seq"], COUNT_TRAIN["microbatches"]
    tcfg = ts.TrainConfig(microbatches=n, remat="none", opt=opt_lib.OptimizerConfig())
    _, _, metrics = _hold_counted(
        torch, f"train step {ARCH} bf16 {b} x {s}, {n} microbatches, remat none",
        ts.make_train_step(get_model(cfg, device="meta"), tcfg),
        (meta_params, opt_lib.init_opt_state(meta_params, tcfg.opt), {"tokens": meta(b, s)}),
        ts.make_train_step(model, tcfg),
        (params, opt_lib.init_opt_state(params, tcfg.opt), {"tokens": tokens(11, b, s)}), smi)
    check(bool(torch.isfinite(metrics["loss"])), "counted train step's loss not finite")

    b, w = COUNT_DECODE["batch"], COUNT_DECODE["window"]
    new_tok, _ = _hold_counted(
        torch, f"decode step {ARCH} bf16, {b} sequences, a {w}-row cache",
        torch.no_grad()(make_serve_step(get_model(cfg, device="meta"))),
        (meta_params, fake.build_meta(lambda: host.init_cache(b, w)), meta(b), meta(b),
         meta(2)),
        torch.no_grad()(make_serve_step(model)),
        (params, model.init_cache(b, w), tokens(12, b), tokens(13, b, high=w),
         torch.zeros((2,), dtype=torch.int32, device="cuda")),
        smi, "decode_attention", fd_ops.decode_attention, cfg.num_layers)
    check(tuple(new_tok.shape) == (b,) and bool(((new_tok >= 0) & (new_tok < cfg.vocab_size))
                                               .all()), "counted decode step's tokens")


def _nuts_aot(torch, run6: dict, launches6: dict) -> None:
    """Phase 6's NUTS through its AOT handle and ``step_fn``."""
    from repro_torch.kernels.stack_ops import ops

    kern, args = run6["kern"], run6["args"]
    t0 = time.perf_counter()
    handle = kern.lower(*args)
    text = handle.as_text()
    handle.compile()
    handle.compile()  # idempotent: no second run
    torch.cuda.synchronize()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    cost = handle.cost_analysis()
    t_cost = time.perf_counter() - t0
    check(set(cost) == {"flops", "bytes accessed"} and cost["flops"] > 0
          and cost["bytes accessed"] > 0, f"cost_analysis gave {cost}")
    print(f"dryrun: NUTS lower(): {text.count(chr(10)) + 1} lines of lowered IR, compile "
          f"{t_compile:.2f} s, cost_analysis {t_cost:.2f} s: {cost['flops']:.6e} FLOPs, "
          f"{cost['bytes accessed']:.6e} bytes (one pass of the pick and every block)")

    st = kern.stepper(*args)
    vm, state, step = st.vm, st.init(), st.vm.step_fn()
    ops.masked_push.launches = ops.masked_peek.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while vm.live(state):
        state = step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    push, peek = ops.masked_push.launches, ops.masked_peek.launches
    got, res = st.result(state), vm.result(state)
    want, res6 = run6["out"], run6["res"]
    for k in want:
        check(torch.equal(got[k], want[k]), f"step_fn's {k} differs from phase 6's run")
    check(res.steps == res6.steps, f"step_fn took {res.steps} steps, run() {res6.steps}")
    check(np.array_equal(np.asarray(res.block_exec), np.asarray(res6.block_exec)),
          "step_fn's block_exec differs from phase 6's")
    check((push, peek) == (launches6["masked_push"], launches6["masked_peek"]),
          f"step_fn launched K1/K2 {push}/{peek}, phase 6 "
          f"{launches6['masked_push']}/{launches6['masked_peek']}")
    print(f"dryrun: NUTS step_fn to the end: {res.steps} steps in {wall:.3f} s, bit-exact "
          f"with phase 6 (outputs, steps, block_exec, K1/K2 launches {push}/{peek})")


def phase_dryrun(torch, run6: dict, launches6: dict, smi: str, procs: dict) -> None:
    t0 = time.perf_counter()
    _counted_steps(torch, smi)
    _nuts_aot(torch, run6, launches6)
    for (arch, shape, mesh), (proc, out) in procs.items():
        what = f"{arch} x {shape} on {mesh}"
        code = proc.wait(timeout=600)
        check(code == 0, f"dryrun {what} exited {code} (chiprun_out/{out.stem}.log)")
        rec = json.load(open(out))[0]
        chips = 512 if mesh == "2x32x8" else 256
        check(rec["chips"] == chips and rec["mesh"] == mesh,
              f"dryrun {what}: chips {rec['chips']}, mesh {rec['mesh']}")
        check(rec["bottleneck"] in ("compute", "memory", "collective") and rec["peak_bytes"] > 0,
              f"dryrun {what}: bottleneck {rec['bottleneck']}, peak {rec['peak_bytes']}")
        check(rec["fits"], f"dryrun {what}: peak {rec['peak_bytes']} bytes does not fit")
        print(f"dryrun: {what} ({chips} chips; counts against the H100 datasheet "
              f"constants, not card measurements): {rec['hlo_flops']:.4e} FLOPs a card, "
              f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}, t_compute "
              f"{rec['t_compute'] * 1e3:.4f} ms, t_memory {rec['t_memory'] * 1e3:.4f} ms, "
              f"t_collective {rec['t_collective'] * 1e3:.4f} ms, bound {rec['bottleneck']}, "
              f"peak {rec['peak_bytes'] / 1e9:.3f} GB (fits {rec['fits']}), "
              f"set-up {rec['lower_s']} s, step {rec['compile_s']} s")
    print(f"dryrun: phase 21 {time.perf_counter() - t0:.1f} s")


def main() -> int:
    # cuBLAS picks its workspace when it makes a handle, so the setting
    # that phase 15's deterministic mode asks for comes before any CUDA work.
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 2
    from repro_torch.mcmc import nuts

    if sys.argv[1:2] == ["--model-sharding"]:
        # Phase 20 alone over the backend named (nccl: one card a rank).
        smi = phase_env(torch)
        phase_model_sharding(torch, smi, backend=sys.argv[2])
        return 0
    t_smoke = time.perf_counter()
    settings = nuts.NutsSettings(max_tree_depth=10, num_steps=2, steps_per_leaf=4)
    smi = phase_env(torch)
    dryrun_procs = _dryrun_cells()  # on the host's CPUs beside the build
    phase_build()
    kernels = phase_kernels(torch, nuts.recommended_max_depth(settings), CHAINS)
    phase_vm(torch, 256)
    phase_nuts(torch)
    launches, run6 = phase_full(torch, CHAINS, settings)
    kernels.update(phase_attention_kernels(torch))
    launches["flash_attention"] = phase_prefill(torch)
    k4_closed, run9 = phase_engine(torch)
    print(f"engine: K4 launches {k4_closed} on the closed-loop path")
    phase_paper(torch, settings)
    phase_segments(torch, run6, launches)
    launches["decode_attention"], run12 = phase_serve(torch)
    phase_pgo(torch, run6, launches, settings, smi)
    phase_frontend(torch, run6, smi)
    phase_train(torch, smi)
    for name, err in phase_families(torch, smi).items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    for name, err in phase_multimodal(torch, smi).items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    phase_chaos(torch)
    phase_mesh(torch, settings, run6, run9, run12, smi)
    phase_model_sharding(torch, smi)
    phase_dryrun(torch, run6, launches, smi, dryrun_procs)

    kdir = "src/repro_torch/kernels"
    where = {
        "masked_push": ("stack_ops/csrc/stack_ops.cu", "src/repro/kernels/stack_ops/kernel.py:41"),
        "masked_peek": ("stack_ops/csrc/stack_ops.cu", "src/repro/kernels/stack_ops/kernel.py:83"),
        "flash_attention": ("flash_attention/csrc/flash_attention_sm90.cu",
                            "src/repro/kernels/flash_attention/kernel.py:81"),
        "decode_attention": ("flash_decode/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_decode/kernel.py:77"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{kdir}/{src}",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"]}
        for name, (src, replaces) in where.items()]}
    print(f"smoke: every phase in {time.perf_counter() - t_smoke:.1f} s (limit 1200 s, "
          f"the build included) on {smi}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
