#!/usr/bin/env python3
"""Fault-injection chaos harness for the PyTorch port's fault containment.

    python tools/torch_chaos.py [--device cpu] [--batch 16] [--rate 0.25]
                                [--seed 0] [--json PATH]

The counterpart of ``tools/chaos.py`` for ``repro_torch``, on the CUDA card
unless ``--device`` names another.  One deliberately hostile program
selects a per-lane behaviour with its ``mode`` input:

* ``mode 0`` — healthy: a bounded Collatz-flavoured loop (the control);
* ``mode 1`` — NaN: writes ``0/0`` into VM state (``nonfinite``);
* ``mode 2`` — livelock: a data-dependent loop that never exits
  (``watchdog``, through ``lane_step_budget``);
* ``mode 3`` — bomb: recursion deeper than ``max_depth``
  (``stack_overflow``).

For every cell of the schedule x fuse matrix it runs the batch twice
through one executor under ``on_fault="quarantine"`` — fault-free (every
lane mode 0) and with faults injected at ``--rate`` (modes 1-3 in turn) —
and checks that

1. the chaotic run never aborts;
2. every injected lane reports exactly its fault code, and no healthy lane
   any;
3. the healthy lanes' outputs are bit-exact with the fault-free run.

:func:`run_cell` takes ``mesh=`` as the JAX harness's does (each rank of a
``torch.distributed`` process group calls it; the command line runs one
device).  Exit status 1 on any violation; ``--json`` writes a strict-JSON record per cell.

:class:`ChaosModel` is the serving side of the same harness: a language
model wrapper whose sentinel prompts NaN-poison or livelock their own lane
(``python -m benchmarks.torch_serve_bench --chaos``).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch
import torch.utils._pytree as pytree

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from repro_torch import distributed  # noqa: E402
from repro_torch.core import batching, frontend, pc_vm  # noqa: E402
from repro_torch.core.frontend import F32, I32  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serve.engine import _cache_layout  # noqa: E402

#: The harness's VM limits: the bomb recurses past MAX_DEPTH and the
#: livelock spins past LANE_STEP_BUDGET; healthy lanes run < 200
#: dispatches at depth 2.
MAX_DEPTH = 8
LANE_STEP_BUDGET = 512
BOMB_DEPTH = 4 * MAX_DEPTH

#: mode -> the lane's fault code after a quarantined run.
EXPECT_CODE = {
    0: pc_vm.FAULT_OK,
    1: pc_vm.FAULT_NONFINITE,
    2: pc_vm.FAULT_WATCHDOG,
    3: pc_vm.FAULT_STACK_OVERFLOW,
}
FAULT_MODES = (1, 2, 3)


def build_chaos_program():
    """``chaos(x, mode) -> out``: per-lane behaviour selected by ``mode``
    (the same CFG as ``tools/chaos.py``'s, so both packages lower it to the
    same blocks)."""
    pb = frontend.ProgramBuilder(main="chaos")

    # Unbounded recursion helper (mode 3's stack bomb).
    rec = pb.function("rec", ["n"], ["r"], {"n": I32}, {"r": I32})
    rec.const(0, torch.int32, out="r")
    rec.assign("go", lambda n: n > 0, ["n"], name="rec_cond")
    with rec.if_("go"):
        rec.assign("nm1", lambda n: n - 1, ["n"], name="rec_dec")
        rec.call("rec", ["nm1"], out="sub")
        rec.assign("r", lambda s: s + 1, ["sub"], name="rec_inc")
    rec.return_()
    pb.add(rec)

    fb = pb.function("chaos", ["x", "mode"], ["out"], {"x": I32, "mode": I32},
                     {"out": F32})
    fb.const(0.0, torch.float32, out="out")
    # ---- healthy control work (every mode runs it) ----
    fb.assign("v", lambda x: x % 97 + 1, ["x"], name="seed_v")
    fb.const(0, torch.int32, out="i")
    with fb.while_(lambda i, v: torch.logical_and(i < 32, v != 1), ["i", "v"]):
        fb.assign("v", lambda v: torch.where(v % 2 == 0, v // 2, 3 * v + 1),
                  ["v"], name="collatz")
        fb.assign("i", lambda i: i + 1, ["i"], name="inc_i")
    fb.assign("out", lambda v, i: (v * 100 + i).to(torch.float32), ["v", "i"],
              name="healthy_out")
    # ---- mode 1: non-finite write ----
    fb.assign("is_nan", lambda m: m == 1, ["mode"], name="sel_nan")
    with fb.if_("is_nan"):
        fb.assign("out", lambda o: o * float("nan"), ["out"], name="poison")
    # ---- mode 2: livelock (v >= 1 here, forever) ----
    fb.assign("is_live", lambda m: m == 2, ["mode"], name="sel_live")
    with fb.if_("is_live"):
        with fb.while_(lambda v: v >= 1, ["v"]):
            fb.assign("v", lambda v: torch.clamp(v, min=1), ["v"], name="spin")
    # ---- mode 3: recursion past max_depth ----
    fb.assign("is_bomb", lambda m: m == 3, ["mode"], name="sel_bomb")
    with fb.if_("is_bomb"):
        fb.const(BOMB_DEPTH, torch.int32, out="bomb_n")
        fb.call("rec", ["bomb_n"], out="deep")
        fb.assign("out", lambda d: d.to(torch.float32), ["deep"], name="bomb_out")
    fb.return_()
    pb.add(fb)
    return pb.build()


class ChaosModel:
    """A language model wrapper that injects per-lane serving faults, keyed
    by sentinel prompt tokens (``benchmarks/torch_serve_bench --chaos``);
    the counterpart of ``tools/chaos.py``'s ``ChaosModel``.

    * token ``vocab-1`` (the NaN sentinel): NaN is added along the lane's
      own batch slice of every floating cache leaf (integer leaves, the
      int8 ``k_q``/``v_q``, are left as they are), so the VM's opt-in
      ``detect_nonfinite`` check faults the lane (``nonfinite``) when the
      poisoned cache is written back into VM state;
    * token ``vocab-2`` (the livelock sentinel): the logits are forced to
      emit ``vocab-2`` again, so the lane never reaches EOS and burns
      decode steps until the ``lane_step_budget`` watchdog fires
      (``watchdog``);
    * any other token: the wrapped model's logits, except that EOS is
      forced once ``pos >= eos_pos``, so a healthy request finishes in
      bounded, known work (which keeps the watchdog's budget separable:
      healthy lanes run under twice a calibrated fault-free request, a
      livelocked lane needs about ``max_new / eos_pos`` times it).

    A fault touches only its own lane's batch slice, so healthy lanes'
    tokens are bit-exact with a chaos-free serve of the same requests.
    The engine calls :meth:`decode_step` batched, on ``[Z]`` tokens and
    positions.
    """

    def __init__(self, inner, *, eos_pos: int, eos_id: int = 0):
        self.inner = inner
        self.cfg = inner.cfg
        self.device = inner.device
        self.nan_token = inner.cfg.vocab_size - 1
        self.slow_token = inner.cfg.vocab_size - 2
        self.eos_pos = eos_pos
        self.eos_id = eos_id
        # Each cache leaf's batch axis, from the meta device (window-invariant).
        _, self._axes, _ = _cache_layout(inner, 8)

    def init(self, generator: torch.Generator) -> dict:
        return self.inner.init(generator)

    def init_cache(self, batch: int, window: int, device=None) -> dict:
        return self.inner.init_cache(batch, window, device=device)

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, dict]:
        logits, new_cache = self.inner.decode_step(params, cache, token, pos)
        is_slow = token == self.slow_token
        is_nan = token == self.nan_token
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        slow_logits = torch.where(vocab == self.slow_token, 0.0, -1e9).to(logits.dtype)
        eos_logits = torch.where(vocab == self.eos_id, 0.0, -1e9).to(logits.dtype)
        force_eos = torch.logical_and(torch.logical_not(is_slow), pos >= self.eos_pos)
        logits = torch.where(is_slow[:, None], slow_logits, logits)
        logits = torch.where(force_eos[:, None], eos_logits, logits)
        poison = torch.where(is_nan, float("nan"), 0.0).to(torch.float32)
        leaves, treedef = pytree.tree_flatten(new_cache)
        out = []
        for leaf, ax in zip(leaves, self._axes):
            if leaf.is_floating_point():
                shape = [1] * leaf.dim()
                shape[ax] = -1
                leaf = leaf + poison.reshape(shape).to(leaf.dtype)
            out.append(leaf)
        return logits, pytree.tree_unflatten(out, treedef)


def make_modes(batch: int, rate: float, seed: int) -> np.ndarray:
    """Per-lane fault modes: about ``rate`` of the batch, split across modes
    1-3 (at least one lane of each when any faults are asked for, at least
    one healthy lane)."""
    rng = np.random.default_rng(seed)
    modes = np.zeros((batch,), np.int32)
    n_fault = int(round(batch * rate))
    if rate > 0:
        n_fault = max(n_fault, len(FAULT_MODES))
    n_fault = min(n_fault, batch - 1)
    lanes = rng.choice(batch, size=n_fault, replace=False)
    for i, lane in enumerate(lanes):
        modes[lane] = FAULT_MODES[i % len(FAULT_MODES)]
    return modes


def chaos_fn(program=None, *, device, schedule: str = "earliest", fuse: bool = True,
             **kw) -> batching.AutobatchedFunction:
    """The harness's autobatched program: quarantine, both detectors."""
    opts = dict(max_depth=MAX_DEPTH, max_steps=200_000, on_fault="quarantine",
                detect_nonfinite=True, lane_step_budget=LANE_STEP_BUDGET)
    opts.update(kw)
    return batching.autobatch(program or build_chaos_program(), schedule=schedule,
                              fuse=fuse, device=device, **opts)


def run_cell(program, *, batch: int, modes: np.ndarray, schedule: str, fuse: bool,
             seed: int, device, mesh=None) -> dict:
    """One matrix cell: a fault-free and a chaotic run through one executor
    (lanes sharded over ``mesh``'s ranks when given)."""
    fn = chaos_fn(program, device=device, schedule=schedule, fuse=fuse, mesh=mesh)
    host = distributed.host_lanes
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 10_000, (batch,)).astype(np.int32)).to(device)
    record = {
        "schedule": schedule, "fuse": fuse, "batch": batch,
        "injected": {pc_vm.FAULT_NAMES[EXPECT_CODE[m]]: int((modes == m).sum())
                     for m in FAULT_MODES},
        "violations": [],
    }
    clean = host(fn(x, torch.zeros(batch, dtype=torch.int32, device=device))["out"]).numpy()
    clean_codes = host(fn.last_result.fault_code).numpy()
    if clean_codes.any():
        record["violations"].append(f"fault-free run reported faults: {clean_codes.tolist()}")
    try:
        chaotic = host(fn(x, torch.from_numpy(modes).to(device))["out"]).numpy()
    except Exception as e:  # criterion 1: must never abort
        record["violations"].append(f"chaotic run aborted: {type(e).__name__}: {e}")
        record["ok"] = False
        return record
    res = fn.last_result
    codes = host(res.fault_code).numpy()
    expect = np.array([EXPECT_CODE[int(m)] for m in modes], np.int32)
    if not np.array_equal(codes, expect):
        bad = np.flatnonzero(codes != expect)
        record["violations"].append(
            f"fault codes != expected at lanes {bad.tolist()}: got "
            f"{codes[bad].tolist()}, want {expect[bad].tolist()}")
    healthy = modes == 0
    if not np.array_equal(chaotic[healthy], clean[healthy]):
        bad = np.flatnonzero(healthy & (chaotic != clean))
        record["violations"].append(
            f"healthy lanes not bit-exact at {bad.tolist()}: chaotic "
            f"{chaotic[bad].tolist()} vs clean {clean[bad].tolist()}")
    record["healthy_lanes"] = int(healthy.sum())
    record["faulted_lanes"] = int((codes != 0).sum())
    record["steps"] = res.steps
    record["ok"] = not record["violations"]
    return record


def run_matrix(*, batch: int = 16, rate: float = 0.25, seed: int = 0,
               device=None) -> list[dict]:
    """The schedule x fuse containment matrix."""
    device = resolve_device(device)
    program = build_chaos_program()
    modes = make_modes(batch, rate, seed)
    return [run_cell(program, batch=batch, modes=modes, schedule=schedule, fuse=fuse,
                     seed=seed, device=device)
            for schedule in pc_vm.SCHEDULES for fuse in (True, False)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.25,
                    help="fraction of lanes injected with faults "
                         "(split across NaN / livelock / overflow)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write per-cell records (strict JSON)")
    args = ap.parse_args(argv)
    if not 0.0 < args.rate < 1.0:
        ap.error(f"--rate must be in (0, 1), got {args.rate}")
    records = run_matrix(batch=args.batch, rate=args.rate, seed=args.seed,
                         device=args.device)
    bad = [r for r in records if not r.get("ok")]
    for r in records:
        cell = f"schedule={r['schedule']:<9} fuse={int(r['fuse'])}"
        if r.get("ok"):
            print(f"[ok]   {cell}  healthy={r['healthy_lanes']} "
                  f"faulted={r['faulted_lanes']} steps={r['steps']}")
        else:
            print(f"[FAIL] {cell}")
            for v in r["violations"]:
                print(f"       - {v}")
    print(f"\nchaos matrix: {len(records) - len(bad)}/{len(records)} cells clean "
          f"(batch={args.batch}, rate={args.rate}, seed={args.seed})")
    if args.json:
        from benchmarks.common import write_json
        write_json(args.json, {
            "benchmark": "chaos_matrix_torch",
            "config": {"batch": args.batch, "rate": args.rate, "seed": args.seed,
                       "device": str(resolve_device(args.device))},
            "records": records,
        })
        print(f"[wrote {args.json}: {len(records)} records]")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
