#!/usr/bin/env python3
"""Trace a program of the PyTorch port, build its block profile, re-lower
it through the profile-guided passes and check that this paid off.

    python tools/torch_pgo.py [--nuts] [SPEC ...] [--device cpu] \\
        [--profile profile.json] [--save-profile profile.json]

The counterpart of ``tools/pgo.py`` for ``repro_torch``, on the CUDA card
unless ``--device`` names another, with the SPEC contract of
``tools/torch_vmtrace.py`` (a zero-argument callable returning ``(fn,
args)``); ``--nuts`` runs the built-in NUTS kernel at ``--batch`` chains.

For every program it

1. runs it once with dispatch tracing on (``with_options(trace=...)``)
   and distills the trace into a :class:`repro_torch.obs.BlockProfile` —
   or loads a saved profile (``--profile``; one saved by the JAX
   package's ``tools/pgo.py`` loads alike),
2. re-lowers through ``passes.pgo_passes`` with ``fn.optimize(profile)``:
   trace-driven superblock formation, state layout packing, block
   reordering,
3. runs the optimized function on the same inputs and checks that the
   outputs are bit-exact with the first run,
4. prints blocks, dispatches and masked state updates before and after.

Exit status 1 if a program fails to run, the optimized outputs differ, or
the dispatches do not strictly drop.
"""
from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

from torch_vmtrace import _as_run, _load_attr, _nuts_run  # noqa: E402  (shared contract)


def pgo_one(name: str, fn, args, *, capacity, profile_path, save_profile) -> bool:
    """Trace, optimize and compare one program."""
    import torch

    from repro_torch.obs import block_profile, format_profile
    from repro_torch.obs.blockprof import BlockProfile

    print(f"== {name} ==")
    if fn.backend != "pc":
        print(f"FAILED: profile-guided optimization needs the pc backend (got {fn.backend!r})")
        return False
    traced = fn.with_options(trace=capacity)
    base_out = traced(*args)
    base = traced.scheduler_stats
    if base is None or base.steps is None:
        print("FAILED: the first run collected no scheduler stats")
        return False
    if profile_path:
        prof = BlockProfile.load(profile_path)
        print(f"loaded {profile_path} (digest {prof.digest()})")
    else:
        tr = traced.last_trace
        if tr is None or len(tr) == 0:
            print("FAILED: the first run recorded no dispatch events")
            return False
        prof = block_profile(tr)
    print(format_profile(prof))
    if save_profile:
        prof.save(save_profile)
        print(f"wrote {save_profile}: block profile (digest {prof.digest()})")

    opt = fn.optimize(prof)
    opt_out = opt(*args)
    sched = opt.scheduler_stats
    layout = opt.lowered.state_layout
    groups = 0 if layout is None else len(layout.groups)
    print(f"blocks:         {base.num_blocks:6d} -> {sched.num_blocks:6d}"
          f"   (layout groups: {groups})")
    print(f"dispatches:     {base.steps:6d} -> {sched.steps:6d}")
    print(f"masked updates: {base.masked_updates:6d} -> {sched.masked_updates:6d}")
    for key in base_out:
        if not torch.equal(base_out[key], opt_out[key]):
            print(f"FAILED: optimized output {key!r} differs from the first run")
            return False
    print("outputs: bit-exact with the first run")
    if sched.steps >= base.steps:
        print(f"FAILED: dispatch count did not drop ({base.steps} -> {sched.steps})")
        return False
    print()
    return True


def main(argv=None) -> int:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="torch_pgo", description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="*", metavar="SPEC",
                    help="module:attr or path.py:attr resolving to a zero-arg callable "
                         "returning (fn, args)")
    ap.add_argument("--nuts", action="store_true", help="also optimize the built-in NUTS kernel")
    ap.add_argument("--batch", type=int, default=32, help="--nuts chain count (default 32)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="trace ring capacity of the first run "
                         "(default: obs.trace.DEFAULT_TRACE_CAPACITY)")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="use a saved block profile instead of tracing a fresh one")
    ap.add_argument("--save-profile", default=None, metavar="PATH",
                    help="save the block profile JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device of --nuts (default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    if not args.specs and not args.nuts:
        ap.error("nothing to optimize: pass SPECs and/or --nuts")
    capacity = True if args.capacity is None else args.capacity

    runs: list[tuple[str, object, tuple]] = []
    if args.nuts:
        fn, fn_args = _nuts_run(args.batch, resolve_device(args.device))
        runs.append((f"nuts (built-in, batch={args.batch})", fn, fn_args))
    for spec in args.specs:
        fn, fn_args = _as_run(_load_attr(spec, "torch_pgo"), "torch_pgo")
        runs.append((spec, fn, fn_args))

    ok = True
    for name, fn, fn_args in runs:
        ok &= pgo_one(name, fn, fn_args, capacity=capacity, profile_path=args.profile,
                      save_profile=args.save_profile)
    if not ok:
        print("torch_pgo: FAILED")
        return 1
    print(f"torch_pgo: {len(runs)} program(s) optimized")
    return 0


if __name__ == "__main__":
    sys.exit(main())
