#!/usr/bin/env python3
"""Run an autobatched program of the PyTorch port with dispatch tracing and
export a Perfetto timeline plus a per-block profile.

    python tools/torch_vmtrace.py [--nuts] [SPEC ...] [--device cpu] \\
        [--out trace.json] [--blockprof profile.json]

The counterpart of ``tools/vmtrace.py`` for ``repro_torch``, on the CUDA
card unless ``--device`` names another.  Each SPEC is ``module:attr`` or
``path/to/file.py:attr``, where ``attr`` resolves to a zero-argument
callable returning ``(fn, args)`` — a ``repro_torch`` ``AutobatchedFunction``
and the positional arguments to call it with; ``--device`` moves the
function there (``fn.with_options(device=...)``).  ``--nuts`` runs the built-in NUTS kernel (isotropic Gaussian in
2-D, ``max_tree_depth=3``) at ``--batch`` chains.

For every program it

1. clones the handle with ``trace=<--capacity>`` (recording never changes
   execution: outputs, step counts and dispatch choices are bit-exact
   with tracing off),
2. runs it and drains the VM's dispatch ring,
3. writes the Chrome/Perfetto trace-event JSON (``--out``), checking
   what it wrote against the schema,
4. prints the per-block profile table and optionally saves the block
   profile JSON (``--blockprof``) that ``torch_pgo.py --profile`` and
   ``fn.optimize`` read (the JAX package reads it too).

Exit status 1 if a program fails to run, records no events, or writes an
invalid trace file.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
from pathlib import Path

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_REPO, os.path.join(_REPO, "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _load_attr(spec: str, prog: str = "torch_vmtrace"):
    if ":" not in spec:
        raise SystemExit(f"{prog}: bad spec {spec!r} (want module:attr)")
    mod_name, attr = spec.rsplit(":", 1)
    if mod_name.endswith(".py") or "/" in mod_name:
        path = Path(mod_name)
        if not path.exists():
            raise SystemExit(f"{prog}: no such file: {path}")
        loaded = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(loaded)
        loaded.loader.exec_module(mod)
    else:
        mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError:
        raise SystemExit(f"{prog}: {mod_name} has no attribute {attr!r}")


def _as_run(obj, prog: str = "torch_vmtrace", device=None):
    """A spec'd object as ``(AutobatchedFunction, args)``; with ``device``
    the function is moved there (``with_options(device=...)``)."""
    from repro_torch.core import batching

    if callable(obj) and not isinstance(obj, batching.AutobatchedFunction):
        obj = obj()
    if (isinstance(obj, tuple) and len(obj) == 2
            and isinstance(obj[0], batching.AutobatchedFunction)):
        fn, fn_args = obj
        return (fn if device is None else fn.with_options(device=device)), fn_args
    raise SystemExit(
        f"{prog}: cannot run {type(obj).__name__} (want a zero-arg callable "
        "returning (AutobatchedFunction, args))"
    )


def _nuts_run(batch: int, device):
    from repro_torch.mcmc import nuts, targets

    t = targets.isotropic_gaussian(2, device=device)
    s = nuts.NutsSettings(max_tree_depth=3, num_steps=2, steps_per_leaf=2)
    kernel = nuts.make_nuts_kernel(t, s, device=device)
    return kernel, nuts.initial_state(t, batch, eps=0.1, seed=0, device=device)


def trace_one(name: str, fn, args, *, capacity, out, blockprof) -> bool:
    """Run ``fn(*args)`` with tracing on; write and check the artifacts."""
    from repro_torch.obs import block_profile, format_profile, validate_perfetto, write_perfetto

    print(f"== {name} ==")
    if fn.backend != "pc":
        print(f"FAILED: dispatch tracing needs the pc backend (got {fn.backend!r})")
        return False
    traced = fn.with_options(trace=capacity)
    traced(*args)
    tr = traced.last_trace
    if tr is None or len(tr) == 0:
        print("FAILED: run recorded no dispatch events")
        return False
    print(f"dispatches: {tr.total_dispatches} (captured {len(tr)}, dropped {tr.dropped}) "
          f"schedule={tr.schedule} batch={tr.batch_size}")
    if out:
        write_perfetto(out, tr)
        n = validate_perfetto(out)
        print(f"wrote {out}: {n} trace events (valid)")
    prof = block_profile(tr)
    print(format_profile(prof))
    if blockprof:
        prof.save(blockprof)
        print(f"wrote {blockprof}: block profile (digest {prof.digest()})")
    print()
    return True


def main(argv=None) -> int:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="torch_vmtrace", description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="*", metavar="SPEC",
                    help="module:attr or path.py:attr resolving to a zero-arg callable "
                         "returning (fn, args)")
    ap.add_argument("--nuts", action="store_true", help="also trace the built-in NUTS kernel")
    ap.add_argument("--batch", type=int, default=32, help="--nuts chain count (default 32)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="trace ring capacity in dispatches (default: "
                         "obs.trace.DEFAULT_TRACE_CAPACITY; older events are dropped)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the Perfetto trace-event JSON here")
    ap.add_argument("--blockprof", default=None, metavar="PATH",
                    help="write the block profile JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device of every run (default: the CUDA card; 'cpu' for a "
                         "CPU run)")
    args = ap.parse_args(argv)
    if not args.specs and not args.nuts:
        ap.error("nothing to trace: pass SPECs and/or --nuts")
    capacity = True if args.capacity is None else args.capacity

    runs: list[tuple[str, object, tuple]] = []
    if args.nuts:
        fn, fn_args = _nuts_run(args.batch, resolve_device(args.device))
        runs.append((f"nuts (built-in, batch={args.batch})", fn, fn_args))
    for spec in args.specs:
        fn, fn_args = _as_run(_load_attr(spec), device=args.device)
        runs.append((spec, fn, fn_args))

    ok = True
    for name, fn, fn_args in runs:
        ok &= trace_one(name, fn, fn_args, capacity=capacity, out=args.out,
                        blockprof=args.blockprof)
    if not ok:
        print("torch_vmtrace: FAILED")
        return 1
    print(f"torch_vmtrace: {len(runs)} program(s) traced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
