"""Quickstart for the PyTorch port: autobatch control-intensive programs
with one decorator.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # on the CPU

The public API is `repro_torch.core.batching.autobatch` — a `vmap`-like
decorator over restricted Python (or over a builder-built program) that
returns a callable over positional pytree arguments:

* `Batched(spec)` arguments carry a leading batch axis (`in_axes=0`);
* `Shared(spec)` arguments are broadcast constants (`in_axes=None`);
* outputs come back as pytrees;
* executors are cached per `(backend, batch_size, input avals)`, and the
  pc backend's stack-explicit lowering is shared across batch sizes.

The decorated handles (`fib`, `collatz`) live at module level so tools can
import and inspect them, and importing this file needs no card (the device
is resolved at the first call):
`python tools/torch_irlint.py examples/torch_quickstart.py:fib --device cpu`
runs the lowered-IR verifier and static analyses over `fib`, and
`python tools/torch_vmtrace.py examples/torch_quickstart.py:trace_run`
traces it.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import frontend
from repro_torch.core.batching import Batched, Shared, autobatch
from repro_torch.core.frontend import I32

# ---------------------------------------------------------------------------
# 1. Decorate restricted Python — recursion and all — and call it batched.
#    fib is recursive, so the stack depth has no static bound: pass one.
# ---------------------------------------------------------------------------


@autobatch(in_specs=(Batched(I32),), out_spec=I32, backend="pc", max_depth=24)
def fib(n):
    if n < 2:
        return n
    return fib(n - 1) + fib(n - 2)


# ---------------------------------------------------------------------------
# 2. The builder frontend feeds the same API: Collatz trajectory length.
#    Shared(bound) shows a broadcast constant; the output is a pytree.
#    collatz is loop-only (non-recursive): max_depth defaults to the
#    statically inferred bound — no stack sizing to guess.
# ---------------------------------------------------------------------------
pb = frontend.ProgramBuilder()
fb = pb.function(
    "collatz", ["n", "bound"], ["steps", "peak"],
    {"n": I32, "bound": I32}, {"steps": I32, "peak": I32},
)
fb.const(0, torch.int32, out="steps")
fb.copy("n", out="peak")
with fb.while_(lambda n, s, b: torch.logical_and(n > 1, s < b),
               ["n", "steps", "bound"]):
    is_even = fb.prim(lambda n: n % 2 == 0, ["n"])
    with fb.if_(is_even):
        fb.assign("n", lambda n: n // 2, ["n"])
    with fb.orelse():
        fb.assign("n", lambda n: 3 * n + 1, ["n"])
    fb.assign("peak", lambda p, n: torch.maximum(p, n), ["peak", "n"])
    fb.assign("steps", lambda s: s + 1, ["steps"])
fb.return_()
pb.add(fb)

collatz = autobatch(
    pb,
    in_specs=(Batched(I32), Shared(I32)),   # per-member n, shared step bound
    out_spec={"steps": "steps", "peak": "peak"},
    backend="pc",
)


def trace_run():
    """vmtrace entry point: a zero-arg callable returning ``(fn, args)``.

        PYTHONPATH=src python tools/torch_vmtrace.py examples/torch_quickstart.py:trace_run

    runs ``fib`` with dispatch tracing on and prints its block profile
    (``--device cpu`` runs it on the CPU).
    """
    return fib, (np.array([0, 1, 5, 9, 12, 3, 7, 2], np.int32),)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    # The module-level handles carry no device: pick one for this run.
    fib_d = fib.with_options(device=args.device)
    collatz_d = collatz.with_options(device=args.device)

    n = np.array([0, 1, 5, 9, 12, 3, 7, 2], np.int32)
    print(f"device: {fib_d.device}")
    print("fib(n)  =", fib_d(n).cpu().numpy())
    print("VM steps:", fib_d.last_result.steps,
          "(8 divergent recursions on one program-counter VM)")

    out = collatz_d(np.array([1, 6, 7, 27, 97, 871], np.int32), np.int32(1000))
    print("collatz =", out["steps"].cpu().numpy(), "(expect 0 8 16 111 118 178)")
    print("peaks   =", out["peak"].cpu().numpy())

    # -----------------------------------------------------------------------
    # 3. One decorated function, four backends.
    # -----------------------------------------------------------------------
    for backend in ("pc", "local", "local_eager", "reference"):
        bp = autobatch(fib_d.program, backend=backend, max_depth=24, device=args.device)
        res = bp(np.array([10] * 8, np.int32))
        print(f"{backend:12s} fib(10) -> {int(res['out'][0])}")

    # Calling again at the same avals is a pure cache hit (no re-trace, no
    # re-lower, no new VM); a new batch size reuses the lowering.
    fib_d(n)
    fib_d(np.array([4, 5, 6, 7], np.int32))
    print("cache:", fib_d.cache_info())

    # What did the compiler do?  diagnostics() runs the lowered-IR verifier
    # and static analyses (tools/torch_irlint.py prints the same report).
    print(collatz_d.diagnostics().pretty())


if __name__ == "__main__":
    main()
