#!/usr/bin/env python3
"""Run the lowered-IR verifier and static analyses of the PyTorch port
over a program.

    python tools/torch_irlint.py [--nuts] [--dce] [SPEC ...] [--device cpu]

The counterpart of ``tools/irlint.py`` for ``repro_torch``; type inference
and the verifier type the primitives on fake tensors of the CUDA card
unless ``--device`` names another.  Each SPEC is ``module:attr`` or
``path/to/file.py:attr``, where ``attr`` resolves to a ``repro_torch``
``ir.Program``, ``frontend.ProgramBuilder`` or ``AutobatchedFunction``, or
a zero-argument callable returning one.  ``--nuts`` adds the built-in NUTS
program (isotropic Gaussian in 2-D, ``max_tree_depth=3``).

For every program it

1. lowers it with the verifier run between every pass,
2. runs the fusion passes (and, with ``--dce``, dead-code elimination)
   under the same verification,
3. prints the diagnostics report: blocks, ops, VM state size, dead ops
   and state, the static stack-depth bound (or the recursive cycle that
   defeats it), and fusion provenance.

Exit status 1 if a program fails verification or a pass crashes.
"""
from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tools"))

from torch_vmtrace import _load_attr  # noqa: E402  (shared contract)


def _as_program(obj):
    """A spec'd object as a ``repro_torch`` ``ir.Program``."""
    from repro_torch.core import batching, frontend, ir

    if isinstance(obj, ir.Program):
        return obj
    if isinstance(obj, frontend.ProgramBuilder):
        return obj.build()
    if isinstance(obj, batching.AutobatchedFunction):
        return obj.program
    if callable(obj):
        return _as_program(obj())
    raise SystemExit(
        f"torch_irlint: cannot lint {type(obj).__name__} (want ir.Program, "
        "ProgramBuilder, AutobatchedFunction, or a callable returning one)"
    )


def _nuts_program(device):
    from repro_torch.mcmc import nuts, targets

    t = targets.isotropic_gaussian(2, device=device)
    s = nuts.NutsSettings(max_tree_depth=3, num_steps=2, steps_per_leaf=2)
    return nuts.build_nuts_program(t, s)


def lint(name: str, program, *, dce: bool, device) -> bool:
    """Lower and fuse ``program`` under full verification; print the
    diagnostics.  False if verification rejected it or a pass crashed."""
    from repro_torch.core import lowering, passes

    print(f"== {name} ==")
    try:
        low = lowering.lower(program, device, verify=True)
        pipe = list(passes.fusion_passes())
        if dce:
            pipe.append(passes.DeadCodeElimination())
        fused = passes.PassPipeline(pipe, verify=True, debug=True).run(low)
    except (passes.PassError, ValueError, TypeError) as e:
        print(f"FAILED: {e}")
        return False
    print(passes.diagnose(fused).pretty())
    prov = fused.fused_from
    n_src = len({s for srcs in prov.values() for s in srcs})
    print(f"provenance:    {len(fused.blocks)} superblocks cover "
          f"{n_src} of {len(low.blocks)} lowered blocks")
    print()
    return True


def main(argv=None) -> int:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(prog="torch_irlint", description=__doc__.splitlines()[0])
    ap.add_argument("specs", nargs="*", metavar="SPEC", help="module:attr or path.py:attr to lint")
    ap.add_argument("--nuts", action="store_true", help="also lint the built-in NUTS program")
    ap.add_argument("--dce", action="store_true", help="include the dead-code-elimination pass")
    ap.add_argument("--device", default=None,
                    help="torch device of type inference (default: the CUDA card; 'cpu' "
                         "for a CPU run)")
    args = ap.parse_args(argv)
    if not args.specs and not args.nuts:
        ap.error("nothing to lint: pass SPECs and/or --nuts")
    device = resolve_device(args.device)

    targets_: list[tuple[str, object]] = []
    if args.nuts:
        targets_.append(("nuts (built-in)", _nuts_program(device)))
    for spec in args.specs:
        targets_.append((spec, _as_program(_load_attr(spec, "torch_irlint"))))

    ok = True
    for name, prog in targets_:
        ok &= lint(name, prog, dce=args.dce, device=device)
    if not ok:
        print("torch_irlint: FAILED")
        return 1
    print(f"torch_irlint: {len(targets_)} program(s) verified clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
