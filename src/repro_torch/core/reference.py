"""Unbatched reference interpreter — the ground-truth oracle for tests.

Executes the *source* IR one batch member at a time with plain Python
recursion and plain Python control flow, on torch tensors.  The program
counter VM must agree with this interpreter member by member.
"""
from __future__ import annotations

from typing import Any

import torch

from . import ir


class RecursionLimit(RuntimeError):
    pass


def run_reference_single(
    program: ir.Program,
    inputs: dict[str, Any],
    max_depth: int = 10_000,
    max_steps: int = 1_000_000,
) -> dict[str, torch.Tensor]:
    """Run one (unbatched) member through the program, on the device of
    its inputs (constants are moved there)."""
    program.validate()
    steps = [0]
    main = program.functions[program.main]
    args = [
        torch.as_tensor(inputs[p]).to(main.param_specs[p].dtype)
        for p in main.params
    ]
    device = args[0].device if args else torch.device("cpu")

    def call(fname: str, args: list[Any], depth: int) -> list[Any]:
        if depth > max_depth:
            raise RecursionLimit(f"exceeded max_depth={max_depth}")
        func = program.functions[fname]
        env: dict[str, Any] = dict(zip(func.params, args))
        bi = 0
        while True:
            steps[0] += 1
            if steps[0] > max_steps:
                raise RecursionLimit(f"exceeded max_steps={max_steps}")
            blk = func.blocks[bi]
            for op in blk.ops:
                if isinstance(op, ir.Prim):
                    outs = op.fn(*[env[i] for i in op.ins])
                    if len(op.outs) == 1:
                        outs = (outs,)
                    for name, val in zip(op.outs, outs):
                        env[name] = torch.as_tensor(val).to(device)
                else:
                    env_outs = call(op.callee, [env[a] for a in op.ins], depth + 1)
                    for name, val in zip(op.outs, env_outs):
                        env[name] = val
            t = blk.term
            if isinstance(t, ir.Jump):
                bi = t.target
            elif isinstance(t, ir.Branch):
                bi = t.true if bool(env[t.var]) else t.false
            elif isinstance(t, ir.Return):
                return [env[o] for o in func.outputs]

    outs = call(program.main, args, 0)
    return dict(zip(main.outputs, outs))


def run_reference_batch(
    program: ir.Program, inputs: dict[str, Any], **kw
) -> dict[str, torch.Tensor]:
    """Run every member independently; stack the results (the oracle)."""
    main = program.functions[program.main]
    z = int(torch.as_tensor(inputs[main.params[0]]).shape[0]) if main.params else 1
    per_member = []
    for b in range(z):
        member_inputs = {p: torch.as_tensor(inputs[p])[b] for p in main.params}
        per_member.append(run_reference_single(program, member_inputs, **kw))
    return {
        o: torch.stack([m[o] for m in per_member], dim=0) for o in main.outputs
    }
