"""The comparison that decides ``correct`` for a NUTS cell.

For each compared call and each sampled chain, the program's ``theta``,
``sum_theta / num_steps`` and ``sum_sq / num_steps`` are set against the
reference's on the same inputs.  A chain's gap is the largest
``|program - reference| / (1 + |reference|)`` over the three outputs and
every coordinate.  Rounding alone moves a gap by some ulps of float32 and
their growth along the trajectories.  A chain whose float32 run takes
another discrete step (a slice, acceptance or U-turn decision decided the
other way by rounding) ends at another draw of the posterior and reads a
gap of the posterior's own scale; a few of the compared chains may do so
in a sound run.  So the number compared is ``q75_gap``, the gap that three
quarters of the compared chains keep within: only rounding sets it while
fewer than a quarter leave the reference's path, and a lower precision,
a state left unchanged, a part of the batch left out or an altered answer
each raise it by orders of magnitude.

A non-finite output in a compared row gives an infinite gap.
"""
from __future__ import annotations

import torch

NAMES = ("q75_gap",)


def chain_gaps(prog: dict, ref: dict, num_steps: int) -> torch.Tensor:
    """``[chains]`` float64 gaps of the program's outputs against the
    reference's (both on the host or both on one device)."""
    worst = None
    for name, scale in (("theta", 1), ("sum_theta", num_steps), ("sum_sq", num_steps)):
        p = prog[name].double() / scale
        r = ref[name].double() / scale
        g = ((p - r).abs() / (1.0 + r.abs())).amax(-1)
        g = torch.where(torch.isfinite(p).all(-1), g, torch.full_like(g, float("inf")))
        worst = g if worst is None else torch.maximum(worst, g)
    return worst


def numbers(gaps: torch.Tensor) -> dict:
    g = gaps.double().cpu()
    return {"q75_gap": float(torch.quantile(g, 0.75))}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number passes at or below it); a
    number without a limit fails."""
    checks = {}
    ok = True
    for name in NAMES:
        lim = limits.get(name)
        v = values[name]
        good = lim is not None and v <= lim
        ok = ok and good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
