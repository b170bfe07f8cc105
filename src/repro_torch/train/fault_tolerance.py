"""Fault tolerance: the checkpoint/restart training loop, straggler
detection and moving state between devices (a port of the JAX package's
``train/fault_tolerance.py``).

:class:`ResilientLoop` restores the newest valid checkpoint on any
failure of a step and replays from there; the deterministic data stream
makes the replay exact.  :class:`StragglerPolicy` flags slow steps; the
open-loop serving loop feeds it each segment's latency too
(``GenerationEngine.serve(straggler=)``).  :func:`reshard` moves a tree
onto a mesh's shardings or onto one device (an elastic restart).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..core.tree import tree_map
from .checkpoint import Checkpointer

PyTree = Any


@dataclass
class StragglerPolicy:
    """EMA-based per-step latency monitor.

    ``observe`` returns True when the step latency exceeds ``threshold`` x
    the EMA of the earlier steps (the first ``warmup`` steps only seed the
    EMA); a flagged step is recorded in ``flagged`` and left out of the
    EMA.
    """

    threshold: float = 3.0
    decay: float = 0.9
    warmup: int = 5
    _ema: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    flagged: list = field(default_factory=list, init=False)

    def observe(self, step: int, latency_s: float) -> bool:
        self._n += 1
        if self._n <= self.warmup:
            self._ema = (
                latency_s if self._n == 1
                else self.decay * self._ema + (1 - self.decay) * latency_s
            )
            return False
        is_straggler = latency_s > self.threshold * self._ema
        if is_straggler:
            self.flagged.append((step, latency_s, self._ema))
        else:
            self._ema = self.decay * self._ema + (1 - self.decay) * latency_s
        return is_straggler


# ---------------------------------------------------------------------------
# Moving state between devices
# ---------------------------------------------------------------------------


def reshard(tree: PyTree, shardings) -> PyTree:
    """``tree`` moved onto new shardings (a mesh change on restart; values
    unchanged): ``shardings`` is a tree of ``launch.sharding.NamedSharding``
    like ``tree``'s, each leaf placed (or redistributed) as a DTensor by
    its own, or one device, where every leaf goes whole (a DTensor is
    gathered: every rank of its mesh calls this)."""
    from torch.distributed.tensor import DTensor

    from ..launch.sharding import distribute

    if isinstance(shardings, (str, torch.device)):
        def whole(x):
            if isinstance(x, DTensor):
                x = x.full_tensor()
            return x.to(shardings) if isinstance(x, torch.Tensor) else x

        return tree_map(whole, tree)
    return distribute(tree, shardings)


# ---------------------------------------------------------------------------
# The restartable loop
# ---------------------------------------------------------------------------


@dataclass
class RunReport:
    final_step: int
    restarts: int
    losses: list
    straggler_events: int


class ResilientLoop:
    """Checkpoint/restart training loop.

    ``step_fn(state, step) -> (state, metrics)`` is the pure update;
    ``state`` is any tree (params and optimizer state).  A failure raised by
    ``step_fn`` (or injected through ``failure_hook``) restores the newest
    valid checkpoint, or the initial state when there is none, and replays
    from its step, up to ``max_restarts`` times.  A checkpoint is saved
    every ``save_every`` steps and at the end; a run over a directory that
    holds one starts from it.
    """

    def __init__(self, step_fn: Callable[[PyTree, int], tuple[PyTree, dict]],
                 checkpointer: Checkpointer, save_every: int = 50, max_restarts: int = 10,
                 straggler: Optional[StragglerPolicy] = None):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerPolicy()

    def run(self, state: PyTree, num_steps: int,
            failure_hook: Optional[Callable[[int], None]] = None,
            log_every: int = 0) -> tuple[PyTree, RunReport]:
        restarts = 0
        losses: list = []
        init_state = state
        start = 0
        # Resume if a valid checkpoint exists (crash recovery).
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, like=state)
            start = latest

        step = start
        while step < num_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)  # may raise (a simulated node loss)
                t0 = time.monotonic()
                state, metrics = self.step_fn(state, step)
                if "loss" in metrics:
                    losses.append(float(metrics["loss"]))
                self.straggler.observe(step, time.monotonic() - t0)
                step += 1
                if step % self.save_every == 0 or step == num_steps:
                    self.ckpt.save(step, state)
                if log_every and step % log_every == 0:
                    loss = metrics.get("loss", float("nan"))
                    print(f"  step {step:6d}  loss {float(loss):.4f}")
            except KeyboardInterrupt:
                raise
            except Exception:  # any failure of a step: restore and replay
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    state, step = init_state, 0
                else:
                    state = self.ckpt.restore(latest, like=state)
                    step = latest
        self.ckpt.wait()
        return state, RunReport(final_step=step, restarts=restarts, losses=losses,
                                straggler_events=len(self.straggler.flagged))
