"""Straggler detection (a copy of ``StragglerPolicy`` from the JAX
package's ``train/fault_tolerance.py``).

The open-loop serving loop feeds it each segment's latency
(``GenerationEngine.serve(straggler=)``); ``ServeStats.straggler_events``
counts the segments it flags.  Checkpoint-restart and resharding come
with training and multi-device support.
"""
from __future__ import annotations

from dataclasses import dataclass, field


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
