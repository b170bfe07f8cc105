"""Typed dispatch traces drained from the VM's on-device ring buffer (a
copy of the JAX package's ``obs/trace.py``, which imports only NumPy).

With ``VMConfig.trace=`` set, the VM state carries a fixed-capacity ring
buffer of per-dispatch records (see ``pc_vm``): the chosen block id, the
per-block resident histogram, active/live/quarantined lane counts, the
occupied-tile capacity, and compaction/fault markers.  Recording is
strictly *write-only* with respect to the scheduler — no traced value
ever feeds back into ``pick``, a dispatch mask or a block body — so a
traced run is bit-exact with an untraced one.

This module is the host side: :func:`drain` unwraps the ring order into
a :class:`DispatchTrace` of plain ``numpy`` arrays (oldest event first),
with overflow accounted explicitly (``dropped`` oldest events when the
run outlived the capacity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

#: Ring-buffer capacity used for ``trace=True`` (events).  Each event
#: costs ``8 + num_blocks`` i32 slots on device, so the default is a few
#: hundred KB for typical programs — raise it (``trace=65536``) for long
#: runs where the tail matters.
DEFAULT_TRACE_CAPACITY = 4096

#: The ``block`` value recorded for a ``schedule="sweep"`` loop iteration
#: (a sweep runs *every* resident block once; there is no single chosen
#: block to name).
SWEEP_BLOCK = -1


def resolve_capacity(trace: Any) -> Optional[int]:
    """Normalize a ``VMConfig.trace`` value to a capacity (or ``None``).

    ``None``/``False`` disable tracing; ``True`` selects
    :data:`DEFAULT_TRACE_CAPACITY`; an int >= 1 is the capacity in
    events.  Anything else raises.
    """
    if trace is None or trace is False:
        return None
    if trace is True:
        return DEFAULT_TRACE_CAPACITY
    cap = int(trace)
    if cap < 1:
        raise ValueError(
            f"trace must be None/False, True, or a capacity >= 1; got "
            f"{trace!r}"
        )
    return cap


@dataclass(frozen=True)
class DispatchTrace:
    """One VM run's dispatch stream, oldest event first (host numpy).

    All per-event arrays share length ``len(self)``; when the run
    outlived the ring capacity only the newest ``capacity`` events
    survive and ``dropped`` counts the lost oldest ones.  ``steps`` holds
    each event's global dispatch ordinal, so traces drained mid-run (or
    across ``Stepper`` segments) line up on an absolute axis.
    """

    schedule: str
    num_blocks: int
    batch_size: int
    capacity: int
    #: Total dispatches the run recorded (>= len(self) on overflow).
    total_dispatches: int
    #: Oldest events lost to ring overflow (total_dispatches - len).
    dropped: int
    #: [N] global dispatch ordinal of each event (0-based).
    steps: np.ndarray
    #: [N] chosen block id; :data:`SWEEP_BLOCK` for "sweep" iterations.
    block: np.ndarray
    #: [N, num_blocks] live residents per block *before* the dispatch.
    resident: np.ndarray
    #: [N] lanes the dispatch actually touched (residents of `block`).
    active: np.ndarray
    #: [N] live (dispatchable) lanes before the dispatch.
    live: np.ndarray
    #: [N] quarantined lanes before the dispatch.
    quarantined: np.ndarray
    #: [N] capacity of the SIMD tiles holding >= 1 dispatched lane.
    tile_capacity: np.ndarray
    #: [N] bool: lane compaction ran at the end of this iteration.
    compacted: np.ndarray
    #: [N] total faulted lanes *after* the dispatch.
    faults: np.ndarray

    def __len__(self) -> int:
        return int(self.block.shape[0])

    @property
    def occupancy(self) -> np.ndarray:
        """[N] per-dispatch tile occupancy (active / occupied-tile cap)."""
        cap = self.tile_capacity.astype(np.float64)
        return np.divide(
            self.active.astype(np.float64), cap,
            out=np.zeros_like(cap), where=cap > 0,
        )

    @property
    def fault_events(self) -> np.ndarray:
        """[N] newly-faulted lane count at each event (diff of faults)."""
        if len(self) == 0:
            return np.zeros((0,), np.int64)
        prev = np.concatenate(([0], self.faults[:-1]))
        return np.maximum(self.faults - prev, 0)


def drain(
    buffers: dict[str, Any],
    *,
    total: int,
    schedule: str,
    num_blocks: int,
    batch_size: int,
) -> DispatchTrace:
    """Ring buffers (+ total event count) -> a :class:`DispatchTrace`.

    ``buffers`` holds the device ring arrays (any array-likes; converted
    to host numpy here); ``total`` is the VM's global step counter — one
    event was written per loop iteration, so it is also the event count.
    """
    block = np.asarray(buffers["block"])
    cap = int(block.shape[0])
    n = min(int(total), cap)
    if total > cap:
        # Oldest surviving event has ordinal total - cap; the ring index
        # of ordinal k is k % cap.
        ordinals = np.arange(total - cap, total)
        idx = ordinals % cap
    else:
        ordinals = np.arange(n)
        idx = ordinals

    def take(name: str) -> np.ndarray:
        return np.asarray(buffers[name])[idx]

    return DispatchTrace(
        schedule=schedule,
        num_blocks=num_blocks,
        batch_size=batch_size,
        capacity=cap,
        total_dispatches=int(total),
        dropped=max(int(total) - cap, 0),
        steps=ordinals.astype(np.int64),
        block=take("block").astype(np.int64),
        resident=take("resident").astype(np.int64),
        active=take("active").astype(np.int64),
        live=take("live").astype(np.int64),
        quarantined=take("quarantined").astype(np.int64),
        tile_capacity=take("tile").astype(np.int64),
        compacted=take("compacted").astype(bool),
        faults=take("faults").astype(np.int64),
    )
