"""Chrome/Perfetto trace-event JSON export for :class:`DispatchTrace` (a
copy of the JAX package's ``obs/timeline.py``).

The emitted object follows the Trace Event Format (the ``traceEvents``
JSON array consumed by ``chrome://tracing`` and https://ui.perfetto.dev):

* one *thread track per block* (tid = block id) carrying a complete
  ``"X"`` duration event per dispatch of that block, whose ``args`` hold
  the resident/active counts;
* ``"C"`` counter tracks for live lanes, active lanes, quarantined
  lanes, faulted lanes and per-dispatch tile occupancy;
* ``"i"`` instant events marking lane compactions and new lane faults.

Time is synthetic: one dispatch = :data:`STEP_US` microseconds on the
trace clock, anchored at the event's *global* dispatch ordinal — the
ring records no wall time (device time per block comes from the
``pcvm.block<i>`` profiler scopes), and scheduling analysis wants the
dispatch axis anyway.  Traces drained
from different segments of the same run therefore line up exactly.
"""
from __future__ import annotations

import json
from typing import Optional, Union

from .trace import SWEEP_BLOCK, DispatchTrace

#: Synthetic trace-clock width of one dispatch, microseconds.
STEP_US = 10

_PID = 1  # one process track: the VM
_COUNTER_TID = 10_000  # counter rows sort after the per-block tracks


def _block_name(trace: DispatchTrace, b: int) -> str:
    return "sweep(all blocks)" if b == SWEEP_BLOCK else f"block{b}"


def to_perfetto(trace: DispatchTrace) -> dict:
    """Render a :class:`DispatchTrace` to a Trace Event Format dict."""
    ev: list[dict] = [
        {
            "name": "process_name", "ph": "M", "pid": _PID,
            "args": {"name": f"pc VM ({trace.schedule})"},
        },
    ]
    seen_blocks = sorted({int(b) for b in trace.block})
    for b in seen_blocks:
        tid = b if b != SWEEP_BLOCK else _COUNTER_TID - 1
        ev.append({
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
            "args": {"name": _block_name(trace, b)},
        })
    occ = trace.occupancy
    new_faults = trace.fault_events
    for i in range(len(trace)):
        b = int(trace.block[i])
        ts = int(trace.steps[i]) * STEP_US
        tid = b if b != SWEEP_BLOCK else _COUNTER_TID - 1
        ev.append({
            "name": _block_name(trace, b), "ph": "X", "pid": _PID,
            "tid": tid, "ts": ts, "dur": STEP_US,
            "args": {
                "step": int(trace.steps[i]),
                "active": int(trace.active[i]),
                "live": int(trace.live[i]),
                "tile_capacity": int(trace.tile_capacity[i]),
                "occupancy": round(float(occ[i]), 4),
                "residents": {
                    f"block{j}": int(c)
                    for j, c in enumerate(trace.resident[i]) if c
                },
            },
        })
        ev.append({
            "name": "lanes", "ph": "C", "pid": _PID,
            "tid": _COUNTER_TID, "ts": ts,
            "args": {
                "live": int(trace.live[i]),
                "active": int(trace.active[i]),
                "quarantined": int(trace.quarantined[i]),
                "faulted": int(trace.faults[i]),
            },
        })
        ev.append({
            "name": "tile_occupancy", "ph": "C", "pid": _PID,
            "tid": _COUNTER_TID + 1, "ts": ts,
            "args": {"occupancy": round(float(occ[i]), 4)},
        })
        if bool(trace.compacted[i]):
            ev.append({
                "name": "compaction", "ph": "i", "pid": _PID,
                "tid": tid, "ts": ts + STEP_US, "s": "p",
            })
        if int(new_faults[i]) > 0:
            ev.append({
                "name": "lane_fault", "ph": "i", "pid": _PID,
                "tid": tid, "ts": ts, "s": "p",
                "args": {"new_faults": int(new_faults[i])},
            })
    return {
        "traceEvents": ev,
        "displayTimeUnit": "ms",
        "otherData": {
            "schedule": trace.schedule,
            "num_blocks": trace.num_blocks,
            "batch_size": trace.batch_size,
            "total_dispatches": trace.total_dispatches,
            "dropped": trace.dropped,
        },
    }


def write_perfetto(path: str, trace: DispatchTrace) -> dict:
    """Write the Perfetto JSON for ``trace`` to ``path``; returns it."""
    obj = to_perfetto(trace)
    with open(path, "w") as f:
        json.dump(obj, f, allow_nan=False)
    return obj


def validate_perfetto(obj: Union[dict, str]) -> int:
    """Schema-check a Trace Event Format object (or a path to one).

    Raises ``ValueError`` on the first violation; returns the event
    count.  This is the CI gate for emitted trace artifacts: every event
    must carry the phase-appropriate required fields, and duration /
    counter events must have integer timestamps.
    """
    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Trace Event Format object "
                         "(missing 'traceEvents')")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i}: not an object")
        for k in ("name", "ph", "pid"):
            if k not in e:
                raise ValueError(f"event {i}: missing required field {k!r}")
        ph = e["ph"]
        if ph not in ("X", "C", "i", "M", "B", "E"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if ph in ("X", "C", "i"):
            if not isinstance(e.get("ts"), int):
                raise ValueError(f"event {i}: phase {ph!r} needs int 'ts'")
        if ph == "X" and not isinstance(e.get("dur"), int):
            raise ValueError(f"event {i}: phase 'X' needs int 'dur'")
        if ph == "C" and not isinstance(e.get("args"), dict):
            raise ValueError(f"event {i}: phase 'C' needs 'args' counters")
    return len(events)


def segment_tracks(
    traces: list[DispatchTrace], path: Optional[str] = None
) -> dict:
    """Merge traces drained from successive segments into one timeline.

    Traces share the global dispatch ordinal axis, so merging is pure
    event concatenation (metadata events deduplicated by (name, tid)).
    """
    if not traces:
        raise ValueError("segment_tracks needs at least one trace")
    merged = to_perfetto(traces[0])
    seen_meta = {
        (e["name"], e.get("tid")) for e in merged["traceEvents"]
        if e["ph"] == "M"
    }
    for t in traces[1:]:
        for e in to_perfetto(t)["traceEvents"]:
            if e["ph"] == "M":
                key = (e["name"], e.get("tid"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            merged["traceEvents"].append(e)
    merged["otherData"]["total_dispatches"] = max(
        t.total_dispatches for t in traces
    )
    merged["otherData"]["segments"] = len(traces)
    if path is not None:
        with open(path, "w") as f:
            json.dump(merged, f, allow_nan=False)
    return merged


__all__ = [
    "STEP_US",
    "segment_tracks",
    "to_perfetto",
    "validate_perfetto",
    "write_perfetto",
]
