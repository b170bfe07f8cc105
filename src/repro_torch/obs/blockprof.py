"""Per-block profiles from a :class:`DispatchTrace` (a copy of the JAX
package's ``obs/blockprof.py``; the JSON format and :meth:`BlockProfile.digest`
are the same byte for byte, so a profile saved by either package loads in
the other).

A :class:`BlockProfile` attributes the run's dispatch stream to blocks:
how often each block ran, how many lanes rode along on average, and how
much SIMD capacity was *wasted* (occupied-tile slots that carried no
active lane — the quantity compaction and better schedules reclaim).

``to_json()`` is the **block-frequency profile format** that the
trace-driven superblock formation pass (``passes.ProfileGuidedFusion``)
consumes:
per-block dispatch counts plus the observed block->block transition
counts, which together say which block chains are hot enough to fuse.
The format is versioned so saved profiles stay readable as the pass
lands.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np

from .trace import SWEEP_BLOCK, DispatchTrace

#: Version tag of the block-frequency profile JSON format.  Version 2
#: added the exact ``total_active`` integer per block (version 1 only
#: stored the rounded ``mean_residents``, so ``load()`` reconstructs the
#: totals approximately for old artifacts).
PROFILE_VERSION = 2


@dataclass(frozen=True)
class BlockProfile:
    """Dispatch-stream aggregates, one row per block (host numpy)."""

    schedule: str
    num_blocks: int
    batch_size: int
    #: Events this profile aggregates (post ring-overflow).
    events: int
    #: Oldest events lost to ring overflow before aggregation.
    dropped: int
    #: [B] dispatches of each block (sweep iterations count no block).
    dispatches: np.ndarray
    #: [B] total active lanes over those dispatches.
    total_active: np.ndarray
    #: [B] total occupied-tile capacity over those dispatches.
    total_tile_capacity: np.ndarray
    #: [B, B] observed dispatch transitions: t[i, j] = times block j was
    #: dispatched immediately after block i (sweep iterations excluded).
    transitions: np.ndarray

    @property
    def mean_residents(self) -> np.ndarray:
        """[B] mean active lanes per dispatch of each block."""
        d = self.dispatches.astype(np.float64)
        return np.divide(
            self.total_active.astype(np.float64), d,
            out=np.zeros_like(d), where=d > 0,
        )

    @property
    def wasted_slots(self) -> np.ndarray:
        """[B] occupied-tile lane slots that carried no active lane."""
        return self.total_tile_capacity - self.total_active

    @property
    def occupancy(self) -> np.ndarray:
        """[B] per-block tile occupancy (active / occupied capacity)."""
        cap = self.total_tile_capacity.astype(np.float64)
        return np.divide(
            self.total_active.astype(np.float64), cap,
            out=np.zeros_like(cap), where=cap > 0,
        )

    def to_json(self) -> dict:
        """The block-frequency profile (superblock-pass input format)."""
        mean_res = self.mean_residents
        occ = self.occupancy
        return {
            "version": PROFILE_VERSION,
            "schedule": self.schedule,
            "num_blocks": self.num_blocks,
            "batch_size": self.batch_size,
            "events": self.events,
            "dropped": self.dropped,
            "blocks": [
                {
                    "block": b,
                    "dispatches": int(self.dispatches[b]),
                    "total_active": int(self.total_active[b]),
                    "mean_residents": round(float(mean_res[b]), 6),
                    "occupancy": round(float(occ[b]), 6),
                    "wasted_slots": int(self.wasted_slots[b]),
                }
                for b in range(self.num_blocks)
            ],
            "transitions": [
                {"src": int(i), "dst": int(j),
                 "count": int(self.transitions[i, j])}
                for i, j in zip(*np.nonzero(self.transitions))
            ],
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, allow_nan=False)

    @classmethod
    def from_json(cls, data: dict) -> "BlockProfile":
        """Inverse of :meth:`to_json`, with a schema-version check.

        Accepts the current format and version 1 (which lacked the exact
        ``total_active`` integer; it is reconstructed from the rounded
        ``mean_residents``, so v1 round-trips are approximate).  Rejects
        missing or newer versions so a profile written by a later format
        never silently misguides the PGO pipeline.
        """
        version = data.get("version")
        if version is None:
            raise ValueError(
                "block profile JSON has no 'version' field "
                "(not a saved BlockProfile?)"
            )
        if not 1 <= int(version) <= PROFILE_VERSION:
            raise ValueError(
                f"unsupported block profile version {version} "
                f"(this build reads versions 1..{PROFILE_VERSION})"
            )
        nb = int(data["num_blocks"])
        dispatches = np.zeros((nb,), np.int64)
        total_active = np.zeros((nb,), np.int64)
        total_tile = np.zeros((nb,), np.int64)
        transitions = np.zeros((nb, nb), np.int64)
        for row in data["blocks"]:
            b = int(row["block"])
            dispatches[b] = int(row["dispatches"])
            if "total_active" in row:
                total_active[b] = int(row["total_active"])
            else:  # v1: reconstruct from the rounded per-dispatch mean
                total_active[b] = round(
                    float(row["mean_residents"]) * dispatches[b]
                )
            total_tile[b] = total_active[b] + int(row["wasted_slots"])
        for t in data["transitions"]:
            transitions[int(t["src"]), int(t["dst"])] = int(t["count"])
        return cls(
            schedule=str(data["schedule"]),
            num_blocks=nb,
            batch_size=int(data["batch_size"]),
            events=int(data["events"]),
            dropped=int(data["dropped"]),
            dispatches=dispatches,
            total_active=total_active,
            total_tile_capacity=total_tile,
            transitions=transitions,
        )

    @classmethod
    def load(cls, path: str) -> "BlockProfile":
        """Read a profile saved by :meth:`save` (see :meth:`from_json`)."""
        with open(path) as f:
            return cls.from_json(json.load(f))

    def digest(self) -> str:
        """Stable content hash (the executor-cache key component)."""
        payload = json.dumps(self.to_json(), sort_keys=True,
                             separators=(",", ":"), allow_nan=False)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def block_profile(trace: DispatchTrace) -> BlockProfile:
    """Aggregate a :class:`DispatchTrace` into a :class:`BlockProfile`."""
    nb = trace.num_blocks
    dispatches = np.zeros((nb,), np.int64)
    total_active = np.zeros((nb,), np.int64)
    total_tile = np.zeros((nb,), np.int64)
    transitions = np.zeros((nb, nb), np.int64)
    scheduled = trace.block != SWEEP_BLOCK
    blocks = trace.block[scheduled]
    np.add.at(dispatches, blocks, 1)
    np.add.at(total_active, blocks, trace.active[scheduled])
    np.add.at(total_tile, blocks, trace.tile_capacity[scheduled])
    if len(blocks) > 1:
        np.add.at(transitions, (blocks[:-1], blocks[1:]), 1)
    return BlockProfile(
        schedule=trace.schedule,
        num_blocks=nb,
        batch_size=trace.batch_size,
        events=len(trace),
        dropped=trace.dropped,
        dispatches=dispatches,
        total_active=total_active,
        total_tile_capacity=total_tile,
        transitions=transitions,
    )


def format_profile(prof: BlockProfile) -> str:
    """Human-readable block-profile table (the vmtrace CLI summary)."""
    lines = [
        f"block profile: schedule={prof.schedule} "
        f"batch={prof.batch_size} events={prof.events}"
        + (f" (dropped {prof.dropped} oldest)" if prof.dropped else ""),
        f"{'block':>6} {'dispatches':>10} {'mean_res':>9} "
        f"{'occupancy':>9} {'wasted':>8}",
    ]
    mean_res = prof.mean_residents
    occ = prof.occupancy
    order = np.argsort(-prof.dispatches, kind="stable")
    for b in order:
        if prof.dispatches[b] == 0:
            continue
        lines.append(
            f"{int(b):>6} {int(prof.dispatches[b]):>10} "
            f"{float(mean_res[b]):>9.2f} {float(occ[b]):>9.3f} "
            f"{int(prof.wasted_slots[b]):>8}"
        )
    hot = [
        (int(i), int(j), int(prof.transitions[i, j]))
        for i, j in zip(*np.nonzero(prof.transitions))
    ]
    hot.sort(key=lambda t: -t[2])
    if hot:
        lines.append("hot transitions:")
        for i, j, c in hot[:8]:
            lines.append(f"  block{i} -> block{j}: {c}")
    return "\n".join(lines)


__all__ = [
    "PROFILE_VERSION",
    "BlockProfile",
    "block_profile",
    "format_profile",
]
