"""The benchmark's general parts: the manifest (``BENCHMARK.json``), files
found by name, the reduction of a device trace, the check for JAX, and the
result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name:

* a configuration: the ``file`` its ``configs`` entry names; its ``kind``
  picks the driver ``drivers/<kind>.py``;
* a traffic mix: ``traffic/<traffic>.json``;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  a number or None (nothing to read: the metric is left out).
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: Top-level module names that no run may load (compared whole, so
#: ``repro_torch`` is not ``repro``).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "tools", "chip_smoke")


def load_module(path: Path, name: Optional[str] = None):
    """Import a file of this benchmark by its path (names may hold dots)."""
    name = name or "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list
    per_layer: list


def resolve(manifest: dict, cell: str, root: Path = ROOT) -> Cell:
    """The cell's entry and the files it names."""
    wl = {w["name"]: w for w in manifest["workloads"]}.get(cell)
    if wl is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())

    def mine(m):
        return cell in m.get("workloads", [cell])

    return Cell(cell, wl, config, traffic,
                [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py")


def counts(target: str):
    return load_module(HERE / "counts" / f"{target}.py")


def reader(metric: str):
    return load_module(HERE / "metrics" / f"{metric}.py")


def peaks(kind: str) -> Optional[dict]:
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


# ----------------------------------------------------------------------
# The device trace
# ----------------------------------------------------------------------


@dataclass
class Trace:
    """What a profiled window leaves: device operations and host scopes as
    ``(name, start_ns, end_ns)``, and the window's bounds."""

    ops: list
    scopes: list
    t0: int
    t1: int

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device operation intervals inside the window."""
        spans = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.ops
                       if e > self.t0 and s < self.t1)
        out: list[list[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, int] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window, summed by the innermost host
        scope open at each moment of it (``host`` where none is)."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.t1:
            gaps.append((t, self.t1))
        segs = _innermost(self.scopes)
        by: dict[str, int] = {}
        j = 0
        for a, b in gaps:
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            t, k = a, j
            while t < b:
                if k < len(segs) and segs[k][0] <= t:
                    end, name = min(segs[k][1], b), segs[k][2]
                    k += 1
                else:
                    end, name = min(segs[k][0], b) if k < len(segs) else b, "host"
                by[name] = by.get(name, 0) + (end - t)
                t = end
        return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _innermost(scopes: list) -> list:
    """Nested ``(name, start, end)`` scopes flattened into disjoint
    ``(start, end, name)`` pieces, each named by the innermost scope open."""
    segs: list = []
    stack: list = []
    cur = 0
    for name, s, e in sorted(scopes, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            top = stack.pop()
            if top[2] > cur:
                segs.append((cur, top[2], top[0]))
                cur = top[2]
        if stack and s > cur:
            segs.append((cur, s, stack[-1][0]))
        cur = max(cur, s)
        stack.append((name, s, e))
    while stack:
        top = stack.pop()
        if top[2] > cur:
            segs.append((cur, top[2], top[0]))
            cur = top[2]
    return segs


def reduce_profile(prof, window_scope: str) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler`` run, read straight
    from its events; the window is the host scope ``window_scope``."""
    import torch

    ops, scopes, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        user = e.is_user_annotation()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not user:
                ops.append((e.name(), e.start_ns(), e.end_ns()))
        elif user:
            if e.name() == window_scope:
                window = (e.start_ns(), e.end_ns())
            else:
                scopes.append((e.name(), e.start_ns(), e.end_ns()))
    if window is None:
        raise RuntimeError(f"the profile holds no {window_scope!r} scope")
    return Trace(ops, scopes, *window)
