"""Counter, gauge and histogram registry with Prometheus exposition (a copy
of the JAX package's ``obs/metrics.py``, which is pure Python).

The serving engine fills a :class:`MetricsRegistry` as it runs
(admissions, completions by status, queue depth, segment latency, token
throughput — see ``repro_torch/serve/engine.py``) and
``benchmarks/torch_serve_bench.py --metrics-out`` writes it in the
Prometheus text exposition format (version 0.0.4).

Dependency-free and small: labels are a dict per instrument call,
histograms use fixed upper-bound buckets (cumulative, with ``+Inf``) and
keep their raw observations for exact percentiles, and everything is
process-local.
"""
from __future__ import annotations

from typing import Optional, Sequence

#: Default histogram buckets (seconds), tuned for segment/request
#: latencies on CPU test rigs through real accelerator serving.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
)

_TYPES = ("counter", "gauge", "histogram")


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    if name[0].isdigit():
        raise ValueError(f"metric name must not start with a digit: {name!r}")
    return name


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: tuple[tuple[str, str], ...]) -> str:
    if not key:
        return ""
    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Counter:
    """Monotonically increasing value, keyed by a label set."""

    type = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _validate_name(name)
        self.help = help
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[str, str, float]]:
        return [
            (self.name, _render_labels(k), v)
            for k, v in sorted(self._values.items())
        ] or [(self.name, "", 0.0)]


class Gauge:
    """Point-in-time value (queue depth, active lanes), set/inc/dec."""

    type = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _validate_name(name)
        self.help = help
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list[tuple[str, str, float]]:
        return [
            (self.name, _render_labels(k), v)
            for k, v in sorted(self._values.items())
        ] or [(self.name, "", 0.0)]


class Histogram:
    """Cumulative-bucket histogram with sum/count, keyed by label set.

    ``observe()`` also retains raw observations so tests and the serve
    engine can compute exact percentiles (``percentile``) without
    bucket-interpolation error; the exposition format stays standard
    Prometheus (``_bucket``/``_sum``/``_count`` with ``le`` labels).
    """

    type = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = _validate_name(name)
        self.help = help
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._raw: dict[tuple, list[float]] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _label_key(labels)
        counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1  # +Inf bucket
        self._sums[key] = self._sums.get(key, 0.0) + float(value)
        self._raw.setdefault(key, []).append(float(value))

    def count(self, **labels: str) -> int:
        return sum(self._counts.get(_label_key(labels), []))

    def sum(self, **labels: str) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def percentile(self, q: float, **labels: str) -> float:
        """Exact q-th percentile (0-100) of raw observations, nan if none."""
        raw = self._raw.get(_label_key(labels))
        if not raw:
            return float("nan")
        xs = sorted(raw)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    def samples(self) -> list[tuple[str, str, float]]:
        out: list[tuple[str, str, float]] = []
        for key in sorted(self._counts):
            counts = self._counts[key]
            cum = 0
            for ub, c in zip(self.buckets, counts[:-1]):
                cum += c
                out.append((
                    f"{self.name}_bucket",
                    _render_labels(key + (("le", _fmt(ub)),)),
                    float(cum),
                ))
            cum += counts[-1]
            out.append((
                f"{self.name}_bucket",
                _render_labels(key + (("le", "+Inf"),)),
                float(cum),
            ))
            out.append((f"{self.name}_sum", _render_labels(key),
                        self._sums[key]))
            out.append((f"{self.name}_count", _render_labels(key),
                        float(cum)))
        if not out:
            out = [
                (f"{self.name}_bucket", '{le="+Inf"}', 0.0),
                (f"{self.name}_sum", "", 0.0),
                (f"{self.name}_count", "", 0.0),
            ]
        return out


class MetricsRegistry:
    """A named set of instruments with Prometheus text exposition.

    ``counter``/``gauge``/``histogram`` get-or-create by name (re-asking
    for an existing name returns the same instrument; a type clash
    raises), so populating code never needs registration boilerplate.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.type}"
                )
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        kw = {} if buckets is None else {"buckets": buckets}
        return self._get(Histogram, name, help, **kw)

    def get(self, name: str):
        """The instrument registered under ``name``, or ``None``."""
        return self._metrics.get(name)

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.type}")
            for sample_name, labels, value in m.samples():
                lines.append(f"{sample_name}{labels} {_fmt(value)}")
        return "\n".join(lines) + "\n"


__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]
