"""Observability: dispatch traces, block profiles, Perfetto timelines and
the metrics registry the serving engine fills (NumPy-only copies of the
JAX package's ``obs`` modules).

* :mod:`.trace` — :class:`~.trace.DispatchTrace`, drained from the VM's
  ring (``VMConfig.trace``);
* :mod:`.blockprof` — per-block profiles, the input of the profile-guided
  passes;
* :mod:`.timeline` — Chrome/Perfetto trace-event JSON;
* :mod:`.metrics` — counters, gauges and histograms with Prometheus
  exposition.
"""
from .blockprof import BlockProfile, block_profile, format_profile
from .timeline import to_perfetto, validate_perfetto, write_perfetto
from .trace import DEFAULT_TRACE_CAPACITY, DispatchTrace

__all__ = [
    "BlockProfile",
    "DEFAULT_TRACE_CAPACITY",
    "DispatchTrace",
    "block_profile",
    "format_profile",
    "to_perfetto",
    "validate_perfetto",
    "write_perfetto",
]
