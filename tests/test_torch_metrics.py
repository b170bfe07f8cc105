"""The port's metrics registry (``repro_torch.obs.metrics``) against the JAX
package's ``repro.obs.metrics``: the same calls give the same Prometheus
exposition text, values and exact percentiles, and the same errors; the
port's ``StragglerPolicy`` flags the same steps as the reference's."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.obs import metrics as j_metrics  # noqa: E402
from repro.train.fault_tolerance import StragglerPolicy as JStragglerPolicy  # noqa: E402
from repro_torch.obs import metrics as t_metrics  # noqa: E402
from repro_torch.train.fault_tolerance import StragglerPolicy  # noqa: E402


def _script(mod, seed: int):
    """A serving-like sequence of instrument calls on a fresh registry."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    adm = reg.counter("serve_admissions_total", "requests injected into a lane")
    comp = reg.counter("serve_completions_total", "terminal completions by status")
    queue = reg.gauge("serve_queue_depth", "arrived-but-not-admitted requests")
    seg = reg.histogram("serve_segment_seconds", "wall time of one VM segment")
    lat = reg.histogram("serve_request_latency_seconds", buckets=(0.1, 1.0, 10.0))
    for _ in range(int(rng.integers(5, 40))):
        adm.inc()
        status = ("ok", "faulted", "timeout", "rejected")[int(rng.integers(0, 4))]
        comp.inc(status=status)
        queue.set(int(rng.integers(0, 9)))
        queue.dec(0.5)
        seg.observe(float(rng.exponential(0.02)))
        lat.observe(float(rng.exponential(2.0)), status=status)
    reg.gauge("serve_tokens_per_second").set(float(rng.uniform(1, 1e4)))
    reg.counter("escaped_labels_total").inc(2.5, path='a"b\\c\nd')
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_exposition_text_matches(seed):
    j_reg, t_reg = _script(j_metrics, seed), _script(t_metrics, seed)
    assert t_reg.render_prometheus() == j_reg.render_prometheus()
    for q in (0, 25, 50, 90, 99, 100):
        for status in ("ok", "faulted", "nope"):
            a = t_reg.get("serve_request_latency_seconds").percentile(q, status=status)
            b = j_reg.get("serve_request_latency_seconds").percentile(q, status=status)
            assert a == b or (math.isnan(a) and math.isnan(b))
    assert t_reg.get("serve_admissions_total").value() == j_reg.get(
        "serve_admissions_total").value()


def test_empty_instruments_render_alike():
    j_reg, t_reg = j_metrics.MetricsRegistry(), t_metrics.MetricsRegistry()
    for reg in (j_reg, t_reg):
        reg.counter("c_total")
        reg.gauge("g", "a gauge")
        reg.histogram("h_seconds", buckets=(1.0,))
    assert t_reg.render_prometheus() == j_reg.render_prometheus()


@pytest.mark.parametrize("bad", [
    lambda m: m.MetricsRegistry().counter("9lives"),
    lambda m: m.MetricsRegistry().counter("bad-name"),
    lambda m: m.MetricsRegistry().counter("c").inc(-1),
    lambda m: m.MetricsRegistry().histogram("h", buckets=()),
])
def test_errors_alike(bad):
    with pytest.raises(ValueError):
        bad(j_metrics)
    with pytest.raises(ValueError):
        bad(t_metrics)


def test_type_clash_raises():
    reg = t_metrics.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("x")
    assert reg.counter("x") is reg.get("x") and reg.get("missing") is None


def test_straggler_policy_flags_the_same_steps():
    lat = np.random.default_rng(3).exponential(0.01, 200)
    lat[[20, 77, 150]] *= 40
    j_pol, t_pol = JStragglerPolicy(threshold=3.0, warmup=5), StragglerPolicy(threshold=3.0, warmup=5)
    got = [(j_pol.observe(i, float(x)), t_pol.observe(i, float(x))) for i, x in enumerate(lat)]
    assert all(a == b for a, b in got)
    assert t_pol.flagged == j_pol.flagged and len(t_pol.flagged) >= 3
