"""Dispatch tracing in the port against the JAX package's.

A traced run is bit-exact with an untraced one (outputs, ``steps``,
``block_exec``, ``block_active``, ``lane_steps``) over schedule x
``compact_every`` in (None, 1) x fuse.  The drained
:class:`repro_torch.obs.trace.DispatchTrace` equals the JAX drain field for
field on the same program and inputs — under every schedule, with
compaction, under quarantine with faults, and when the ring wraps (the
dropped count included).  The Perfetto JSON of both packages is the same
object and passes both validators; the block profile's JSON and digest are
the reference's, and a profile saved by either package loads in the
other.  The Stepper's trace spans its segments, the engine's trace is
write-only, and every dispatch runs inside a ``pcvm.block<i>`` profiler
scope.

The JAX side compiles one VM per configuration; each is built once and
shared by the cases that need it.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batching as j_batching  # noqa: E402
from repro.obs import blockprof as j_blockprof  # noqa: E402
from repro.obs import timeline as j_timeline  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from repro_torch.obs import blockprof as t_blockprof  # noqa: E402
from repro_torch.obs import timeline as t_timeline  # noqa: E402
from repro_torch.obs import trace as t_trace  # noqa: E402
from repro_torch.testing import build_fib, build_parity, parity_inputs  # noqa: E402
from tests.test_core import build_fib as j_build_fib  # noqa: E402
from tests.test_pgo import build_parity as j_build_parity  # noqa: E402
from tools import chaos as j_chaos  # noqa: E402
from tools import torch_chaos as t_chaos  # noqa: E402

FIELDS = ("steps", "block", "resident", "active", "live", "quarantined",
          "tile_capacity", "compacted", "faults")
SCHEDULES = ("earliest", "popular", "lookahead", "sweep")
FIB_N = np.array([3, 9, 0, 12, 5, 1, 7, 10], np.int32)

PROGRAMS = {
    # name -> (JAX builder, port builder, inputs, limits)
    "fib": (j_build_fib, build_fib, (FIB_N,), dict(max_depth=16)),
    "parity": (j_build_parity, build_parity, parity_inputs(),
               dict(max_depth=8, max_steps=100_000)),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _port(name, **knobs):
    _, t_build, args, limits = PROGRAMS[name]
    fn = t_batching.autobatch(t_build(), device="cpu", **limits, **knobs)
    return fn, fn(*[_t(a) for a in args])


_JAX = {}


def _jax(name, **knobs):
    """(outputs, VMResult) of the JAX VM on ``name``, once per configuration."""
    key = (name, tuple(sorted(knobs.items())))
    if key not in _JAX:
        j_build, _, args, limits = PROGRAMS[name]
        fn = j_batching.autobatch(j_build(), backend="pc", **limits, **knobs)
        out = fn(*args)
        _JAX[key] = ({k: np.asarray(v) for k, v in out.items()}, fn.last_result)
    return _JAX[key]


def assert_traces_equal(t_tr, j_tr):
    for f in ("schedule", "num_blocks", "batch_size", "capacity", "total_dispatches",
              "dropped"):
        assert getattr(t_tr, f) == getattr(j_tr, f), f
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t_tr, f), getattr(j_tr, f), err_msg=f)


@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "nofuse"])
@pytest.mark.parametrize("compact_every", [None, 1], ids=["ce_none", "ce1"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_traced_run_is_bit_exact_with_untraced(name, schedule, compact_every, fuse):
    knobs = dict(schedule=schedule, compact_every=compact_every, fuse=fuse)
    plain, out = _port(name, **knobs)
    traced, t_out = _port(name, trace=True, **knobs)
    for k in out:
        assert torch.equal(t_out[k], out[k])
    a, b = plain.last_result, traced.last_result
    assert a.steps == b.steps
    np.testing.assert_array_equal(a.block_exec, b.block_exec)
    np.testing.assert_array_equal(a.block_active, b.block_active)
    assert torch.equal(a.lane_steps, b.lane_steps)
    assert a.trace is None and plain.last_trace is None
    tr = traced.last_trace
    assert len(tr) == b.steps and tr.dropped == 0
    if schedule == "sweep":
        assert (tr.block == t_trace.SWEEP_BLOCK).all()
    else:
        np.testing.assert_array_equal(np.bincount(tr.block, minlength=len(b.block_exec)),
                                      b.block_exec)


@pytest.mark.parametrize("compact_every", [None, 1], ids=["ce_none", "ce1"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_drain_equals_jax_on_fib(schedule, compact_every):
    knobs = dict(schedule=schedule, compact_every=compact_every, trace=True)
    j_out, j_res = _jax("fib", **knobs)
    fn, out = _port("fib", **knobs)
    np.testing.assert_array_equal(out["out"].numpy(), j_out["out"])
    assert_traces_equal(fn.last_trace, j_res.trace)


@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "nofuse"])
def test_drain_equals_jax_on_parity(fuse):
    j_out, j_res = _jax("parity", trace=True, fuse=fuse)
    fn, out = _port("parity", trace=True, fuse=fuse)
    np.testing.assert_array_equal(out["out"].numpy(), j_out["out"])
    assert_traces_equal(fn.last_trace, j_res.trace)


def test_ring_wrap_drops_the_oldest_events_as_jax_does():
    j_out, j_res = _jax("fib", trace=16)
    fn, _ = _port("fib", trace=16)
    tr = fn.last_trace
    assert tr.capacity == 16 and len(tr) == 16 and tr.dropped == fn.last_result.steps - 16 > 0
    np.testing.assert_array_equal(tr.steps, np.arange(tr.dropped, tr.total_dispatches))
    assert_traces_equal(tr, j_res.trace)


@pytest.mark.parametrize("schedule", ["earliest", "sweep"])
def test_quarantine_trace_equals_jax(schedule):
    """The chaos program under quarantine: faults and quarantined lanes in
    the trace, field for field."""
    modes = t_chaos.make_modes(16, 0.25, seed=0)
    x = np.random.default_rng(0).integers(0, 10_000, (16,)).astype(np.int32)
    knobs = dict(max_depth=t_chaos.MAX_DEPTH, max_steps=200_000, schedule=schedule,
                 on_fault="quarantine", detect_nonfinite=True,
                 lane_step_budget=t_chaos.LANE_STEP_BUDGET, trace=True)
    j_fn = j_batching.autobatch(j_chaos.build_chaos_program(), backend="pc", **knobs)
    j_fn(jnp.asarray(x), jnp.asarray(modes))
    t_fn = t_batching.autobatch(t_chaos.build_chaos_program(), device="cpu", **knobs)
    t_fn(_t(x), _t(modes))
    tr = t_fn.last_trace
    assert tr.faults[-1] == int((modes != 0).sum()) and tr.quarantined.max() > 0
    assert tr.fault_events.sum() == tr.faults[-1]
    assert_traces_equal(tr, j_fn.last_result.trace)


def test_perfetto_json_is_the_reference_and_passes_both_validators(tmp_path):
    _, j_res = _jax("fib", trace=True, compact_every=1)
    fn, _ = _port("fib", trace=True, compact_every=1)
    obj = t_timeline.to_perfetto(fn.last_trace)
    assert obj == j_timeline.to_perfetto(j_res.trace)
    path = tmp_path / "trace.json"
    t_timeline.write_perfetto(str(path), fn.last_trace)
    n = t_timeline.validate_perfetto(str(path))
    assert n == j_timeline.validate_perfetto(str(path)) == len(obj["traceEvents"])
    assert any(e["name"] == "compaction" for e in obj["traceEvents"])
    with pytest.raises(ValueError, match="missing 'traceEvents'"):
        t_timeline.validate_perfetto({"events": []})


def test_segment_tracks_merge_stepper_segments():
    fn, out = _port("parity", trace=True)
    st = fn.stepper(*[_t(a) for a in parity_inputs()])
    state, parts = st.init(), []
    while not st.done(state):
        state = st.step(state, 7)
        parts.append(st.trace(state))
    assert torch.equal(st.result(state)["out"], out["out"])
    assert_traces_equal(parts[-1], fn.last_trace)
    merged = t_timeline.segment_tracks(parts)
    assert merged["otherData"]["segments"] == len(parts) > 1
    assert merged["otherData"]["total_dispatches"] == fn.last_result.steps
    t_timeline.validate_perfetto(merged)


def test_block_profile_json_and_digest_are_the_reference(tmp_path):
    _, j_res = _jax("parity", trace=True, fuse=True)
    fn, _ = _port("parity", trace=True, fuse=True)
    t_prof = t_blockprof.block_profile(fn.last_trace)
    j_prof = j_blockprof.block_profile(j_res.trace)
    assert t_prof.to_json() == j_prof.to_json()
    assert t_prof.digest() == j_prof.digest()
    assert t_blockprof.format_profile(t_prof) == j_blockprof.format_profile(j_prof)
    # Saved by one package, loaded by the other.
    t_path, j_path = tmp_path / "t.json", tmp_path / "j.json"
    t_prof.save(str(t_path))
    j_prof.save(str(j_path))
    assert t_path.read_text() == j_path.read_text()
    assert j_blockprof.BlockProfile.load(str(t_path)).digest() == t_prof.digest()
    assert t_blockprof.BlockProfile.load(str(j_path)).digest() == j_prof.digest()
    # Version 1 (no exact total_active) loads; a newer version is refused.
    v1 = json.loads(t_path.read_text())
    v1["version"] = 1
    for row in v1["blocks"]:
        del row["total_active"]
    assert (t_blockprof.BlockProfile.from_json(v1).dispatches
            == j_blockprof.BlockProfile.from_json(v1).dispatches).all()
    with pytest.raises(ValueError, match="unsupported block profile version"):
        t_blockprof.BlockProfile.from_json({**v1, "version": 99})


def test_trace_knob_validation():
    assert t_trace.resolve_capacity(None) is None
    assert t_trace.resolve_capacity(False) is None
    assert t_trace.resolve_capacity(True) == t_trace.DEFAULT_TRACE_CAPACITY
    assert t_trace.resolve_capacity(64) == 64
    with pytest.raises(ValueError, match="capacity >= 1"):
        t_pc_vm.VMConfig(batch_size=2, trace=0)
    fn, _ = _port("fib")
    assert fn._last_executor.vm.trace_capacity is None
    st = fn.stepper(_t(FIB_N))
    state = st.init()
    assert "trace" not in state and st.trace(state) is None


def test_dispatches_run_inside_named_profiler_scopes():
    from torch.profiler import ProfilerActivity, profile

    fn, _ = _port("parity")
    args = [_t(a) for a in parity_inputs()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    counts = {}
    for e in prof.events():
        if e.name.startswith("pcvm.block"):
            counts[int(e.name[len("pcvm.block"):])] = counts.get(
                int(e.name[len("pcvm.block"):]), 0) + 1
    be = fn.last_result.block_exec
    assert counts == {b: int(n) for b, n in enumerate(be) if n}


def test_engine_trace_is_write_only():
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine
    from repro_torch.testing import engine_inputs

    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ecfg = EngineConfig(lanes=3, max_context=16, max_prompt_len=4, max_new_tokens=4,
                        requests_per_lane=2)
    prompts, plens = engine_inputs(ecfg, cfg.vocab_size, seed=3)
    plain = GenerationEngine(model, params, ecfg).generate(prompts, plens)
    eng = GenerationEngine(model, params, EngineConfig(**{**ecfg.__dict__, "trace": True}))
    got = eng.generate(prompts, plens)
    np.testing.assert_array_equal(got["tokens"], plain["tokens"])
    np.testing.assert_array_equal(got["lengths"], plain["lengths"])
    res = eng.batched.last_result
    assert len(eng.batched.last_trace) == res.steps
    np.testing.assert_array_equal(
        np.bincount(res.trace.block, minlength=len(res.block_exec)), res.block_exec)
