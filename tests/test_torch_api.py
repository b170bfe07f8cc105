"""The port's deprecated dict-in/dict-out shim (``repro_torch.core.api``)
against the JAX package's ``repro.core.api``.

The ``api.autobatch`` cases of tests/test_core.py — fib, the while loop,
mutual recursion, vector state, divergence and re-convergence, the
``max_steps`` non-convergence flag, pc against local utilization and the
per-run counters — run through both shims on all four backends with the
same inputs: integer outputs bit-exact, float outputs allclose
(``rtol=1e-6, atol=1e-7``), and on the pc backend ``steps`` and
``block_exec`` equal.  The shim warns, keeps the unfused lowering, and
contains a stack overflow (flagged per member) instead of raising.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as j_api  # noqa: E402
from repro.core import frontend as j_frontend  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import frontend as t_frontend  # noqa: E402
from tests import test_core as j_core  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BACKENDS = ("pc", "local", "local_eager", "reference")


def _vector_state(fe, f32):
    pb = fe.ProgramBuilder()
    vec = fe.spec((4,), f32)
    fb = pb.function("scale", ["v", "k"], ["out"], {"v": vec, "k": fe.I32}, {"out": vec})
    fb.copy("v", out="out")
    fb.copy("k", out="i")
    with fb.while_(lambda i: i > 0, ["i"]):
        fb.assign("out", lambda o: o * 2.0, ["out"])
        fb.assign("i", lambda i: i - 1, ["i"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def _diverge(fe):
    pb = fe.ProgramBuilder()
    fb = pb.function("f", ["x"], ["out"], {"x": fe.F32}, {"out": fe.F32})
    c = fb.prim(lambda x: x > 0, ["x"])
    with fb.if_(c):
        fb.assign("y", lambda x: x * 2.0, ["x"])
    with fb.orelse():
        fb.assign("y", lambda x: -x, ["x"])
    fb.assign("out", lambda y: y + 1.0, ["y"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def _spin(fe):
    pb = fe.ProgramBuilder()
    fb = pb.function("spin", ["n"], ["out"], {"n": fe.I32}, {"out": fe.I32})
    fb.copy("n", out="out")
    with fb.while_(lambda o: o >= 0, ["out"]):  # never exits for n >= 0
        fb.assign("out", lambda o: o, ["out"])
    fb.return_()
    pb.add(fb)
    return pb.build()


rng = np.random.default_rng(11)
# name -> (JAX program, port program, inputs, shim keywords)
CASES = {
    "fib": (j_core.build_fib, testing.build_fib,
            {"n": np.array([0, 1, 5, 9, 12, 3, 7, 2], np.int32)}, dict(max_depth=20)),
    "loop": (j_core.build_pow_loop, testing.build_pow_loop,
             {"x": np.array([1.5, 2.0, 0.5, 3.0], np.float32),
              "k": np.array([3, 0, 4, 2], np.int32)}, {}),
    "mutual": (j_core.build_mutual, testing.build_mutual,
               {"n": np.array([0, 1, 2, 7, 10, 13], np.int32)}, dict(max_depth=20)),
    "vector_state": (lambda: _vector_state(j_frontend, jnp.float32),
                     lambda: _vector_state(t_frontend, torch.float32),
                     {"v": np.arange(12, dtype=np.float32).reshape(3, 4),
                      "k": np.array([1, 0, 3], np.int32)}, {}),
    "diverge": (lambda: _diverge(j_frontend), lambda: _diverge(t_frontend),
                {"x": np.array([1.0, -2.0, 3.0, -4.0], np.float32)}, {}),
    "fused_fib": (j_core.build_fib, testing.build_fib,
                  {"n": rng.integers(0, 12, 6).astype(np.int32)}, dict(max_depth=20, fuse=True)),
}


def _run(api, build, inputs, backend, **kw):
    bp = api.autobatch(build(), len(next(iter(inputs.values()))), backend=backend, **kw)
    out = bp(inputs)
    return bp, {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX shim's run of every case on every backend (one compile each)."""
    runs = {}
    for name, (j_build, _, inputs, kw) in CASES.items():
        for backend in BACKENDS:
            bp, out = _run(j_api, j_build, inputs, backend, **kw)
            res = bp.last_result
            runs[name, backend] = (out, None if res is None else
                                   (int(res.steps), np.asarray(res.block_exec)),
                                   bp.utilization)
    return runs


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", list(CASES))
def test_shim_matches_the_jax_shim(jax_runs, name, backend):
    _, t_build, inputs, kw = CASES[name]
    want, j_counts, j_util = jax_runs[name, backend]
    bp, got = _run(t_api, t_build, inputs, backend, device="cpu", **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[k], w)
    if backend == "pc":
        res = bp.last_result
        assert res.steps == j_counts[0]
        np.testing.assert_array_equal(res.block_exec, j_counts[1])
    assert bp.utilization == pytest.approx(j_util)


def test_warns_and_refuses_lower_aot():
    with pytest.warns(DeprecationWarning, match="batching.autobatch"):
        bp = t_api.autobatch(testing.build_fib(), 2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        bp.lower_aot({"n": np.array([1, 2], np.int32)})
    with pytest.raises(ValueError, match="backend must be one of"):
        t_api.BatchedProgram(testing.build_fib(), 2, backend="nope", device="cpu")


def test_non_convergence_flag_matches():
    n = {"n": np.array([1, 2], np.int32)}
    flags = []
    for api, fe, kw in ((j_api, j_frontend, {}), (t_api, t_frontend, {"device": "cpu"})):
        bp = api.autobatch(_spin(fe), 2, backend="pc", max_steps=50, **kw)
        bp(n)
        flags.append((bool(bp.last_result.converged), int(bp.last_result.steps)))
    assert flags[1] == flags[0] == (False, 50)


def test_overflow_is_contained_as_in_the_reference():
    n = {"n": np.array([3, 12, 4, 11], np.int32)}
    seen = []
    for api, build, kw in ((j_api, j_core.build_fib, {}),
                           (t_api, testing.build_fib, {"device": "cpu"})):
        # An overflowed lane never halts in either package: bound the loop.
        bp = api.autobatch(build(), 4, backend="pc", max_depth=6, max_steps=2_000, **kw)
        out = np.asarray(bp(n)["out"])
        flags = np.asarray(bp.last_result.depth_exceeded)
        seen.append((flags.tolist(), out[~flags].tolist()))
    assert seen[1] == seen[0]
    assert seen[1][0] == [False, True, False, True]


def _j_tagged_fib():
    """tests/test_core.py's fib with its leaf tagged (built there inline)."""
    I32 = j_frontend.I32
    pb = j_frontend.ProgramBuilder()
    fb = pb.function("fib", ["n"], ["out"], {"n": I32}, {"out": I32})
    c = fb.prim(lambda n: n < 2, ["n"], name="lt2")
    with fb.if_(c):
        fb.prim(lambda n: n, ["n"], out="out", name="leaf", tag="leaf")
        fb.return_()
    t1 = fb.prim(lambda n: n - 1, ["n"])
    fb.call("fib", [t1], out="a")
    t2 = fb.prim(lambda n: n - 2, ["n"])
    fb.call("fib", [t2], out="b")
    fb.assign("out", lambda a, b: a + b, ["a", "b"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def test_batching_across_depth_beats_local():
    """tests/test_core.py's headline property on the port, with the JAX
    shim's counts: the pc VM runs the leaf fewer times at higher
    utilization than local static batching."""
    n = {"n": np.random.default_rng(0).integers(8, 13, 32).astype(np.int32)}
    counts = []
    for api, build, kw in ((j_api, _j_tagged_fib, {}),
                           (t_api, testing.build_tagged_fib, {"device": "cpu"})):
        pc = api.autobatch(build(), 32, backend="pc", max_depth=24, **kw)
        pc(n)
        loc = api.autobatch(build(), 32, backend="local", **kw)
        loc(n)
        pc_execs, pc_active = pc.last_result.tag_stats["leaf"]
        st = loc.batcher.stats
        counts.append((int(pc_execs), int(pc_active), st.tag_execs["leaf"],
                       st.tag_active["leaf"]))
    assert counts[1] == counts[0]
    pc_execs, pc_active, loc_execs, loc_active = counts[1]
    assert pc_execs < loc_execs and pc_active / pc_execs > loc_active / loc_execs


def test_utilization_stats_match():
    n = {"n": np.array([8, 8, 8, 8], np.int32)}
    seen = []
    for api, build, kw in ((j_api, j_core.build_fib, {}),
                           (t_api, testing.build_fib, {"device": "cpu"})):
        bp = api.autobatch(build(), 4, backend="pc", max_depth=16, **kw)
        bp(n)
        res = bp.last_result
        be, ba = np.asarray(res.block_exec), np.asarray(res.block_active)
        assert be.sum() == int(res.steps)
        seen.append((int(res.steps), ba.sum() / (be.sum() * 4)))
    assert seen[1] == seen[0] and seen[1][1] == pytest.approx(1.0)
