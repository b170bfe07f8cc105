"""The port's pytree public API (``repro_torch.core.batching.autobatch``)
against the JAX package's.

Each case of tests/test_batching.py runs here through both packages on the
same inputs: integer results bit-exact, float results allclose
(``rtol=1e-6, atol=1e-7``), result pytrees of the same structure
(``PyTreeDef`` reprs equal).  JAX's ``lower()`` becomes the check that the
port's raises ``NotImplementedError``.  Beyond those: dict arguments built
in non-sorted key order, ``None`` and namedtuple subtrees bind the same IR
parameters as in JAX; ``cache_info()`` equals the reference's over one call
sequence; a ``Stepper`` over pytree arguments matches the one-shot call;
NUTS with a fixed ``batch_size`` refuses another chain count with the
reference's ``TypeError``.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ast_frontend as j_ast  # noqa: E402
from repro.core import batching as j_batching  # noqa: E402
from repro.core import frontend as j_frontend  # noqa: E402
from repro.core import ir as j_ir  # noqa: E402
from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch.core import ast_frontend as t_ast  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import frontend as t_frontend  # noqa: E402
from repro_torch.core import ir as t_ir  # noqa: E402
from repro_torch.core import tree as t_tree  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402

BACKENDS = ("pc", "local", "local_eager", "reference")
FIB = np.array([0, 1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144], np.int64)


class Pkg:
    def __init__(self, name, batching, frontend, ast, ir):
        self.name, self.batching, self.frontend, self.ast, self.ir = (
            name, batching, frontend, ast, ir)
        self.I32, self.F32 = frontend.I32, frontend.F32
        self.Batched, self.Shared = batching.Batched, batching.Shared

    def autobatch(self, target=None, **kw):
        if self.name == "port":
            kw.setdefault("device", "cpu")
        if target is None:
            return self.batching.autobatch(**kw)
        return self.batching.autobatch(target, **kw)

    def vec(self, n):
        return self.frontend.spec((n,), jnp.float32 if self.name == "jax" else torch.float32)


J = Pkg("jax", j_batching, j_frontend, j_ast, j_ir)
T = Pkg("port", t_batching, t_frontend, t_ast, t_ir)
BOTH = (J, T)


def _leaves(out, pkg):
    if pkg is J:
        leaves, treedef = jax.tree_util.tree_flatten(out)
    else:
        leaves, treedef = t_tree.tree_flatten(out)
    return [np.asarray(x) for x in leaves], repr(treedef)


def assert_same(j_out, t_out):
    """Same pytree structure; integer leaves equal, float leaves allclose."""
    (jl, jd), (tl, td) = _leaves(j_out, J), _leaves(t_out, T)
    assert td == jd
    for a, b in zip(jl, tl):
        if a.dtype.kind == "f":
            assert b.dtype == a.dtype
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(b, a)


def both(make, *args):
    """``make(pkg)`` -> a function; call each on ``args``; return the two
    results after checking they agree."""
    outs = [make(p)(*args) for p in BOTH]
    assert_same(*outs)
    return outs


def build_axpy_builder(p):
    """r = a*x + y, s = r^2 — a straight-line program with two outputs."""
    pb = p.frontend.ProgramBuilder()
    fb = pb.function("axpy", ["a", "x", "y"], ["r", "s"],
                     {"a": p.F32, "x": p.F32, "y": p.F32}, {"r": p.F32, "s": p.F32})
    fb.assign("r", lambda a, x, y: a * x + y, ["a", "x", "y"])
    fb.assign("s", lambda r: r * r, ["r"])
    fb.return_()
    pb.add(fb)
    return pb


def fib(n):
    if n < 2:
        return n
    return fib(n - 1) + fib(n - 2)


def divmod7(n):
    return n // 7, n % 7


def addk(n, k):
    return n + k


# ---------------------------------------------------------------------------
# TestDecoratorPath
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_recursive_fib(backend):
    n = np.array([0, 1, 5, 9, 12, 3], np.int32)
    j_out, _ = both(lambda p: p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32,
                                          backend=backend, max_depth=24,
                                          registry=p.ast.Namespace())(fib), n)
    np.testing.assert_array_equal(np.asarray(j_out), FIB[n])


def test_requires_specs():
    for p in BOTH:
        with pytest.raises(TypeError, match="requires in_specs"):
            p.autobatch(registry=p.ast.Namespace())(fib)


def test_multi_output_tuple():
    j_out, _ = both(lambda p: p.autobatch(in_specs=(p.Batched(p.I32),),
                                          out_spec=(p.I32, p.I32),
                                          registry=p.ast.Namespace())(divmod7),
                    np.array([0, 7, 30], np.int32))
    np.testing.assert_array_equal(np.asarray(j_out[1]), [0, 0, 2])


def test_shared_scalar_argument():
    both(lambda p: p.autobatch(in_specs=(p.Batched(p.I32), p.Shared(p.I32)), out_spec=p.I32,
                               registry=p.ast.Namespace())(addk),
         np.array([1, 2, 3], np.int32), np.int32(10))


# ---------------------------------------------------------------------------
# TestPytreeRoundTrip
# ---------------------------------------------------------------------------


def _norm2(p, backend, registry=None):
    pb = p.frontend.ProgramBuilder()
    fb = pb.function("norm2", ["gain", "u", "v", "w"], ["total", "scaled"],
                     {"gain": p.F32, "u": p.F32, "v": p.F32, "w": p.F32},
                     {"total": p.F32, "scaled": p.F32})
    fb.assign("total", lambda u, v, w: u + v + w, ["u", "v", "w"])
    fb.assign("scaled", lambda g, t: g * t, ["gain", "total"])
    fb.return_()
    pb.add(fb)
    return p.autobatch(
        pb,
        in_specs=(p.Shared(p.F32), p.Batched({"pair": (p.F32, p.F32), "w": p.F32})),
        out_spec={"sum": "total", "out": {"scaled": "scaled"}},
        backend=backend, registry=registry,
    )


@pytest.mark.parametrize("backend", BACKENDS)
def test_nested_dict_tuple_io(backend):
    state = {"pair": (np.array([1., 2.], np.float32), np.array([3., 4.], np.float32)),
             "w": np.array([5., 6.], np.float32)}
    j_res, t_res = both(lambda p: _norm2(p, backend), np.float32(2.0), state)
    assert list(t_res) == list(j_res) == ["out", "sum"]
    np.testing.assert_allclose(t_res["out"]["scaled"].numpy(), [18., 24.])


def test_structure_mismatch_raises():
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), in_specs=(p.Shared(p.F32),
                                                          p.Batched((p.F32, p.F32))))
        with pytest.raises(TypeError, match="pytree structure"):
            bf(np.float32(1.0), {"x": np.zeros(2, np.float32), "y": np.zeros(2, np.float32)})


def test_missing_batch_axis_raises():
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), in_specs=(p.Shared(p.F32),
                                                          p.Batched((p.F32, p.F32))))
        with pytest.raises(TypeError, match="leading batch axis"):
            bf(np.float32(1.0), (np.float32(1.0), np.float32(2.0)))


def test_dict_of_specs_out_spec_rejected():
    for p in BOTH:
        with pytest.raises(TypeError, match="ambiguous"):
            p.autobatch(build_axpy_builder(p), out_spec={"sum": p.F32, "prod": p.F32})


def test_dict_of_specs_out_spec_rejected_decorator_path():
    def f(n):
        return n * 2, n * 0 + 42

    for p in BOTH:
        with pytest.raises(TypeError, match="ambiguous"):
            p.autobatch(in_specs=(p.Batched(p.I32),), out_spec={"double": p.I32, "answer": p.I32},
                        registry=p.ast.Namespace())(f)


def test_interface_recorded_on_ir():
    x = np.ones(3, np.float32)
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), in_specs=(p.Shared(p.F32),
                                                          p.Batched((p.F32, p.F32))))
        bf(np.float32(1.0), (x, x))
        iface = bf.program.functions["axpy"].iface
        assert isinstance(iface, p.ir.Interface)
        assert iface.args[0].shared and not iface.args[1].shared
        assert iface.args[1].params == ("x", "y")
        assert repr(iface.args[1].treedef) == "PyTreeDef((*, *))"
        assert iface.out_leaves == ("r", "s")


# ---------------------------------------------------------------------------
# TestSharedVmapParity
# ---------------------------------------------------------------------------


def _affine(p, backend):
    vec = p.vec(3)
    pb = p.frontend.ProgramBuilder()
    fb = pb.function("affine", ["w", "x", "b"], ["out"], {"w": vec, "x": vec, "b": p.F32},
                     {"out": p.F32})
    dot = jnp.dot if p is J else torch.dot
    fb.assign("out", lambda w, x, b: dot(w, x) + b, ["w", "x", "b"])
    fb.return_()
    pb.add(fb)
    return p.autobatch(pb, in_specs=(p.Shared(vec), p.Batched(vec), p.Shared(p.F32)),
                       backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_broadcast_matches_vmap_in_axes_none(backend):
    rng = np.random.default_rng(0)
    w = rng.normal(size=3).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    b = np.float32(0.5)
    _, t_out = both(lambda p: _affine(p, backend), w, x, b)
    want = torch.func.vmap(lambda w, x, b: torch.dot(w, x) + b, in_dims=(None, 0, None))(
        torch.from_numpy(w), torch.from_numpy(x), torch.tensor(b))
    np.testing.assert_allclose(t_out["out"].numpy(), want.numpy(), rtol=1e-6)


def test_batched_vs_shared_same_values_agree():
    x = np.array([1., 2., 3.], np.float32)
    y = np.array([4., 5., 6.], np.float32)
    a = np.float32(2.0)
    outs = []
    for p in BOTH:
        pb = build_axpy_builder(p)
        shared = p.autobatch(pb, in_specs=(p.Shared(p.F32), p.Batched((p.F32, p.F32))))
        tiled = p.autobatch(pb)
        out_s, out_t = shared(a, (x, y)), tiled(np.full(3, a, np.float32), x, y)
        for k in ("r", "s"):
            np.testing.assert_array_equal(np.asarray(out_s[k]), np.asarray(out_t[k]))
        outs.append(out_s)
    assert_same(*outs)


# ---------------------------------------------------------------------------
# TestFrontendUnification
# ---------------------------------------------------------------------------


def via_triple(n):
    if n < 0:
        return triple(0 - n)  # noqa: F821 - resolved in-registry
    return triple(n) + 1  # noqa: F821


def fact(n):
    if n <= 1:
        return n * 0 + 1
    return n * fact(n - 1)


def test_ast_calls_builder_function():
    def make(p):
        reg = p.ast.Namespace()
        pb = p.frontend.ProgramBuilder()
        fb = pb.function("triple", ["x"], ["out"], {"x": p.I32}, {"out": p.I32})
        fb.assign("out", lambda x: 3 * x, ["x"])
        fb.return_()
        pb.add(fb)
        reg.add(fb)
        return p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32, registry=reg)(via_triple)

    j_out, _ = both(make, np.array([-2, 0, 4], np.int32))
    np.testing.assert_array_equal(np.asarray(j_out), [6, 1, 13])


def test_builder_calls_ast_function():
    def make(p):
        reg = p.ast.Namespace()
        p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32, max_depth=20,
                    registry=reg)(fact)
        fb = p.frontend.FunctionBuilder("fact_plus", ["n"], ["out"], {"n": p.I32},
                                        {"out": p.I32})
        fb.call("fact", ["n"], out="t")
        fb.assign("out", lambda t: t + 1, ["t"])
        fb.return_()
        return p.autobatch(fb, backend="pc", max_depth=20, registry=reg)

    j_out, _ = both(make, np.array([1, 3, 5], np.int32))
    np.testing.assert_array_equal(np.asarray(j_out["out"]), [2, 7, 121])


def test_same_name_redefinition_does_not_leak():
    """Each wrapper traces the body it decorated, even if a later
    registration shadowed its name in the shared namespace."""
    n = np.array([2, 5], np.int32)
    for p in BOTH:
        deco = p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32,
                           registry=p.ast.Namespace())

        @deco
        def mangle(n):
            return n + n

        first = mangle

        @deco
        def mangle(n):  # noqa: F811 - deliberate shadowing
            return n * 3

        second = mangle
        np.testing.assert_array_equal(np.asarray(first(n)), [4, 10])
        np.testing.assert_array_equal(np.asarray(second(n)), [6, 15])
        np.testing.assert_array_equal(np.asarray(first(n)), [4, 10])


def test_builder_redefinition_does_not_leak():
    n = np.array([1, 2], np.int32)
    for p in BOTH:
        reg = p.ast.Namespace()

        def build_scale(k):
            pb = p.frontend.ProgramBuilder()
            fb = pb.function("scale", ["x"], ["out"], {"x": p.I32}, {"out": p.I32})
            fb.assign("out", lambda x: k * x, ["x"], name=f"mul{k}")
            fb.return_()
            pb.add(fb)
            return pb

        f2 = p.autobatch(build_scale(2), registry=reg)
        f3 = p.autobatch(build_scale(3), registry=reg)
        np.testing.assert_array_equal(np.asarray(f2(n)["out"]), [2, 4])
        np.testing.assert_array_equal(np.asarray(f3(n)["out"]), [3, 6])


def test_iface_not_shared_across_wrappers():
    x = np.ones(2, np.float32)
    for p in BOTH:
        pb = build_axpy_builder(p)
        shared = p.autobatch(pb, in_specs=(p.Shared(p.F32), p.Batched((p.F32, p.F32))))
        tiled = p.autobatch(pb)
        shared(np.float32(1.0), (x, x))
        tiled(x, x, x)
        assert shared.program.functions["axpy"].iface.args[0].shared
        assert not tiled.program.functions["axpy"].iface.args[0].shared


def test_builder_default_namespace_is_private():
    for p in BOTH:
        pb = p.frontend.ProgramBuilder()
        fb = pb.function("__private_probe", ["x"], ["out"], {"x": p.I32}, {"out": p.I32})
        fb.assign("out", lambda x: x, ["x"])
        fb.return_()
        pb.add(fb)
        p.autobatch(pb)(np.array([1], np.int32))
        assert "__private_probe" not in p.batching.DEFAULT_NAMESPACE


def lonely(n):
    return n + 1


def other(n):
    return n - 1


def test_trace_prunes_unreachable():
    for p in BOTH:
        reg = p.ast.Namespace()
        deco = p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32, registry=reg)
        lone = deco(lonely)
        deco(other)
        assert set(lone.program.functions) == {"lonely"}


def test_decorated_function_keeps_its_name_and_doc():
    def documented(n):
        """Adds one."""
        return n + 1

    for p in BOTH:
        fn = p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32,
                         registry=p.ast.Namespace())(documented)
        assert (fn.__name__, fn.__doc__, fn.__wrapped__) == ("documented", "Adds one.",
                                                             documented)


# ---------------------------------------------------------------------------
# TestExecutionCache
# ---------------------------------------------------------------------------


def _fib20(p):
    return p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32, max_depth=20,
                       registry=p.ast.Namespace())(fib)


def test_same_avals_hit_no_relowering():
    n = np.array([3, 8, 5, 1], np.int32)
    infos = []
    for p in BOTH:
        fn = _fib20(p)
        fn(n)
        info1 = fn.cache_info()
        fn(n)
        infos.append((info1, fn.cache_info()))
    (j1, j2), (t1, t2) = infos
    assert (t1.misses, t1.hits, t1.lowerings, t1.traces) == (1, 0, 1, 1)
    assert (t2.misses, t2.hits, t2.lowerings, t2.traces) == (1, 1, 1, 1)
    assert tuple(vars(t1).values()) == tuple(vars(j1).values())
    assert tuple(vars(t2).values()) == tuple(vars(j2).values())


def test_new_batch_size_shares_lowering():
    for p in BOTH:
        fn = _fib20(p)
        fn(np.array([3, 8], np.int32))
        fn(np.array([3, 8, 5], np.int32))
        info = fn.cache_info()
        assert info.misses == 2 and info.entries == 2 and info.lowerings == 1


def test_cache_info_matches_the_reference_over_a_call_sequence():
    """Same avals hit; a new batch size misses with one lowering; a stepper
    and a with_options clone leave the accounting as the reference does."""
    a, b = np.array([3, 8, 5, 1], np.int32), np.array([2, 9], np.int32)
    seqs = []
    for p in BOTH:
        fn = _fib20(p)
        seq = []
        for args in (a, a, b, a, b):
            fn(args)
            seq.append(tuple(vars(fn.cache_info()).values()))
        fn.stepper(np.array([1, 2, 3], np.int32))
        seq.append(tuple(vars(fn.cache_info()).values()))
        clone = fn.with_options(collect_stats=False)
        clone(a)
        seq.append(tuple(vars(clone.cache_info()).values()))
        seqs.append(seq)
    assert seqs[1] == seqs[0]
    assert seqs[1][:5] == [(0, 1, 1, 1, 1), (1, 1, 1, 1, 1), (1, 2, 2, 1, 1),
                           (2, 2, 2, 1, 1), (3, 2, 2, 1, 1)]


def test_fixed_batch_size_validated():
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), batch_size=4)
        with pytest.raises(TypeError, match="batch axis"):
            bf(np.ones(3, np.float32), np.ones(3, np.float32), np.ones(3, np.float32))


def test_batch_size_sizes_a_call_with_no_batched_argument():
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), in_specs=(p.Shared(p.F32), p.Shared(p.F32),
                                                          p.Shared(p.F32)))
        with pytest.raises(TypeError, match="pass batch_size="):
            bf(np.float32(1.0), np.float32(2.0), np.float32(3.0))
    both(lambda p: p.autobatch(build_axpy_builder(p), batch_size=3,
                               in_specs=(p.Shared(p.F32),) * 3),
         np.float32(1.0), np.float32(2.0), np.float32(3.0))


def test_aot_lower_is_not_ported():
    bf = T.autobatch(build_axpy_builder(T))
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        bf.lower(np.ones(2, np.float32), np.ones(2, np.float32), np.ones(2, np.float32))


def test_diagnostics_match_the_reference():
    reports = []
    for p in BOTH:
        fn = _fib20(p)
        reports.append(fn.diagnostics().pretty())
        with pytest.raises(ValueError, match="'pc' backend"):
            fn.with_options(backend="local").diagnostics()
    assert reports[1] == reports[0]


# ---------------------------------------------------------------------------
# TestUnifiedIntrospection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_utilization_empty_before_run(backend):
    for p in BOTH:
        bf = p.autobatch(build_axpy_builder(p), backend=backend)
        assert bf.utilization == {} and bf.tag_stats == {}


@pytest.mark.parametrize("backend", ["pc", "local"])
def test_tag_stats_unified(backend):
    stats = []
    for p in BOTH:
        pb = p.frontend.ProgramBuilder()
        fb = pb.function("tagged", ["x"], ["out"], {"x": p.F32}, {"out": p.F32})
        fb.prim(lambda x: x * 2.0, ["x"], out="out", name="dbl", tag="dbl")
        fb.return_()
        pb.add(fb)
        bf = p.autobatch(pb, backend=backend)
        bf(np.ones(4, np.float32))
        first = (bf.tag_stats["dbl"], bf.utilization["dbl"])
        bf(np.ones(4, np.float32))
        stats.append((first, bf.tag_stats["dbl"]))
    assert stats[1] == stats[0] == (((1, 4), 1.0), (1, 4))


# ---------------------------------------------------------------------------
# TestDeprecatedShim (the api module; tests/test_torch_api.py has the rest)
# ---------------------------------------------------------------------------


def test_api_autobatch_warns_and_works():
    from repro.core import api as j_api
    from repro_torch.core import api as t_api

    outs = []
    for p, api, kw in ((J, j_api, {}), (T, t_api, {"device": "cpu"})):
        with pytest.warns(DeprecationWarning, match="batching.autobatch"):
            bp = api.autobatch(build_axpy_builder(p).build(), 2, backend="pc", **kw)
        assert bp.utilization == {}
        outs.append(bp({"a": np.ones(2, np.float32), "x": np.ones(2, np.float32),
                        "y": np.ones(2, np.float32)}))
    assert_same(*outs)
    np.testing.assert_allclose(outs[1]["r"].numpy(), [2., 2.])


def test_shim_local_utilization_is_last_run_only():
    from repro.core import api as j_api
    from repro_torch.core import api as t_api

    utils = []
    for p, api, kw in ((J, j_api, {}), (T, t_api, {"device": "cpu"})):
        pb = p.frontend.ProgramBuilder()
        fb = pb.function("maybe", ["x"], ["out"], {"x": p.F32}, {"out": p.F32})
        c = fb.prim(lambda x: x > 0, ["x"])
        fb.copy("x", out="out")
        with fb.if_(c):
            fb.prim(lambda x: x * 2.0, ["x"], out="out", name="dbl", tag="dbl")
        fb.return_()
        pb.add(fb)
        bp = api.BatchedProgram(pb.build(), 4, backend="local", **kw)
        bp({"x": np.ones(4, np.float32)})
        u1 = bp.utilization["dbl"]
        bp({"x": np.array([1., 1., -1., -1.], np.float32)})
        utils.append((u1, bp.utilization["dbl"]))
    assert utils[1] == utils[0] == (1.0, 0.5)


# ---------------------------------------------------------------------------
# Pytree binding in JAX's order
# ---------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", ["lo", "hi"])


def _probe(p, in_specs, out_spec=None):
    """A 4-parameter program whose outputs name which parameter went where."""
    pb = p.frontend.ProgramBuilder()
    names = ["a", "b", "c", "d"]
    fb = pb.function("probe", names, ["out"], {k: p.I32 for k in names}, {"out": p.I32})
    fb.assign("out", lambda a, b, c, d: a * 1000 + b * 100 + c * 10 + d, names)
    fb.return_()
    pb.add(fb)
    return p.autobatch(pb, in_specs=in_specs, out_spec=out_spec)


def test_dict_argument_in_unsorted_order_binds_as_jax():
    """A dict built in non-sorted key order binds its leaves in sorted-key
    order, and equals the declared structure whatever the insertion order."""
    one, two = np.array([1, 1], np.int32), np.array([2, 2], np.int32)
    three, four = np.array([3, 3], np.int32), np.array([4, 4], np.int32)
    arg = {"zeta": one, "alpha": two, "mid": {"y": three, "x": four}}
    _, t_out = both(lambda p: _probe(p, (p.Batched({"zeta": p.I32, "mid": {"y": p.I32,
                                                                            "x": p.I32},
                                                    "alpha": p.I32}),)), arg)
    # alpha -> a, mid.x -> b, mid.y -> c, zeta -> d
    np.testing.assert_array_equal(t_out["out"].numpy(), [2431, 2431])


def test_none_and_namedtuple_subtrees_bind_as_jax():
    x = np.array([1, 2], np.int32)
    arg = (None, Pair(lo=x + 4, hi=x), [None, x * 3, {"k": x * 5}])
    _, t_out = both(lambda p: _probe(p, (p.Batched((None, Pair(p.I32, p.I32),
                                                    [None, p.I32, {"k": p.I32}])),)), arg)
    np.testing.assert_array_equal(t_out["out"].numpy(), [5135, 6270])
    for p in BOTH:  # None is no leaf: a leaf in its place is another structure
        fn = _probe(p, (p.Batched((None, Pair(p.I32, p.I32), [None, p.I32, {"k": p.I32}])),))
        with pytest.raises(TypeError, match="pytree structure"):
            fn((x, Pair(x, x), [None, x, {"k": x}]))


def test_namedtuple_out_spec_and_shared_leaves_unflatten_as_jax():
    def make(p):
        return _probe(p, (p.Shared({"b": p.I32, "a": p.I32}), p.Batched([p.I32, p.I32])),
                      out_spec=Pair(lo="out", hi="out"))

    _, t_out = both(make, {"a": np.int32(1), "b": np.int32(2)},
                    [np.array([3, 4], np.int32), np.array([5, 6], np.int32)])
    assert isinstance(t_out, Pair)
    np.testing.assert_array_equal(t_out.hi.numpy(), [1235, 1246])


def test_stepper_with_pytree_args_matches_the_call():
    rng = np.random.default_rng(3)
    n = rng.integers(0, 12, 6).astype(np.int32)
    arg = {"w": n + 1, "v": n}
    results = []
    for p in BOTH:
        pb = p.frontend.ProgramBuilder()
        fb = pb.function("fibsum", ["v", "w"], ["out", "twice"], {"v": p.I32, "w": p.I32},
                         {"out": p.I32, "twice": p.I32})
        fb.call("fib", ["v"], out="a")
        fb.call("fib", ["w"], out="b")
        fb.assign("out", lambda a, b: a + b, ["a", "b"])
        fb.assign("twice", lambda o: o * 2, ["out"])
        fb.return_()
        pb.add(fb)
        reg = p.ast.Namespace()
        p.autobatch(in_specs=(p.Batched(p.I32),), out_spec=p.I32, registry=reg)(fib)
        fn = p.autobatch(pb, in_specs=(p.Batched({"v": p.I32, "w": p.I32}),),
                         out_spec=(("out",), {"t": "twice"}), max_depth=24, registry=reg)
        one_shot = fn(arg)
        st = fn.stepper(arg)
        state = st.init()
        while not st.done(state):
            state = st.step(state, 7)
        seg = st.result(state)
        (a, ad), (b, bd) = _leaves(one_shot, p), _leaves(seg, p)
        assert ad == bd and all(np.array_equal(x, y) for x, y in zip(a, b))
        # Re-bind fresh (reordered) pytree values through init and inject.
        state = st.init({"v": n[::-1].copy(), "w": n[::-1] + 1})
        state = st.inject(state, np.array([True, False] * 3), arg)
        while not st.done(state):
            state = st.step(state, 5)
        results.append((one_shot, st.result(state)))
    assert_same(results[0][0], results[1][0])
    assert_same(results[0][1], results[1][1])


def test_nuts_fixed_batch_size_refuses_another_chain_count():
    settings = dict(max_tree_depth=3, num_steps=1, steps_per_leaf=1)
    msgs = []
    for nuts, targets, kw in ((j_nuts, j_targets, {}), (t_nuts, t_targets, {"device": "cpu"})):
        target = targets.isotropic_gaussian(2, **kw)
        kern = nuts.make_nuts_kernel(target, nuts.NutsSettings(**settings), batch_size=4, **kw)
        assert kern.batch_size == 4
        with pytest.raises(TypeError, match="batch axis 3 != 4") as e:
            kern(*nuts.initial_state(target, 3, eps=0.1, seed=0, **kw))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]
