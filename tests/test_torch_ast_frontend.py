"""The port's restricted-Python frontend (``repro_torch.core.ast_frontend``)
against the JAX package's.

One function object, whose body uses Python operators only, is registered
in both packages' ``Namespace``; a body that needs ``where``/``maximum`` is
written twice, with ``jnp`` and with ``torch``.  The same source gives the
same program: function names, params, outputs, blocks op for op (prim
outputs and inputs, ``Call`` callees, terminators), the inferred
``var_specs`` (shape and dtype) and the lowered program.  Run on the pc
VM, the integer programs are bit-exact with the JAX VM (outputs, ``steps``,
``block_exec``) and the float program allclose.  Constants type as int32,
float32 and bool in both, and the reference's error cases raise the same
message in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import analysis as j_analysis  # noqa: E402
from repro.core import ast_frontend as j_ast  # noqa: E402
from repro.core import batching as j_batching  # noqa: E402
from repro.core import frontend as j_frontend  # noqa: E402
from repro.core import ir as j_ir  # noqa: E402
from repro.core import lowering as j_lowering  # noqa: E402
from repro_torch.core import analysis as t_analysis  # noqa: E402
from repro_torch.core import ast_frontend as t_ast  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import frontend as t_frontend  # noqa: E402
from repro_torch.core import ir as t_ir  # noqa: E402
from repro_torch.core import lowering as t_lowering  # noqa: E402
from tests.test_torch_lowering import _dtype_name, structure  # noqa: E402

PKGS = {
    "jax": dict(ast=j_ast, frontend=j_frontend, ir=j_ir,
                specs={"i32": j_frontend.I32, "f32": j_frontend.F32, "bool": j_frontend.BOOL}),
    "port": dict(ast=t_ast, frontend=t_frontend, ir=t_ir,
                 specs={"i32": t_frontend.I32, "f32": t_frontend.F32, "bool": t_frontend.BOOL}),
}


# ---------------------------------------------------------------------------
# Restricted-Python sources (one object for both packages unless noted)
# ---------------------------------------------------------------------------


def fib(n):
    if n < 2:
        return n
    return fib(n - 1) + fib(n - 2)


def is_even(n):
    if n == 0:
        return True
    return is_odd(n - 1)  # noqa: F821 - resolved in the namespace


def is_odd(n):
    if n == 0:
        return False
    return is_even(n - 1)


def tri_loop(n):
    acc = 0
    steps = 0
    while n > 0:
        acc += n
        n -= 1
        steps += 1
    return acc, steps


def classify(x):
    if x < 0:
        r = 0 - x
    elif x < 10:
        r = x * 2
    elif x < 100:
        r = x + 7
    else:
        r = x // 3
    return r


def divmod7(n):
    return n // 7, n % 7


def use_divmod(n):
    q, r = divmod7(n)
    return q * 10 + r


def consts(n):
    x = 0
    y = 0.5
    b = True
    if n > 2:
        x = n * 3
        y = y * 4.0
        b = False
    if b:
        return 1, y, x
    return 2, y, x


def via_builder(n):
    if n < 0:
        return triple(0 - n)  # noqa: F821 - a builder function in the namespace
    return triple(n) + 1  # noqa: F821


def fact(n):
    if n <= 1:
        return n * 0 + 1
    return n * fact(n - 1)


class JaxSource:
    @staticmethod
    def relu_mix(x, y):
        """Needs ``maximum``/``where``: the JAX copy."""
        z = jnp.maximum(x, 0.0)
        while z > 1.0:
            z = z * 0.5
        return z + jnp.where(y > 0.0, y, 0.0)


class TorchSource:
    @staticmethod
    def relu_mix(x, y):
        """Needs ``maximum``/``where``: the port's copy."""
        z = torch.clamp(x, min=0.0)
        while z > 1.0:
            z = z * 0.5
        return z + torch.where(y > 0.0, y, 0.0)


def _add_triple(ns, pkg):
    fe, I32 = pkg["frontend"], pkg["specs"]["i32"]
    fb = fe.FunctionBuilder("triple", ["x"], ["out"], {"x": I32}, {"out": I32})
    fb.assign("out", lambda x: 3 * x, ["x"])
    fb.return_()
    ns.add(fb)


def _add_fact_plus(ns, pkg):
    fe, I32 = pkg["frontend"], pkg["specs"]["i32"]
    fb = fe.FunctionBuilder("fact_plus", ["n"], ["out"], {"n": I32}, {"out": I32})
    fb.call("fact", ["n"], out="t")
    fb.assign("out", lambda t: t + 1, ["t"])
    fb.return_()
    ns.add(fb)


# name -> (python functions with param/output specs, builders, main, inputs)
CASES = {
    "fib": dict(fns=[(fib, {"n": "i32"}, ["i32"])], main="fib", max_depth=16,
                inputs=lambda rng: (rng.integers(0, 12, 8).astype(np.int32),)),
    "mutual": dict(fns=[(is_even, {"n": "i32"}, ["bool"]), (is_odd, {"n": "i32"}, ["bool"])],
                   main="is_even", max_depth=24,
                   inputs=lambda rng: (rng.integers(0, 20, 8).astype(np.int32),)),
    "while_aug": dict(fns=[(tri_loop, {"n": "i32"}, ["i32", "i32"])], main="tri_loop",
                      inputs=lambda rng: (rng.integers(-2, 9, 8).astype(np.int32),)),
    "elif": dict(fns=[(classify, {"x": "i32"}, ["i32"])], main="classify",
                 inputs=lambda rng: (rng.integers(-50, 400, 8).astype(np.int32),)),
    "tuple_call": dict(fns=[(divmod7, {"n": "i32"}, ["i32", "i32"]),
                            (use_divmod, {"n": "i32"}, ["i32"])], main="use_divmod",
                       inputs=lambda rng: (rng.integers(0, 100, 8).astype(np.int32),)),
    "constants": dict(fns=[(consts, {"n": "i32"}, ["i32", "f32", "i32"])], main="consts",
                      inputs=lambda rng: (rng.integers(0, 6, 8).astype(np.int32),)),
    "ast_calls_builder": dict(fns=[(via_builder, {"n": "i32"}, ["i32"])], builders=[_add_triple],
                              main="via_builder",
                              inputs=lambda rng: (rng.integers(-9, 9, 8).astype(np.int32),)),
    "builder_calls_ast": dict(fns=[(fact, {"n": "i32"}, ["i32"])], builders=[_add_fact_plus],
                              main="fact_plus", max_depth=20,
                              inputs=lambda rng: (rng.integers(0, 8, 8).astype(np.int32),)),
    "where_maximum": dict(fns={"jax": [(JaxSource.relu_mix, {"x": "f32", "y": "f32"}, ["f32"])],
                               "port": [(TorchSource.relu_mix, {"x": "f32", "y": "f32"},
                                         ["f32"])]},
                          main="relu_mix",
                          inputs=lambda rng: (rng.normal(size=8).astype(np.float32) * 4,
                                              rng.normal(size=8).astype(np.float32))),
}


def _per_pkg(value, which):
    return value[which] if isinstance(value, dict) else value


def _trace(case: dict, which: str):
    pkg = PKGS[which]
    ns = pkg["ast"].Namespace()
    specs = pkg["specs"]
    for fn, params, outs in _per_pkg(case["fns"], which):
        ns.define({p: specs[s] for p, s in params.items()}, [specs[s] for s in outs])(fn)
    for add in case.get("builders", ()):
        add(ns, pkg)
    return ns.trace(_per_pkg(case["main"], which))


def _source_structure(prog, ir_mod) -> dict:
    def op(o):
        if isinstance(o, ir_mod.Call):
            return ("call", o.callee, o.outs, o.ins)
        return ("prim", o.outs, o.ins, o.name)

    def term(t):
        if isinstance(t, ir_mod.Jump):
            return ("jump", t.target)
        if isinstance(t, ir_mod.Branch):
            return ("branch", t.var, t.true, t.false)
        return ("return",)

    return {
        name: dict(
            params=f.params, outputs=f.outputs, num_blocks=len(f.blocks),
            blocks=[([op(o) for o in b.ops], term(b.term)) for b in f.blocks],
            var_specs={v: (tuple(s.shape), _dtype_name(s.dtype))
                       for v, s in sorted(f.var_specs.items())},
        )
        for name, f in prog.functions.items()
    }


@pytest.fixture(scope="module")
def traced():
    """Both packages' programs of every case, typed (and, for the port, on
    the CPU), with the JAX VM's run of each."""
    out = {}
    rng = np.random.default_rng(18)
    for name, case in CASES.items():
        j_prog, t_prog = _trace(case, "jax"), _trace(case, "port")
        j_analysis.infer_types(j_prog)
        t_analysis.infer_types(t_prog, "cpu")
        args = case["inputs"](rng)
        j_fn = j_batching.autobatch(j_prog, max_depth=case.get("max_depth"))
        j_out = j_fn(*args)
        out[name] = dict(j_prog=j_prog, t_prog=t_prog, args=args,
                         j_out={k: np.asarray(v) for k, v in j_out.items()},
                         j_res=j_fn.last_result)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_same_source_gives_the_same_program(traced, name):
    t = traced[name]
    assert list(t["t_prog"].functions) == list(t["j_prog"].functions)
    assert _source_structure(t["t_prog"], t_ir) == _source_structure(t["j_prog"], j_ir)


@pytest.mark.parametrize("name", list(CASES))
def test_same_source_lowers_alike(traced, name):
    t = traced[name]
    assert structure(t_lowering.lower(t["t_prog"], "cpu"), t_ir) == \
        structure(j_lowering.lower(t["j_prog"]), j_ir)


@pytest.mark.parametrize("name", list(CASES))
def test_runs_match_the_jax_vm(traced, name):
    t = traced[name]
    fn = t_batching.autobatch(t["t_prog"], max_depth=CASES[name].get("max_depth"), device="cpu")
    out = fn(*t["args"])
    res, j_res = fn.last_result, t["j_res"]
    assert set(out) == set(t["j_out"])
    for k, want in t["j_out"].items():
        got = out[k].numpy()
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got, want)
    assert res.steps == int(j_res.steps)
    np.testing.assert_array_equal(res.block_exec, np.asarray(j_res.block_exec))


def test_constants_type_32_bit_in_both(traced):
    for key, ir_mod in (("j_prog", j_ir), ("t_prog", t_ir)):
        specs = _source_structure(traced["constants"][key], ir_mod)["consts"]["var_specs"]
        assert (specs["x"], specs["y"], specs["b"]) == (((), "int32"), ((), "float32"),
                                                          ((), "bool"))
        assert specs["out0"] == ((), "int32")


# ---------------------------------------------------------------------------
# Errors: the reference's cases raise the same message in both packages
# ---------------------------------------------------------------------------


def err_while_call(n):
    while fib(n) > 3:
        n = n - 1
    return n


def err_bare_return(n):
    return


def err_chained(n):
    a = b = n
    return a + b


def err_for(n):
    for _ in range(3):
        n = n + 1
    return n


def err_params(n, m):
    return n + m


ERRORS = {
    "registered_call_in_while": (err_while_call, {"n": "i32"}, "while conditions"),
    "bare_return": (err_bare_return, {"n": "i32"}, "bare return"),
    "chained_assignment": (err_chained, {"n": "i32"}, "chained assignment"),
    "unsupported_statement": (err_for, {"n": "i32"}, "unsupported statement"),
    "param_specs_mismatch": (err_params, {"n": "i32"}, "do not match parameters"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_errors_match_the_reference(name):
    fn, params, match = ERRORS[name]
    msgs = []
    for which in ("jax", "port"):
        pkg = PKGS[which]
        ns = pkg["ast"].Namespace()
        specs = pkg["specs"]
        ns.define({"n": specs["i32"]}, [specs["i32"]])(fib)
        ns.define({p: specs[s] for p, s in params.items()}, [specs["i32"]])(fn)
        with pytest.raises(pkg["ast"].ASTFrontendError, match=match) as e:
            ns.trace(fn.__name__)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_source_not_available_names_the_function():
    """``inspect.getsource`` fails for a function made by ``exec``; the port
    raises ``ASTFrontendError`` naming it (the reference leaks ``OSError``)."""
    scope: dict = {}
    exec("def made_by_exec(n):\n    return n + 1\n", scope)
    ns = t_ast.Namespace()
    ns.define({"n": t_frontend.I32}, [t_frontend.I32])(scope["made_by_exec"])
    with pytest.raises(t_ast.ASTFrontendError, match="made_by_exec"):
        ns.trace("made_by_exec")


def test_trace_prunes_and_program_keeps_everything():
    for which in ("jax", "port"):
        pkg = PKGS[which]
        ns = pkg["ast"].Namespace()
        I32 = pkg["specs"]["i32"]
        ns.define({"n": I32}, [I32])(fib)
        ns.define({"n": I32}, [I32, I32])(divmod7)
        assert set(ns.trace("fib").functions) == {"fib"}
        assert set(ns.program("fib").functions) == {"fib", "divmod7"}
        with pytest.raises(ValueError, match="not registered"):
            ns.trace("nope")
