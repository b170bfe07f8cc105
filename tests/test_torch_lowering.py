"""The PyTorch port lowers the same programs to the same structure as the
JAX package: the same CFG, built in both packages, gives identical lowered
blocks (op by op), terminators, entry, stack and temp variables, fusion
provenance, main parameters/outputs and variable specs — after lowering,
after fusion, and after the full pipeline ``autobatch`` runs (fusion + DCE).

The port's builders of the integer test programs are in
``repro_torch.testing``; the JAX ones are the repository's own
(tests/test_core.py, tests/test_fusion.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import analysis as j_analysis  # noqa: E402
from repro.core import batching as j_batching  # noqa: E402
from repro.core import fusion as j_fusion  # noqa: E402
from repro.core import ir as j_ir  # noqa: E402
from repro.core import lowering as j_lowering  # noqa: E402
from repro.core import passes as j_passes  # noqa: E402
from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch.core import analysis as t_analysis  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import frontend as t_frontend  # noqa: E402
from repro_torch.core import fusion as t_fusion  # noqa: E402
from repro_torch.core import ir as t_ir  # noqa: E402
from repro_torch.core import lowering as t_lowering  # noqa: E402
from repro_torch.core import passes as t_passes  # noqa: E402
from repro_torch.core.frontend import BOOL, I32  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from tests.test_core import build_fib as j_build_fib  # noqa: E402
from tests.test_core import build_mutual as j_build_mutual  # noqa: E402
from tests.test_core import build_pow_loop as j_build_pow_loop  # noqa: E402
from tests.test_fusion import build_deep_recursion as j_build_deep_recursion  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    build_deep_recursion,
    build_fib,
    build_mutual,
    build_pow_loop,
)

NUTS_SETTINGS = dict(max_tree_depth=5, num_steps=4, steps_per_leaf=2)


def j_build_nuts():
    return j_nuts.build_nuts_program(
        j_targets.isotropic_gaussian(3), j_nuts.NutsSettings(**NUTS_SETTINGS)
    )


def t_build_nuts():
    return t_nuts.build_nuts_program(
        t_targets.isotropic_gaussian(3, device="cpu"),
        t_nuts.NutsSettings(**NUTS_SETTINGS),
    )


PROGRAMS = {
    "fib": (j_build_fib, build_fib),
    "pow_loop": (j_build_pow_loop, build_pow_loop),
    "mutual": (j_build_mutual, build_mutual),
    "deep_recursion": (j_build_deep_recursion, build_deep_recursion),
    "nuts": (j_build_nuts, t_build_nuts),
}

# ---------------------------------------------------------------------------
# Structure, as plain tuples both packages can be reduced to
# ---------------------------------------------------------------------------

# JAX keeps PRNG keys as uint32; the port carries the same bits as int32.
_DTYPE_NAMES = {"uint32": "int32"}


def _dtype_name(dtype) -> str:
    name = str(dtype).replace("torch.", "")
    return _DTYPE_NAMES.get(name, name)


def structure(low, ir_mod) -> dict:
    def op(o):
        if isinstance(o, ir_mod.LPrim):
            return ("prim", o.outs, o.ins, o.name, o.batched, o.tag)
        if isinstance(o, ir_mod.LPush):
            return ("push", o.var, o.src)
        return ("pop", o.var)

    def term(t):
        if isinstance(t, ir_mod.LJump):
            return ("jump", t.target)
        if isinstance(t, ir_mod.LBranch):
            return ("branch", t.var, t.true, t.false)
        if isinstance(t, ir_mod.LPushJump):
            return ("pushjump", t.target, t.ret)
        return ("return",)

    return dict(
        num_blocks=len(low.blocks),
        blocks=[(b.label, [op(o) for o in b.ops], term(b.term)) for b in low.blocks],
        entry=low.entry,
        stack_vars=sorted(low.stack_vars),
        temp_vars=sorted(low.temp_vars),
        fused_from=low.fused_from,
        main_params=low.main_params,
        main_outputs=low.main_outputs,
        func_entries=low.func_entries,
        var_specs={
            v: (tuple(s.shape), _dtype_name(s.dtype))
            for v, s in sorted(low.var_specs.items())
        },
    )


def _pipelines(prog_pair):
    j_build, t_build = prog_pair
    j_low = j_lowering.lower(j_build())
    t_low = t_lowering.lower(t_build(), "cpu")
    j_post = [*j_passes.fusion_passes(), j_passes.DeadCodeElimination()]
    t_post = [*t_passes.fusion_passes(), t_passes.DeadCodeElimination()]
    return {
        "lowered": (j_low, t_low),
        "fused": (j_fusion.fuse(j_low), t_fusion.fuse(t_low)),
        "pipeline": (
            j_passes.PassPipeline(j_post).run(j_low),
            t_passes.PassPipeline(t_post).run(t_low),
        ),
    }


@pytest.fixture(scope="module", params=sorted(PROGRAMS))
def lowered_pair(request):
    return request.param, _pipelines(PROGRAMS[request.param])


@pytest.mark.parametrize("stage", ["lowered", "fused", "pipeline"])
def test_lowered_structure_matches_reference(lowered_pair, stage):
    _, stages = lowered_pair
    j_low, t_low = stages[stage]
    assert structure(t_low, t_ir) == structure(j_low, j_ir)


def test_stack_depth_bound_matches_reference(lowered_pair):
    _, stages = lowered_pair
    j_low, t_low = stages["pipeline"]

    def fields(r):
        return (r.pc_depth, r.var_depths, r.required_max_depth, r.recursive_cycle)

    assert fields(t_analysis.stack_depth_bound(t_low)) == fields(
        j_analysis.stack_depth_bound(j_low)
    )


def test_fused_nuts_block_count_matches_reference():
    """Fused NUTS has the reference's block count (21 when written), and
    ``autobatch`` in both packages runs the same pipeline."""
    j_low = j_batching.autobatch(j_build_nuts()).lowered
    t_low = t_batching.autobatch(t_build_nuts(), device="cpu").lowered
    assert len(t_low.blocks) == len(j_low.blocks)
    assert structure(t_low, t_ir) == structure(j_low, j_ir)


def test_builder_program_keeps_reference_function_order():
    """autobatch over a ProgramBuilder orders functions as the JAX
    namespace trace does, so block numbering agrees."""
    j_pb, t_pb = _mutual_builders()
    j_low = j_batching.autobatch(j_pb).lowered
    t_low = t_batching.autobatch(t_pb, device="cpu").lowered
    assert structure(t_low, t_ir) == structure(j_low, j_ir)


def _mutual_builders():
    from repro.core import frontend as j_frontend

    def make(fe, dtype_bool, bool_spec, i32_spec):
        pb = fe.ProgramBuilder(main="is_even")
        for name, other, base in (("is_even", "is_odd", True),
                                  ("is_odd", "is_even", False)):
            fb = pb.function(name, ["n"], ["out"], {"n": i32_spec},
                             {"out": bool_spec})
            c = fb.prim(lambda n: n == 0, ["n"])
            with fb.if_(c):
                fb.const(base, dtype_bool, out="out")
                fb.return_()
            t = fb.prim(lambda n: n - 1, ["n"])
            fb.call(other, [t], out="out")
            fb.return_()
            pb.add(fb)
        return pb

    return (
        make(j_frontend, jnp.bool_, j_frontend.BOOL, j_frontend.I32),
        make(t_frontend, torch.bool, BOOL, I32),
    )


def test_spec_is_compared_by_shape_and_dtype():
    assert t_frontend.spec((3,), torch.float32) == t_ir.Spec((3,), torch.float32)
    assert t_frontend.spec((3,), torch.float32) != t_ir.Spec((3,), torch.int32)
    assert t_frontend.spec([2]) == t_ir.Spec((2,), torch.float32)


def test_constants_default_to_32_bit():
    assert t_frontend.as_constant(1).dtype == torch.int32
    assert t_frontend.as_constant(1.5).dtype == torch.float32
    assert t_frontend.as_constant(True).dtype == torch.bool


@pytest.mark.parametrize("entry", ["lower", "infer_types"])
def test_lowering_defaults_to_the_card(monkeypatch, entry):
    """With no device, lowering and type inference run on the card like
    every other entry point: without one they raise what ``resolve_device``
    raises instead of running on the CPU."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError) as want:
        resolve_device()
    fn = t_lowering.lower if entry == "lower" else t_analysis.infer_types
    with pytest.raises(RuntimeError) as got:
        fn(build_fib())
    assert str(got.value) == str(want.value)
