"""The port's lowered-IR verifier and the typing it shares with type
inference.

Typing without running: ``analysis.eval_spec`` types a primitive on fake
tensors, so a primitive that raises on zeros (integer division by a
zero-initialized state variable) types, and the program then runs on the
CPU bit-exact with the JAX VM.  Fake typing gives the same specs as the
real run on zeros it replaced, for every program the port's tests build.

The verifier: every mutation case of tests/test_verifier.py is rejected by
the port's verifier with the reference's message, the unmutated programs
pass after every pass, ``PassPipeline`` names the pass that broke a
program, and ``passes.diagnose`` reports what the reference's does.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batching as j_batching  # noqa: E402
from repro.core import frontend as j_frontend  # noqa: E402
from repro.core import ir as j_ir  # noqa: E402
from repro.core import lowering as j_lowering  # noqa: E402
from repro.core import passes as j_passes  # noqa: E402
from repro_torch import fake  # noqa: E402
from repro_torch.core import analysis, batching, frontend, fusion, ir, lowering, passes, verifier  # noqa: E402,E501
from repro_torch.core.frontend import I32  # noqa: E402
from repro_torch.testing import (  # noqa: E402
    build_deep_recursion,
    build_fib,
    build_mutual,
    build_parity,
    build_pow_loop,
    build_tagged_fib,
    random_program_inputs,
)
from tests.test_torch_lowering import structure  # noqa: E402

# ---------------------------------------------------------------------------
# Typing without running
# ---------------------------------------------------------------------------


def _digits(fe, i32, floordiv, rem):
    """``digits(n, d)``: the digit sum of ``n`` in base ``d`` (a state
    variable zero until bound, so typing on real zeros divides by zero)."""
    pb = fe.ProgramBuilder(main="digits")
    fb = pb.function("digits", ["n", "d"], ["out"], {"n": i32, "d": i32}, {"out": i32})
    fb.copy("n", out="m")
    fb.copy("d", out="base")
    fb.assign("out", lambda m: m - m, ["m"])
    with fb.while_(lambda m: m > 0, ["m"]):
        fb.assign("out", lambda o, m, b: o + rem(m, b), ["out", "m", "base"], name="digit")
        fb.assign("m", floordiv, ["m", "base"], name="floordiv")
    fb.return_()
    pb.add(fb)
    return pb.build()


def _t_digits():
    return _digits(frontend, I32, lambda m, b: m // b, lambda m, b: m % b)


def _j_digits():
    return _digits(j_frontend, j_frontend.spec((), jnp.int32), lambda m, b: m // b,
                   lambda m, b: m % b)


def test_a_prim_that_raises_on_zeros_types_and_runs_bit_exact():
    prog = _t_digits()
    floordiv = next(op for blk in prog.functions["digits"].blocks for op in blk.ops
                    if getattr(op, "name", "") == "floordiv")
    # The real run on zeros that typing used to make raises ...
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        torch.func.vmap(floordiv.fn)(torch.zeros(1, dtype=torch.int32),
                                     torch.zeros(1, dtype=torch.int32))
    # ... the fake one types it.
    spec = analysis.eval_spec(floordiv, [I32, I32], torch.device("cpu"))
    assert spec == (I32,)
    rng = np.random.default_rng(7)
    n = rng.integers(0, 100_000, 16).astype(np.int32)
    d = rng.integers(2, 11, 16).astype(np.int32)
    fn = batching.autobatch(prog, verify=True, device="cpu")
    out = fn(torch.from_numpy(n), torch.from_numpy(d))["out"].numpy()
    j_fn = j_batching.autobatch(_j_digits(), backend="pc")
    np.testing.assert_array_equal(out, np.asarray(j_fn(n, d)["out"]))
    assert fn.last_result.steps == int(j_fn.last_result.steps)
    # The verifier types it through the same helper.
    verifier.verify(fn.lowered, check_specs=True)


def _nuts(target_name):
    from repro_torch.mcmc import nuts, targets

    target = {"gauss": lambda: targets.isotropic_gaussian(3, device="cpu"),
              "logreg": lambda: targets.logistic_regression(50, 4, device="cpu")}[target_name]()
    return nuts.build_nuts_program(target, nuts.NutsSettings(max_tree_depth=3, num_steps=2))


def _engine_program():
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine

    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device="cpu")
    eng = GenerationEngine(model, model.init(torch.Generator().manual_seed(0)),
                           EngineConfig(lanes=2, max_context=16, max_prompt_len=4,
                                        max_new_tokens=4, requests_per_lane=2))
    return eng._build_program()


def _serve_program():
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve.engine import EngineConfig, GenerationEngine

    cfg = configs.get_smoke_config("smollm-135m")
    model = get_model(cfg, device="cpu")
    eng = GenerationEngine(model, model.init(torch.Generator().manual_seed(0)),
                           EngineConfig(lanes=2, max_context=16, max_prompt_len=4,
                                        max_new_tokens=4, requests_per_lane=2,
                                        temperature=0.7))
    return eng._build_serve_program()


def _chaos():
    from tools import torch_chaos

    return torch_chaos.build_chaos_program()


TYPED_PROGRAMS = {
    "fib": build_fib, "pow_loop": build_pow_loop, "mutual": build_mutual,
    "deep_recursion": build_deep_recursion, "tagged_fib": build_tagged_fib,
    "parity": build_parity, "digits": _t_digits, "chaos": _chaos,
    "random0": lambda: random_program_inputs(0)[0],
    "random3": lambda: random_program_inputs(3)[0],
    "nuts_gauss": lambda: _nuts("gauss"), "nuts_logreg": lambda: _nuts("logreg"),
    "engine": _engine_program, "serve": _serve_program,
}


@pytest.mark.parametrize("name", sorted(TYPED_PROGRAMS))
def test_fake_typing_gives_the_specs_of_a_real_run(name, monkeypatch):
    faked = TYPED_PROGRAMS[name]()
    analysis.infer_types(faked, "cpu")
    if name == "digits":
        return  # a real run on zeros cannot type it (the case above)
    real = TYPED_PROGRAMS[name]()
    monkeypatch.setattr(fake, "fake_mode", contextlib.nullcontext)
    analysis.infer_types(real, "cpu")
    for fname, func in faked.functions.items():
        assert func.var_specs == real.functions[fname].var_specs, fname


# ---------------------------------------------------------------------------
# Mutations (tests/test_verifier.py's cases on the port)
# ---------------------------------------------------------------------------


def copy_lowered(low: ir.LoweredProgram) -> ir.LoweredProgram:
    """A structurally independent copy safe to mutate in place."""
    return ir.dataclass_replace(
        low,
        blocks=[ir.LBlock(ops=list(b.ops), term=b.term, label=b.label) for b in low.blocks],
        var_specs=dict(low.var_specs),
        func_entries=dict(low.func_entries),
        fused_from=None if low.fused_from is None else dict(low.fused_from),
    )


@pytest.fixture(scope="module")
def fib_low():
    return lowering.lower(build_fib(), "cpu")


@pytest.fixture(scope="module")
def fused(fib_low):
    return fusion.fuse(fib_low)


def _reject(low, match, **kw):
    with pytest.raises(verifier.VerificationError, match=match):
        verifier.verify(low, **kw)


def _first_pushjump(low):
    return next((i, b.term) for i, b in enumerate(low.blocks)
                if isinstance(b.term, ir.LPushJump))


def _non_entry(low):
    entries = set(low.func_entries.values())
    return next(i for i in range(len(low.blocks)) if i not in entries)


def _mutate_target(low):
    bad = copy_lowered(low)
    bad.blocks[1].term = ir.LJump(999)
    return bad


def _mutate_entry(low):
    return ir.dataclass_replace(copy_lowered(low), entry=_non_entry(low))


def _mutate_pushjump(low):
    bad = copy_lowered(low)
    i, t = _first_pushjump(bad)
    bad.blocks[i].term = ir.LPushJump(target=_non_entry(bad), ret=t.ret)
    return bad


def _mutate_unreachable(low):
    bad = copy_lowered(low)
    bad.blocks[bad.entry].term = ir.LReturn()
    return bad


def _mutate_extra_push(low):
    bad = copy_lowered(low)
    v = sorted(bad.stack_vars)[0]
    i, op = next((i, op) for i, b in enumerate(bad.blocks) for op in b.ops
                 if isinstance(op, ir.LPush) and op.var == v)
    bad.blocks[i].ops.append(op)
    return bad


def _mutate_pop_floor(low):
    bad = copy_lowered(low)
    bad.blocks[bad.entry].ops.insert(0, ir.LPop(sorted(bad.stack_vars)[0]))
    return bad


def _mutate_stack_vars(low):
    return ir.dataclass_replace(copy_lowered(low), stack_vars=low.stack_vars | {"fib/bogus"})


def _mutate_temp_io(low):
    io = next(v for v in (*low.main_params, *low.main_outputs) if v not in low.stack_vars)
    return ir.dataclass_replace(copy_lowered(low), temp_vars=low.temp_vars | {io})


def _mutate_temp_read(low):
    bad = copy_lowered(low)
    t = sorted(bad.temp_vars)[0]
    i = next(i for i, b in enumerate(bad.blocks)
             if any(t in ir.prim_writes(op) for op in b.ops))
    bad.blocks[i].ops.insert(0, ir.LPrim(outs=(t,), fn=lambda x: x, ins=(t,), name="bad"))
    return bad


def _mutate_out_spec(low):
    bad = copy_lowered(low)
    bad.var_specs["fib/out"] = ir.Spec((3,), torch.float32)
    return bad


def _mutate_missing_spec(low):
    bad = copy_lowered(low)
    del bad.var_specs[sorted(bad.temp_vars)[0]]
    return bad


MUTATIONS = {
    # name -> (mutation of fib's lowering, reference message)
    "out_of_range_target": (_mutate_target, r"block 1 .*terminator target 999 is out of range"),
    "entry_must_be_function_entry": (_mutate_entry, "is not a function entry"),
    "pushjump_must_target_function_entry": (_mutate_pushjump,
                                            r"pushjump target \d+ is not a function entry"),
    "empty_program": (lambda low: ir.dataclass_replace(copy_lowered(low), blocks=[]),
                      "program has no blocks"),
    "unreachable_ret_site": (_mutate_unreachable, "unreachable from the control roots"),
    "extra_push_unbalanced": (_mutate_extra_push, "stack balance:"),
    "pop_below_frame_floor": (_mutate_pop_floor, r"stack balance: .*below the frame's stack "
                                                 r"floor"),
    "stack_vars_must_match_ops": (_mutate_stack_vars,
                                  r"stack_vars is not exactly the pushed/popped set: "
                                  r"missing \[\], extra \['fib/bogus'\]"),
    "temp_cannot_be_main_io": (_mutate_temp_io, "temp_vars include main params/outputs"),
    "temp_read_before_write": (_mutate_temp_read, r"temp var '.*' is read before any write"),
    "prim_output_spec_mismatch": (_mutate_out_spec,
                                  r"writes 'fib/out' as .* but var_specs declares"),
    "missing_var_spec": (_mutate_missing_spec, r"variable '.*' has no var_specs entry"),
    "block_order_not_a_permutation": (
        lambda low: ir.dataclass_replace(copy_lowered(low),
                                         block_order=(0,) * len(low.blocks)),
        "not a permutation"),
    "block_weights_length": (
        lambda low: ir.dataclass_replace(copy_lowered(low), block_weights=(1, 2)),
        r"block_weights has 2 entries"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_of_fib_is_rejected(fib_low, name):
    mutate, match = MUTATIONS[name]
    verifier.verify(fib_low)
    _reject(mutate(fib_low), match)


def test_check_specs_false_skips_type_checking(fib_low):
    verifier.verify(_mutate_out_spec(fib_low), check_specs=False)


def test_push_spec_mix():
    low = ir.LoweredProgram(
        blocks=[ir.LBlock(ops=[ir.LPush("main/v", "main/w"), ir.LPop("main/v")],
                          term=ir.LReturn(), label="main")],
        entry=0, main_params=("main/w",), main_outputs=("main/w",),
        var_specs={"main/v": I32, "main/w": ir.Spec((2,), torch.float32)},
        stack_vars=frozenset({"main/v"}), temp_vars=frozenset(), func_entries={"main": 0},
    )
    _reject(low, r"push main/v <- main/w mixes specs", device="cpu")


PROVENANCE = {
    "missing_key": (lambda p: p.pop(0), r"fused_from keys are not exactly 0\.\."),
    "empty_sources": (lambda p: p.__setitem__(1, ()), r"fused_from\[1\] is empty"),
    "duplicate_chain_head": (lambda p: p.__setitem__(1, p[0]),
                             "both claim original block .* as their chain head"),
    "repeated_source": (lambda p: p.__setitem__(0, p[0] + (p[0][0],)),
                        "repeats a source block"),
}


@pytest.mark.parametrize("name", sorted(PROVENANCE))
def test_provenance_mutation_is_rejected(fused, name):
    verifier.verify(fused)
    bad = copy_lowered(fused)
    mutate, match = PROVENANCE[name]
    mutate(bad.fused_from)
    _reject(bad, match)


def _packed_low() -> ir.LoweredProgram:
    """Minimal valid layout-packed program (tests/test_verifier.py's)."""
    return ir.LoweredProgram(
        blocks=[ir.LBlock(ops=[
            ir.LPrim(outs=("main/a", "main/b"), fn=lambda p: (p[0], p[1]),
                     ins=("%pgo/pack0",), name="unpack"),
            ir.LPrim(outs=("main/w",), fn=lambda a, b: a + b, ins=("main/a", "main/b"),
                     name="add"),
            ir.LPrim(outs=("%pgo/pack0",), fn=lambda a, b: torch.stack((a, b)),
                     ins=("main/a", "main/b"), name="pack"),
        ], term=ir.LReturn(), label="main")],
        entry=0, main_params=("main/w",), main_outputs=("main/w",),
        var_specs={"main/a": I32, "main/b": I32, "main/w": I32,
                   "%pgo/pack0": ir.Spec((2,), torch.int32)},
        stack_vars=frozenset(), temp_vars=frozenset({"main/a", "main/b"}),
        func_entries={"main": 0},
        state_layout=ir.StateLayout(groups={"%pgo/pack0": ("main/a", "main/b")}),
        device=torch.device("cpu"),
    )


def _two_groups(low):
    return ir.dataclass_replace(
        low, var_specs={**low.var_specs, "%pgo/pack1": low.var_specs["%pgo/pack0"]},
        state_layout=ir.StateLayout(groups={"%pgo/pack0": ("main/a", "main/b"),
                                            "%pgo/pack1": ("main/a", "main/b")}))


def _no_packed_spec(low):
    specs = dict(low.var_specs)
    del specs["%pgo/pack0"]
    return ir.dataclass_replace(low, var_specs=specs)


LAYOUT = {
    "group_of_one": (lambda low: ir.dataclass_replace(
        low, state_layout=ir.StateLayout(groups={"%pgo/pack0": ("main/a",)})),
        r"packs 1 member\(s\)"),
    "packed_var_needs_spec": (_no_packed_spec,
                              r"packed variable '%pgo/pack0' has no var_specs"),
    "member_in_two_groups": (_two_groups, r"member 'main/a' belongs to both"),
    "member_must_be_temp": (lambda low: ir.dataclass_replace(
        low, temp_vars=frozenset({"main/a"})), r"member 'main/b' must be a block-local temp"),
    "member_spec_mix": (lambda low: ir.dataclass_replace(
        low, var_specs={**low.var_specs, "main/b": ir.Spec((), torch.float32)}),
        "mixes member specs"),
    "packed_spec_shape": (lambda low: ir.dataclass_replace(
        low, var_specs={**low.var_specs, "%pgo/pack0": ir.Spec((3,), torch.int32)}),
        r"\(k,\) \+ member shape"),
}


def test_valid_packed_program_passes():
    verifier.verify(_packed_low())


@pytest.mark.parametrize("name", sorted(LAYOUT))
def test_layout_mutation_is_rejected(name):
    mutate, match = LAYOUT[name]
    _reject(mutate(_packed_low()), match, check_specs=False)


def test_valid_permutation_passes(fib_low):
    n = len(fib_low.blocks)
    verifier.verify(ir.dataclass_replace(copy_lowered(fib_low), block_order=tuple(range(n)),
                                         block_weights=(7,) * n))


def test_error_is_value_error():
    assert issubclass(verifier.VerificationError, ValueError)


# ---------------------------------------------------------------------------
# Unmutated programs, the pipeline, diagnostics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", [build_fib, build_pow_loop, build_mutual, build_parity,
                                   lambda: _nuts("gauss")],
                         ids=["fib", "pow_loop", "mutual", "parity", "nuts"])
def test_unmutated_programs_verify_after_every_pass(build):
    low = lowering.lower(build(), "cpu", verify=True)
    pipe = [*passes.fusion_passes(), passes.DeadCodeElimination()]
    verifier.verify(passes.PassPipeline(pipe, verify=True, debug=True).run(low))


def test_builder_loop_program():
    pb = frontend.ProgramBuilder()
    fb = pb.function("count", ["n"], ["out"], {"n": I32}, {"out": I32})
    fb.const(0, torch.int32, out="out")
    with fb.while_(lambda n, out: out < n, ["n", "out"]):
        fb.assign("out", lambda o: o + 1, ["out"])
    fb.return_()
    pb.add(fb)
    low = lowering.lower(pb.build(), "cpu", verify=True)
    verifier.verify(fusion.fuse(low, verify=True))


class _BreakingPass:
    """Drops the entry block's terminator target range: jumps to 999."""

    name = "breaker"

    def run(self, low):
        return _mutate_target(low)


def test_pipeline_names_the_pass_that_broke_the_program(fib_low):
    pipe = passes.PassPipeline([passes.PopPushElimination(), _BreakingPass()], verify=True,
                               debug=True)
    with pytest.raises(passes.PassError, match=r"pass 'breaker' produced an invalid program"
                                               r"(.|\n)*--- offending program ---"):
        pipe.run(fib_low)
    # Unverified, the broken program goes through.
    passes.PassPipeline([_BreakingPass()]).run(fib_low)


def test_pipeline_types_an_unchanged_prim_once(fib_low, monkeypatch):
    calls = []
    real = analysis.eval_spec
    monkeypatch.setattr(analysis, "eval_spec", lambda *a: calls.append(1) or real(*a))
    passes.PassPipeline(list(passes.fusion_passes()), verify=True).run(fib_low)
    prims = {id(op) for b in fib_low.blocks for op in b.ops if isinstance(op, ir.LPrim)}
    assert 0 < len(calls) <= len(prims) + 4  # fusion adds a few popush copies


@pytest.mark.parametrize("name", ["fib", "mutual", "deep_recursion", "nuts"])
def test_diagnose_matches_the_reference(name):
    from tests.test_torch_lowering import PROGRAMS

    j_build, t_build = PROGRAMS[name]
    j_low = j_passes.PassPipeline(list(j_passes.fusion_passes())).run(
        j_lowering.lower(j_build()))
    t_low = passes.PassPipeline(list(passes.fusion_passes())).run(
        lowering.lower(t_build(), "cpu"))
    assert structure(t_low, ir) == structure(j_low, j_ir)
    j_d, t_d = j_passes.diagnose(j_low), passes.diagnose(t_low)
    assert dataclasses.asdict(t_d) == dataclasses.asdict(j_d)
    assert t_d.pretty() == j_d.pretty()
    assert t_d.verified


def test_diagnostics_report_a_broken_program(fib_low):
    d = passes.diagnose(_mutate_target(fib_low))
    assert not d.verified and "out of range" in d.verification_error
    assert "verifier:      FAILED" in d.pretty()
    assert passes.diagnose(batching.autobatch(build_fib(), device="cpu").lowered).verified


def test_the_vm_verifies_its_program_when_asked(fib_low):
    from repro_torch.core import pc_vm

    pc_vm.ProgramCounterVM(fib_low, pc_vm.VMConfig(batch_size=2, verify=True), "cpu")
    with pytest.raises(verifier.VerificationError, match="out of range"):
        pc_vm.ProgramCounterVM(_mutate_target(fib_low),
                               pc_vm.VMConfig(batch_size=2, verify=True), "cpu")
    pc_vm.ProgramCounterVM(_mutate_target(fib_low), pc_vm.VMConfig(batch_size=2), "cpu")


def test_kernel_wrappers_answer_fake_tensors_by_their_shape_rule():
    """K3 and K4 launch through ``ctypes``, which takes no fake tensor: given
    one, each returns an empty tensor of its output's shape, dtype and
    device (computed after its argument checks), and runs nothing."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops

    with fake.fake_mode():
        q = torch.zeros((2, 9, 64), dtype=torch.bfloat16)
        kv = torch.zeros((2, 16, 3, 64), dtype=torch.bfloat16)
        out = fd_ops.decode_attention(q, kv, kv, torch.zeros(2, dtype=torch.int32))
        qa = torch.zeros((1, 64, 9, 64))
        att = fa_ops.flash_attention(qa, torch.zeros((1, 64, 3, 64)),
                                     torch.zeros((1, 64, 3, 64)), causal=True)
        with pytest.raises(TypeError, match="count must be int32"):
            fd_ops.decode_attention(q, kv, kv, torch.zeros(2))
    assert fake.is_fake(out) and fake.is_fake(att)
    assert (out.shape, out.dtype) == ((2, 9, 64), torch.bfloat16)
    assert (att.shape, att.dtype) == ((1, 64, 9, 64), torch.float32)
    assert not fake.is_fake(torch.zeros(1))
