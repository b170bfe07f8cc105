"""The port's ahead-of-time handle (``fn.lower(...)`` -> ``AotLowered``,
``api.BatchedProgram.lower_aot``) and ``ProgramCounterVM.step_fn`` against
the JAX package's.

* ``step_fn`` iterated on fib and a small NUTS, under ``earliest``,
  ``popular`` and ``sweep``, moves the pc, the stacks and the outputs as the
  JAX VM's jitted ``step_fn`` does, step by step: bit for bit on fib; on
  NUTS the pc values and integer stacks bit for bit and the floats within
  tests/test_torch_nuts.py's ``rtol=1e-4, atol=1e-5`` (dot products sum in
  another order in the two libraries).  Iterated while ``live`` holds it
  gives ``run()``'s result bit for bit, counters included.
* ``cost_analysis()["flops"]`` against the dot FLOPs of the JAX package's
  compiled HLO with each computation once (``hlo_cost.parse_module`` and
  ``hlo_cost._dot_flops`` summed without loop multipliers, which
  ``hlo_cost.analyze`` would apply), block by block through the
  ``pcvm.block<i>`` scopes.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import batching as j_batching  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch import fake, interop, testing  # noqa: E402
from repro_torch.core import api as t_api  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from tests.test_torch_lowering import PROGRAMS  # noqa: E402
from tests.test_torch_pc_vm import MAX_DEPTH, _inputs  # noqa: E402

SCHEDULES = ("earliest", "popular", "sweep")
NUTS_TOL = dict(rtol=1e-4, atol=1e-5)


def _fib_fns(schedule):
    j_build, t_build = PROGRAMS["fib"]
    limits = dict(max_depth=MAX_DEPTH["fib"], schedule=schedule)
    (n,) = _inputs("fib")
    return (j_batching.autobatch(j_build(), **limits),
            t_batching.autobatch(t_build(), device="cpu", **limits), (n,), (torch.from_numpy(n),))


def _nuts_fns(schedule, target=("isotropic_gaussian", (3,)), steps_per_leaf=2, chains=4):
    name, targs = target
    j_target = getattr(j_targets, name)(*targs)
    t_target = getattr(t_targets, name)(*targs, device="cpu")
    settings = dict(max_tree_depth=5, num_steps=2, steps_per_leaf=steps_per_leaf)
    j_fn = j_nuts.make_nuts_kernel(j_target, j_nuts.NutsSettings(**settings), max_steps=50_000,
                                   schedule=schedule)
    t_fn = t_nuts.make_nuts_kernel(t_target, t_nuts.NutsSettings(**settings), max_steps=50_000,
                                   schedule=schedule, device="cpu")
    args = j_nuts.initial_state(j_target, chains, eps=0.4, seed=2)
    return j_fn, t_fn, args, interop.nuts_inputs_from_numpy(*[np.asarray(a) for a in args],
                                                           device="cpu")


def _assert_same(got, want, exact):
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.int32 and want.dtype == np.uint32:
        got = got.view(np.uint32)  # keys travel as int32 bit patterns in the port
    if exact or not np.issubdtype(got.dtype, np.floating):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **NUTS_TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("program", ["fib", "nuts"])
def test_step_fn_moves_the_state_as_jax_step_fn(program, schedule):
    j_fn, t_fn, j_args, t_args = (_fib_fns if program == "fib" else _nuts_fns)(schedule)
    exact = program == "fib"
    j_st, t_st = j_fn.stepper(*j_args), t_fn.stepper(*t_args)
    j_vm, t_vm = j_st.vm, t_st.vm
    j_state, t_state = j_st.init(), t_st.init()
    j_step, t_step = jax.jit(j_vm.step_fn()), t_vm.step_fn()
    steps = 0
    while t_vm.live(t_state):
        t_state, j_state = t_step(t_state), j_step(j_state)
        steps += 1
        np.testing.assert_array_equal(t_state["pc_top"].numpy(), np.asarray(j_state["pc_top"]))
    assert not np.any(np.asarray(j_state["pc_top"]) < j_vm.lowered.exit_index)
    t_fn(*t_args)
    assert steps == t_fn.last_result.steps
    for key in ("pc_stack", "pc_ptr"):
        np.testing.assert_array_equal(t_state[key].numpy(), np.asarray(j_state[key]))
    assert set(t_state["stacks"]) == set(j_state["stacks"])
    for v in t_state["stacks"]:
        _assert_same(t_state["stacks"][v], j_state["stacks"][v], exact)
        np.testing.assert_array_equal(t_state["ptrs"][v].numpy(), np.asarray(j_state["ptrs"][v]))
    for o in t_vm.lowered.main_outputs:
        _assert_same(t_vm.read_top(t_state, o), j_vm.read_top(j_state, o), exact)


@pytest.mark.parametrize("schedule, compact_every",
                         [("earliest", None), ("lookahead", 1), ("sweep", 1)])
def test_step_fn_to_the_end_is_run(schedule, compact_every):
    """``while live: step`` gives ``run()``'s outputs, steps, block_exec,
    block_active and lane steps bit for bit."""
    _, t_fn, _, t_args = _nuts_fns(schedule)
    t_fn = t_fn.with_options(compact_every=compact_every)
    want = t_fn(*t_args)
    res0 = t_fn.last_result
    st = t_fn.stepper(*t_args)
    vm, state, step = st.vm, st.init(), st.vm.step_fn()
    while vm.live(state):
        state = step(state)
    got, res = st.result(state), vm.result(state)
    for k in want:
        assert torch.equal(got[k], want[k])
    assert res.steps == res0.steps
    np.testing.assert_array_equal(np.asarray(res.block_exec), np.asarray(res0.block_exec))
    np.testing.assert_array_equal(np.asarray(res.block_active), np.asarray(res0.block_active))
    assert torch.equal(res.lane_steps, res0.lane_steps)


def _jax_block_dot_flops(compiled_text: str) -> dict:
    """The compiled HLO's dot FLOPs by ``pcvm.block<i>`` label, each
    computation once."""
    comps, _ = hlo_cost.parse_module(compiled_text)
    out: dict = {}
    for comp in comps.values():
        for ins in comp.instructions:
            if ins.opcode == "dot":
                m = re.search(r"pcvm\.block(\d+)", ins.meta)
                key = f"pcvm.block{m.group(1)}" if m else "outside"
                out[key] = out.get(key, 0.0) + hlo_cost._dot_flops(ins, comp)
    return out


def test_cost_analysis_flops_match_the_compiled_hlo():
    """NUTS on a 200 x 8 logistic regression, 4 chains.  Every block's
    FLOPs equal the compiled HLO's dot FLOPs but block 1's (the leaf: the
    gradient at the start position, then one leapfrog step).  There XLA's
    optimizer removes one of two identical ``X @ theta`` products (the
    lowered StableHLO has both, after inlining the leaf's one-trip loop
    the two share their operands), which eager PyTorch runs twice: block 1
    counts one ``[chains, num_data] x dim`` product more."""
    chains, num_data, dim = 4, 200, 8
    j_fn, t_fn, j_args, t_args = _nuts_fns(
        "earliest", target=("logistic_regression", (num_data, dim)), steps_per_leaf=1,
        chains=chains)
    j_blocks = _jax_block_dot_flops(j_fn.lower(*j_args).compile().as_text())
    handle = t_fn.lower(*t_args)
    counter = op_cost.OpCounter()
    with fake.fake_mode():
        state = handle.vm.init_state(handle.inputs)
        with counter:
            handle.vm.cost_pass(state)
    t_blocks = {k: v for k, v in counter.close().scope_flops.items() if v}
    product = 2.0 * chains * num_data * dim
    assert set(t_blocks) == set(j_blocks) == {f"pcvm.block{b}" for b in (1, 7, 9, 10, 14, 16)}
    for block, flops in j_blocks.items():
        assert t_blocks[block] == flops + (product if block == "pcvm.block1" else 0.0), block
    assert handle.cost_analysis()["flops"] == sum(j_blocks.values()) + product


def test_lower_handle():
    fn = t_batching.autobatch(PROGRAMS["fib"][1](), device="cpu", max_depth=MAX_DEPTH["fib"])
    n = torch.from_numpy(_inputs("fib")[0])
    handle = fn.lower(n)
    assert isinstance(handle, t_batching.AotLowered)
    assert handle.as_text() == fn.lowered.pretty()
    runs = []
    real_run = handle.vm.run
    handle.vm.run = lambda inputs: runs.append(1) or real_run(inputs)
    assert handle.compile() is handle and handle.compile() is handle
    assert runs == [1]  # compiled once
    cost = handle.cost_analysis()
    assert set(cost) == {"flops", "bytes accessed"} and cost["bytes accessed"] > 0
    assert cost["flops"] == 0.0  # fib multiplies nothing
    assert fn.lower(n).vm is handle.vm  # the executor of calls at this batch size
    with pytest.raises(ValueError, match="'pc' backend"):
        fn.with_options(backend="local").lower(n)


def test_lower_aot_of_the_api_shim():
    with pytest.warns(DeprecationWarning, match="batching.autobatch"):
        bp = t_api.autobatch(testing.build_fib(), 2, device="cpu")
    handle = bp.lower_aot({"n": np.array([1, 2], np.int32)})
    assert isinstance(handle, t_batching.AotLowered)
    assert handle.as_text() == bp.lowered.pretty()
    assert handle.cost_analysis()["bytes accessed"] > 0
    with pytest.warns(DeprecationWarning):
        local = t_api.autobatch(testing.build_fib(), 2, backend="local", device="cpu")
    with pytest.raises(ValueError, match="'pc' backend"):
        local.lower_aot({"n": np.array([1, 2], np.int32)})
