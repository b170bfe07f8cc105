"""The port's VM schedules (earliest, popular, lookahead, sweep), lane
compaction and scheduler statistics against the JAX VM of the same
configuration.

For every schedule x ``compact_every`` in (None, 1, 3) x ``fuse`` (on,
off), on fib, mutual recursion, pow_loop and two seeded random programs
(the scheduler oracle's, rebuilt in the port by
``repro_torch.testing.RandomProgram``): outputs, ``steps``,
``block_exec``, ``block_active``, ``lane_steps`` and the statistics
``mean_occupancy``, ``mean_lane_occupancy`` and ``masked_updates`` are
bit-exact.  The port's dispatch sequence replays the NumPy oracle rule of
tests/test_scheduler_oracle.py for the switch schedules, a sweep counts
every block that had residents, and NUTS samples identical chains under
every schedule and with compaction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as j_batching  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import ir as t_ir  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from repro_torch.testing import random_program_inputs  # noqa: E402
from tests.test_scheduler_oracle import _oracle_pick, _seeded_inputs  # noqa: E402
from tests.test_torch_lowering import PROGRAMS  # noqa: E402
from tests.test_torch_pc_vm import MAX_DEPTH, _inputs  # noqa: E402

SCHEDULES = ("earliest", "popular", "lookahead", "sweep")
COMPACT = (None, 1, 3)


def _case(name: str):
    """(JAX program, port program, numpy inputs, autobatch limits)."""
    if name.startswith("random"):
        seed = int(name[len("random"):])
        j_prog, n, x = _seeded_inputs(seed)
        t_prog, _, _ = random_program_inputs(seed)
        return j_prog, t_prog, (n, x), dict(max_depth=64, max_steps=200_000)
    j_build, t_build = PROGRAMS[name]
    return j_build(), t_build(), _inputs(name), dict(max_depth=MAX_DEPTH[name])


CASES = ("fib", "mutual", "pow_loop", "random0", "random3")


def _port_fn(name, **knobs):
    _, t_prog, args, limits = _case(name)
    fn = t_batching.autobatch(t_prog, device="cpu", **limits, **knobs)
    out = fn(*[torch.from_numpy(a) for a in args])
    return fn, out, args


@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "nofuse"])
@pytest.mark.parametrize("compact_every", COMPACT, ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", CASES)
def test_bit_exact_with_jax_vm(name, schedule, compact_every, fuse):
    j_prog, t_prog, args, limits = _case(name)
    knobs = dict(schedule=schedule, compact_every=compact_every, fuse=fuse)
    j_fn = j_batching.autobatch(j_prog, **limits, **knobs)
    t_fn = t_batching.autobatch(t_prog, device="cpu", **limits, **knobs)
    j_out = j_fn(*args)
    t_out = t_fn(*[torch.from_numpy(a) for a in args])
    for k, v in j_out.items():
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(v))
    j_res, t_res = j_fn.last_result, t_fn.last_result
    assert t_res.converged and bool(j_res.converged)
    assert t_res.steps == int(j_res.steps)
    np.testing.assert_array_equal(t_res.block_exec, np.asarray(j_res.block_exec))
    np.testing.assert_array_equal(t_res.block_active, np.asarray(j_res.block_active))
    np.testing.assert_array_equal(t_res.lane_steps.numpy(), np.asarray(j_res.lane_steps))
    j_st, t_st = j_fn.scheduler_stats, t_fn.scheduler_stats
    assert (t_st.schedule, t_st.compact_every, t_st.fused, t_st.num_blocks, t_st.steps) == (
        j_st.schedule, j_st.compact_every, j_st.fused, j_st.num_blocks, j_st.steps)
    assert t_st.fused_from == j_st.fused_from
    assert t_st.mean_occupancy == j_st.mean_occupancy
    assert t_st.mean_lane_occupancy == j_st.mean_lane_occupancy
    assert t_st.masked_updates == j_st.masked_updates


def _succ_matrix(lowered) -> np.ndarray:
    """The lookahead successor matrix of a port program, rebuilt from its
    terminators as the oracle rebuilds the JAX one."""
    nb = len(lowered.blocks)
    succ = np.zeros((nb, nb), np.int64)
    for i, blk in enumerate(lowered.blocks):
        t = blk.term
        if isinstance(t, (t_ir.LJump, t_ir.LPushJump)):
            targets = (t.target,)
        elif isinstance(t, t_ir.LBranch):
            targets = (t.true, t.false)
        else:
            targets = ()
        for s in targets:
            if 0 <= s < nb:
                succ[i, s] = 1
    return succ


def _stepping_vm(name, schedule, compact_every):
    fn, _, args = _port_fn(name, schedule=schedule, compact_every=compact_every)
    vm = t_pc_vm.ProgramCounterVM(fn.lowered, t_pc_vm.VMConfig(
        batch_size=len(args[0]), max_depth=fn.resolved_max_depth,
        schedule=schedule, compact_every=compact_every), "cpu")
    params = fn.program.functions[fn.main].params
    state = vm.init_state({f"{fn.main}/{p}": torch.from_numpy(a)
                           for p, a in zip(params, args)})
    return fn, vm, state


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", ["earliest", "popular", "lookahead"])
@pytest.mark.parametrize("name", CASES)
def test_dispatch_sequence_replays_numpy_oracle(name, schedule, compact_every):
    """Each pick equals the oracle on the pc values read before it, and
    exactly that block's counter moves."""
    fn, vm, state = _stepping_vm(name, schedule, compact_every)
    succ = _succ_matrix(vm.lowered)
    exit_idx, picks = vm.lowered.exit_index, 0
    while True:
        pc = state["pc_top"].numpy().astype(np.int64)
        got = vm.pick(state)
        if not (pc < exit_idx).any():  # the oracle picks among live lanes
            assert got == exit_idx
            break
        want = _oracle_pick(pc, exit_idx, vm.num_blocks, schedule, succ)
        assert got == want, f"dispatch {picks}: picked {got}, oracle {want}"
        before = state["block_exec"].copy()
        vm.dispatch(state, got)
        delta = state["block_exec"] - before
        assert delta.sum() == 1 and delta[got] == 1
        picks += 1
    assert picks == fn.last_result.steps


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("name", ["random0", "random3"])
def test_sweep_counts_every_resident_block(name, compact_every):
    """A sweep counts each block resident at its start once, and moves no
    counter by more than one."""
    fn, vm, state = _stepping_vm(name, "sweep", compact_every)
    sweeps = 0
    while vm.live(state):
        pc = state["pc_top"].numpy()
        resident = np.zeros(vm.num_blocks, bool)
        resident[pc[pc < vm.lowered.exit_index]] = True
        before = state["block_exec"].clone()
        vm.sweep(state)
        delta = (state["block_exec"] - before).numpy()
        assert set(np.unique(delta)) <= {0, 1}
        assert np.all(delta[resident] == 1)
        sweeps += 1
    assert sweeps == fn.last_result.steps >= 2


@pytest.mark.parametrize("name", ["fib", "mutual"])
def test_stack_overflow_lanes_in_caller_order_under_compaction(name):
    j_prog, t_prog, args, _ = _case(name)
    limits = dict(max_depth=4, max_steps=2_000, compact_every=1)
    with pytest.raises(t_pc_vm.StackOverflow) as t_exc:
        t_batching.autobatch(t_prog, device="cpu", **limits)(
            *[torch.from_numpy(a) for a in args])
    from repro.core import pc_vm as j_pc_vm

    with pytest.raises(j_pc_vm.StackOverflow) as j_exc:
        j_batching.autobatch(j_prog, **limits)(*args)
    assert len(t_exc.value.lanes) > 0
    np.testing.assert_array_equal(t_exc.value.lanes, j_exc.value.lanes)


def test_compaction_permutes_rows_and_restores_caller_order():
    """After a compaction the rows are grouped by pc with halted lanes
    last, every stack is a contiguous tensor, and the result is in caller
    order."""
    fn, vm, state = _stepping_vm("fib", "earliest", 1)
    while True:
        b = vm.pick(state)
        if b >= vm.lowered.exit_index:
            break
        vm.dispatch(state, b)
        key = torch.where(state["pc_top"] < vm.lowered.exit_index, state["pc_top"],
                          vm.num_blocks + 1)
        assert torch.equal(key, key.sort().values)
        assert all(s.is_contiguous() for s in state["stacks"].values())
        assert state["pc_stack"].is_contiguous()
    assert not torch.equal(state["lane_ids"], torch.arange(len(state["lane_ids"]),
                                                           dtype=torch.int32))
    res = vm.result(state)
    assert torch.equal(res.outputs["fib/out"], fn.last_result.outputs["fib/out"])
    assert torch.equal(res.lane_steps, fn.last_result.lane_steps)


def test_bad_knobs_raise():
    _, t_prog, _, _ = _case("fib")
    with pytest.raises(ValueError, match="schedule"):
        t_batching.autobatch(t_prog, schedule="fastest", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        t_batching.autobatch(t_prog, backend="xla", device="cpu")
    fn = t_batching.autobatch(t_prog, compact_every=0, device="cpu")
    with pytest.raises(ValueError, match="compact_every"):
        fn(torch.arange(3, dtype=torch.int32))


def test_stats_off_keeps_results():
    fn, out, args = _port_fn("fib", collect_stats=False)
    ref, ref_out, _ = _port_fn("fib")
    assert torch.equal(out["out"], ref_out["out"])
    assert fn.last_result.block_exec is None and fn.tag_stats == {}
    st = fn.scheduler_stats
    assert st.steps is None and st.masked_updates is None and np.isnan(st.mean_occupancy)


@pytest.fixture(scope="module")
def nuts_case():
    target = t_targets.correlated_gaussian(5, 0.9, device="cpu")
    settings = t_nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    args = t_nuts.initial_state(target, 6, eps=0.3, seed=4, device="cpu")
    kern = t_nuts.make_nuts_kernel(target, settings, device="cpu")
    return target, settings, args, kern(*args), kern.last_result


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_nuts_chains_identical_under_every_schedule(nuts_case, schedule, compact_every):
    target, settings, args, want, want_res = nuts_case
    kern = t_nuts.make_nuts_kernel(target, settings, schedule=schedule,
                                   compact_every=compact_every, device="cpu")
    got = kern(*args)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    res = kern.last_result
    # Every chain runs the same blocks whatever the order of dispatches.
    assert torch.equal(res.lane_steps, want_res.lane_steps)
    assert res.tag_stats["grad"][1] == want_res.tag_stats["grad"][1]
