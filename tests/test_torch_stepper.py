"""The port's segmented execution (``Stepper``,
``ProgramCounterVM.run_segment`` / ``inject`` / ``park``) against one run and against the
JAX package's Stepper.

tests/test_stepper.py's cases run on the port: segments match the single
call, the stepper shares the call's executor, per-lane views mid-flight,
``done`` at ``max_steps``, re-binding, masked inject and park.  A chain of
segments of mixed sizes is bit-exact with one run — outputs, ``steps``,
``block_exec``, ``block_active``, the tile accumulator, ``lane_steps`` and
fault codes — on fib and a small NUTS under every schedule, with and
without lane compaction.  A scripted sequence of segments, injects (into
running and halted lanes) and parks gives the same views in both packages,
with and without compaction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batching as j_batching  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from repro_torch.testing import build_fib  # noqa: E402
from tests.test_core import FIB  # noqa: E402
from tests.test_core import build_fib as j_build_fib  # noqa: E402

SCHEDULES = ("earliest", "popular", "lookahead", "sweep")
SIZES = (1, 2, 5, 3)  # segment sizes, cycled


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32))


@pytest.fixture(scope="module")
def fib_fn():
    return t_batching.autobatch(build_fib(), max_depth=24, device="cpu")


def _drive(st, state, n=64):
    hops = 0
    while not st.done(state):
        state = st.step(state, n)
        hops += 1
        assert hops < 10_000
    return state, hops


class TestStepperBasics:
    def test_segments_match_single_shot(self, fib_fn):
        n = _t([0, 3, 7, 11])
        single = fib_fn(n)["out"]
        st = fib_fn.stepper(n)
        state, hops = _drive(st, st.init(), 5)
        assert torch.equal(st.result(state)["out"], single)
        assert hops > 1
        assert st.steps(state) == fib_fn.last_result.steps

    def test_stepper_shares_executor_cache(self, fib_fn):
        n = _t([1, 2, 3, 4])
        fib_fn(n)
        before = dict(fib_fn._executors)
        st = fib_fn.stepper(n)
        assert fib_fn._executors == before
        assert st.vm is fib_fn._last_executor.vm

    def test_lane_done_and_outputs_mid_flight(self, fib_fn):
        n = _t([0, 11])
        st = fib_fn.stepper(n)
        state = st.step(st.init(), 3)
        done = st.lane_done(state).numpy()
        assert done[0] and not done[1]
        assert st.outputs(state)["out"][0] == FIB[0]
        state, _ = _drive(st, state)
        np.testing.assert_array_equal(st.outputs(state)["out"].numpy(), FIB[[0, 11]])

    def test_done_when_max_steps_exhausted(self):
        fn = t_batching.autobatch(build_fib(), max_depth=24, max_steps=5, device="cpu")
        st = fn.stepper(_t([11, 11]))
        state, _ = _drive(st, st.init(), 3)
        assert st.steps(state) == 5
        assert not st.lane_done(state).any()

    def test_requires_pc_backend(self):
        fn = t_batching.autobatch(build_fib(), backend="local", device="cpu")
        with pytest.raises(ValueError, match="pc"):
            fn.stepper(_t([1, 2]))

    def test_init_rebinds_values(self, fib_fn):
        st = fib_fn.stepper(_t([1, 2, 3, 4]))
        state, _ = _drive(st, st.init(_t([5, 6, 7, 8])))
        np.testing.assert_array_equal(st.outputs(state)["out"].numpy(), FIB[[5, 6, 7, 8]])

    def test_batch_size_mismatch_raises(self, fib_fn):
        st = fib_fn.stepper(_t([1, 2, 3, 4]))
        with pytest.raises(TypeError, match="batch"):
            st.init(_t([1, 2]))


class TestInjectAndPark:
    def test_inject_reinitializes_masked_lanes_only(self, fib_fn):
        st = fib_fn.stepper(_t([2, 9, 4, 6]))
        state, _ = _drive(st, st.init(), 32)
        mask = np.array([True, False, True, False])
        state = st.inject(state, mask, _t([10, 0, 8, 0]))
        np.testing.assert_array_equal(st.lane_done(state).numpy(), ~mask)
        state, _ = _drive(st, state, 32)
        np.testing.assert_array_equal(st.outputs(state)["out"].numpy(), FIB[[10, 9, 8, 6]])

    def test_park_idles_lanes(self, fib_fn):
        st = fib_fn.stepper(_t([7, 7, 7, 7]))
        state = st.park(st.init(), np.ones(4, bool))
        assert st.done(state)
        assert st.steps(state) == 0
        state = st.inject(state, np.array([True, False, True, False]), _t([3, 0, 5, 0]))
        state, _ = _drive(st, state)
        out = st.outputs(state)["out"].numpy()
        assert out[0] == FIB[3] and out[2] == FIB[5]

    def test_steps_accumulate_across_inject(self, fib_fn):
        n = _t([3, 3, 3, 3])
        st = fib_fn.stepper(n)
        state, _ = _drive(st, st.init())
        first = st.steps(state)
        state = st.inject(state, np.ones(4, bool), n)
        state, _ = _drive(st, state)
        assert st.steps(state) == 2 * first

    def test_inject_and_park_write_in_place(self, fib_fn):
        """The state keeps every tensor object, shape, dtype and layout."""
        st = fib_fn.stepper(_t([2, 9, 4, 6]))
        state = st.step(st.init(), 7)
        tensors = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
        for group in ("tops", "stacks", "ptrs"):
            tensors.update({f"{group}/{k}": v for k, v in state[group].items()})
        before = {k: (id(v), v.shape, v.dtype, v.stride()) for k, v in tensors.items()}
        state = st.inject(state, np.array([True, False, False, True]), _t([5, 0, 0, 1]))
        state = st.park(state, np.array([False, True, False, False]))
        after = {k: (id(v), v.shape, v.dtype, v.stride()) for k, v in tensors.items()}
        assert after == before
        assert all(state[k] is v for k, v in tensors.items() if "/" not in k)


def _views(st, state, to_np):
    res = st.vm.result(state)
    return dict(done=to_np(st.lane_done(state)), out=to_np(st.outputs(state)["out"]),
                steps=int(np.asarray(st.steps(state))), lane_steps=to_np(res.lane_steps),
                codes=to_np(st.fault_code(state)))


def _script(st, wrap, to_np):
    """Segments, an inject into running and halted lanes, a park, a refill."""
    seen = []
    state = st.init()
    state = st.step(state, 4)
    seen.append(_views(st, state, to_np))
    state = st.inject(state, np.array([True, False, True, False, False, True]),
                      wrap([5, 0, 2, 0, 0, 8]))
    state = st.step(state, 6)
    seen.append(_views(st, state, to_np))
    state = st.park(state, np.array([False, True, False, False, True, False]))
    while not st.done(state):
        state = st.step(state, 9)
    seen.append(_views(st, state, to_np))
    state = st.inject(state, np.array([False, True, False, True, True, False]),
                      wrap([0, 6, 0, 10, 4, 0]))
    while not st.done(state):
        state = st.step(state, 7)
    seen.append(_views(st, state, to_np))
    return seen


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
def test_inject_and_park_match_the_jax_stepper(compact_every):
    n0 = [9, 3, 11, 1, 7, 6]
    j_fn = j_batching.autobatch(j_build_fib(), backend="pc", max_depth=24,
                                compact_every=compact_every)
    t_fn = t_batching.autobatch(build_fib(), max_depth=24, compact_every=compact_every,
                                device="cpu")
    j_seen = _script(j_fn.stepper(jnp.asarray(n0, jnp.int32)),
                     lambda a: jnp.asarray(a, jnp.int32), np.asarray)
    t_seen = _script(t_fn.stepper(_t(n0)), _t, lambda x: x.numpy())
    for i, (j, t) in enumerate(zip(j_seen, t_seen)):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"point {i}: {k}")
    np.testing.assert_array_equal(t_seen[-1]["out"], FIB[[5, 6, 2, 10, 4, 8]])


def _segmented(fn, args, sizes=SIZES):
    st = fn.stepper(*args)
    state = st.init()
    i = 0
    while not st.done(state):
        state = st.step(state, sizes[i % len(sizes)])
        i += 1
    assert i > 1
    return st, state


def _assert_same_run(fn, args, st, state):
    want = fn(*args)
    res = fn.last_result
    got = st.result(state)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    seg = st.vm.result(state)
    assert seg.steps == res.steps and seg.converged == res.converged
    np.testing.assert_array_equal(seg.block_exec, res.block_exec)
    np.testing.assert_array_equal(seg.block_active, res.block_active)
    assert torch.equal(seg.lane_steps, res.lane_steps)
    assert torch.equal(seg.fault_code, res.fault_code)
    assert seg.sched == res.sched  # tile accumulator (mean_occupancy) included
    return res


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fib_segments_bit_exact_with_one_run(schedule, compact_every):
    n = np.random.default_rng(3).integers(0, 12, 9).astype(np.int32)
    fn = t_batching.autobatch(build_fib(), max_depth=16, schedule=schedule,
                              compact_every=compact_every, device="cpu")
    st, state = _segmented(fn, (_t(n),))
    res = _assert_same_run(fn, (_t(n),), st, state)
    j_fn = j_batching.autobatch(j_build_fib(), max_depth=16, schedule=schedule,
                                compact_every=compact_every)
    j_fn(n)
    assert res.steps == int(j_fn.last_result.steps)


@pytest.fixture(scope="module")
def nuts_args():
    target = t_targets.correlated_gaussian(5, 0.9, device="cpu")
    settings = t_nuts.NutsSettings(max_tree_depth=5, num_steps=2, steps_per_leaf=2)
    return target, settings, t_nuts.initial_state(target, 6, eps=0.3, seed=4, device="cpu")


@pytest.mark.parametrize("compact_every", [None, 1], ids=lambda c: f"ce{c}")
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_nuts_segments_bit_exact_with_one_run(nuts_args, schedule, compact_every):
    target, settings, args = nuts_args
    fn = t_nuts.make_nuts_kernel(target, settings, schedule=schedule,
                                 compact_every=compact_every, device="cpu")
    st, state = _segmented(fn, args, sizes=(7, 3, 11))
    res = _assert_same_run(fn, args, st, state)
    assert res.converged and not res.fault_code.any()


def test_segment_bounded_by_max_steps():
    fn = t_batching.autobatch(build_fib(), max_depth=24, max_steps=10, device="cpu")
    st = fn.stepper(_t([11, 11]))
    state = st.step(st.init(), 1_000)
    assert st.steps(state) == 10
    state = st.step(state, 5)
    assert st.steps(state) == 10 and st.done(state)


def test_vm_segments_through_the_vm_surface():
    """``init_state``/``run_segment``/``result`` on the VM itself."""
    fn = t_batching.autobatch(build_fib(), max_depth=16, device="cpu")
    n = _t([4, 8, 1])
    want = fn(n)["out"]
    vm = fn._last_executor.vm
    state = vm.init_state({"fib/n": n})
    while vm.live(state):
        vm.run_segment(state, 4)
    res = vm.result(state)
    assert torch.equal(res.outputs["fib/out"], want)
    assert res.steps == fn.last_result.steps
    status = vm.lane_status(state).numpy()
    np.testing.assert_array_equal(status, [[1, 1, 1], [0, 0, 0]])
    assert t_pc_vm.FAULT_NAMES[int(status[1, 0])] == "ok"
