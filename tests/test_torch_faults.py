"""The port's per-lane fault containment against the JAX package's.

tests/test_faults.py's cases run on the port: quarantine and raise
policies, each fault kind (non-finite write, watchdog, stack overflow),
the exceptions' per-lane evidence, validation, the executor key and the
stepper's fault surface.  Over schedule x fuse x policy, the chaos
program of ``tools/torch_chaos.py`` gives fault codes, ``steps``,
``block_exec`` and the raised exception bit-exact with the JAX VM on
``tools/chaos.py``'s program, and under quarantine the healthy lanes are
bit-exact with a fault-free run.

Fault order inside a push group: a lane whose first push writes NaN and
whose second push overflows gets ``nonfinite``, as in the reference, which
checks push by push; the case sets up such lanes in a VM state directly,
since the port's stack groups fuse those pushes into one launch.

An overflowed lane under ``on_fault="quarantine"`` leaves the loop at its
overflow, so the overflow program halts with no ``max_steps`` bound.
Under ``"raise"`` the watchdog cannot end it: its code is already
``stack_overflow`` (first fault wins) and the loop stops early only for
non-finite and watchdog faults — in both packages, as the last case shows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import batching as j_batching  # noqa: E402
from repro.core import frontend as j_frontend  # noqa: E402
from repro.core import pc_vm as j_pc_vm  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import frontend as t_frontend  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from repro_torch.core.frontend import F32, I32  # noqa: E402
from tests.test_torch_lowering import PROGRAMS  # noqa: E402
from tests.test_torch_pc_vm import _inputs  # noqa: E402
from tools import chaos as j_chaos  # noqa: E402
from tools import torch_chaos as t_chaos  # noqa: E402

Z = 8
X8 = np.arange(Z, dtype=np.int32) * 37


def _t(a, dtype=np.int32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype))


def _sqrt_program():
    """``f(x) = sqrt(x)``: negative lanes write NaN into VM state."""
    pb = t_frontend.ProgramBuilder(main="f")
    fb = pb.function("f", ["x"], ["out"], {"x": F32}, {"out": F32})
    fb.assign("out", lambda x: torch.sqrt(x), ["x"], name="root")
    fb.return_()
    pb.add(fb)
    return pb.build()


def _chaos_fn(**kw):
    return t_chaos.chaos_fn(device="cpu", **{"max_steps": 100_000, **kw})


class TestQuarantine:
    def test_nonfinite_quarantined_lanes_flagged_healthy_exact(self):
        fn = t_batching.autobatch(_sqrt_program(), on_fault="quarantine",
                                  detect_nonfinite=True, device="cpu")
        out = fn(_t([1.0, 4.0, -1.0, 9.0], np.float32))["out"].numpy()
        np.testing.assert_array_equal(fn.last_result.fault_code.numpy(),
                                      [0, 0, t_pc_vm.FAULT_NONFINITE, 0])
        np.testing.assert_array_equal(out[[0, 1, 3]], [1.0, 2.0, 3.0])

    def test_nonfinite_check_is_opt_in(self):
        fn = t_batching.autobatch(_sqrt_program(), device="cpu")
        out = fn(_t([-1.0, 4.0], np.float32))["out"].numpy()
        assert np.isnan(out[0]) and out[1] == 2.0
        assert not fn.last_result.fault_code.any()

    @pytest.mark.parametrize("mode,code", [
        (1, t_pc_vm.FAULT_NONFINITE),
        (2, t_pc_vm.FAULT_WATCHDOG),
        (3, t_pc_vm.FAULT_STACK_OVERFLOW),
    ])
    def test_each_fault_kind_quarantines(self, mode, code):
        fn = _chaos_fn(on_fault="quarantine")
        modes = np.zeros((Z,), np.int32)
        modes[2] = modes[5] = mode
        clean = fn(_t(X8), _t(np.zeros(Z)))["out"].numpy()
        out = fn(_t(X8), _t(modes))["out"].numpy()
        np.testing.assert_array_equal(fn.last_result.fault_code.numpy(),
                                      np.where(modes == mode, code, 0))
        np.testing.assert_array_equal(out[modes == 0], clean[modes == 0])
        assert fn.last_result.converged

    def test_converges_with_every_kind_at_once(self):
        fn = _chaos_fn(on_fault="quarantine")
        modes = np.array([0, 1, 2, 3, 0, 3, 2, 1], np.int32)
        clean = fn(_t(X8), _t(np.zeros(Z)))["out"].numpy()
        out = fn(_t(X8), _t(modes))["out"].numpy()
        np.testing.assert_array_equal(fn.last_result.fault_code.numpy(),
                                      [t_chaos.EXPECT_CODE[int(m)] for m in modes])
        np.testing.assert_array_equal(out[modes == 0], clean[modes == 0])


class TestRaisePolicy:
    def test_nonfinite_raises_lanefault_with_lanes(self):
        fn = t_batching.autobatch(_sqrt_program(), on_fault="raise",
                                  detect_nonfinite=True, device="cpu")
        with pytest.raises(t_pc_vm.LaneFault) as ei:
            fn(_t([1.0, -4.0, 9.0, -16.0], np.float32))
        np.testing.assert_array_equal(ei.value.lanes, [1, 3])
        assert ei.value.faults == {1: "nonfinite", 3: "nonfinite"}
        assert "quarantine" in str(ei.value)

    def test_watchdog_raises_and_fails_fast(self):
        fn = _chaos_fn(on_fault="raise", max_steps=10_000_000)
        modes = np.zeros((Z,), np.int32)
        modes[3] = 2
        with pytest.raises(t_pc_vm.LaneFault) as ei:
            fn(_t(X8), _t(modes))
        assert ei.value.faults == {3: "watchdog"}
        assert fn.last_result.steps < 2 * t_chaos.LANE_STEP_BUDGET

    def test_overflow_carries_mask_and_lanes(self):
        fn = _chaos_fn(on_fault="raise")
        modes = np.zeros((Z,), np.int32)
        modes[0] = modes[6] = 3
        with pytest.raises(t_pc_vm.StackOverflow) as ei:
            fn(_t(X8), _t(modes))
        np.testing.assert_array_equal(ei.value.depth_exceeded, modes == 3)
        np.testing.assert_array_equal(ei.value.lanes, [0, 6])


class TestValidation:
    def test_bad_on_fault_rejected(self):
        with pytest.raises(ValueError, match="on_fault"):
            t_batching.autobatch(_sqrt_program(), on_fault="ignore", device="cpu")

    def test_bad_lane_step_budget_rejected(self):
        with pytest.raises(ValueError, match="lane_step_budget"):
            t_pc_vm.VMConfig(batch_size=2, lane_step_budget=0)

    def test_trace_capacity_and_mesh_are_checked(self):
        """A trace capacity below 1 is refused.  Lane sharding is ported
        (the quarantine cell over two ranks: tests/test_torch_mesh.py): a
        mesh with the local backends is refused, and mesh=2 with no ranks
        running raises at the call instead of running on one device."""
        with pytest.raises(ValueError, match="capacity >= 1"):
            t_batching.autobatch(_sqrt_program(), trace=0, device="cpu")
        with pytest.raises(ValueError, match="pc backend"):
            t_batching.autobatch(_sqrt_program(), mesh=2, backend="local", device="cpu")
        fn = t_batching.autobatch(_sqrt_program(), mesh=2, device="cpu")
        with pytest.raises(ValueError, match="needs 2 ranks"):
            fn(_t([-1.0, 4.0], np.float32))


class TestCacheKey:
    def test_fault_knobs_are_part_of_the_executor_key(self):
        prog = _sqrt_program()
        a = t_batching.autobatch(prog, on_fault="quarantine", detect_nonfinite=True,
                                 device="cpu")
        b = t_batching.autobatch(prog, device="cpu")
        x = _t([-1.0, 4.0], np.float32)
        a(x)
        b(x)
        assert a.last_result.fault_code.any()
        assert not b.last_result.fault_code.any()
        (ka,), (kb,) = a._executors, b._executors
        assert ka != kb and ka[-3:] == ("quarantine", True, None)


class TestStepperFaults:
    def _drive(self, st, state):
        while not st.done(state):
            state = st.step(state, 64)
        return state

    def test_fault_surface_and_inject_clears(self):
        fn = _chaos_fn(on_fault="quarantine")
        modes = np.array([0, 2, 0, 1, 0, 0, 3, 0], np.int32)
        st = fn.stepper(_t(X8), _t(modes))
        state = self._drive(st, st.init())
        np.testing.assert_array_equal(st.fault_code(state).numpy(),
                                      [t_chaos.EXPECT_CODE[int(m)] for m in modes])
        np.testing.assert_array_equal(st.lane_faulted(state).numpy(), modes != 0)
        state = st.inject(state, modes != 0, _t(X8), _t(np.zeros(Z)))
        assert not st.lane_faulted(state).any()
        state = self._drive(st, state)
        assert not st.fault_code(state).any()
        clean = fn(_t(X8), _t(np.zeros(Z)))["out"]
        assert torch.equal(st.outputs(state)["out"], clean)

    def test_result_raises_under_raise_policy_only(self):
        modes = np.array([0, 1, 0, 0, 0, 0, 0, 0], np.int32)
        st = _chaos_fn(on_fault="raise").stepper(_t(X8), _t(modes))
        state = self._drive(st, st.init())
        with pytest.raises(t_pc_vm.LaneFault):
            st.result(state)
        st2 = _chaos_fn(on_fault="quarantine").stepper(_t(X8), _t(modes))
        st2.result(self._drive(st2, st2.init()))


# ---------------------------------------------------------------------------
# Against the JAX VM
# ---------------------------------------------------------------------------

MODES16 = t_chaos.make_modes(16, 0.25, seed=0)
X16 = np.random.default_rng(0).integers(0, 10_000, (16,)).astype(np.int32)


@pytest.fixture(scope="module")
def programs():
    return j_chaos.build_chaos_program(), t_chaos.build_chaos_program()


def _outcome(call):
    try:
        out = call()
        return out, None
    except (j_pc_vm.StackOverflow, j_pc_vm.LaneFault, t_pc_vm.StackOverflow,
            t_pc_vm.LaneFault) as e:
        return None, e


@pytest.mark.parametrize("policy", ["quarantine", "raise"])
@pytest.mark.parametrize("fuse", [True, False], ids=["fuse", "nofuse"])
@pytest.mark.parametrize("schedule", t_pc_vm.SCHEDULES)
def test_fault_codes_bit_exact_with_jax_vm(programs, schedule, fuse, policy):
    """One JAX executor and one port executor per cell: the fault-free run
    and the chaotic run go through each."""
    assert np.array_equal(MODES16, j_chaos.make_modes(16, 0.25, seed=0))
    j_prog, t_prog = programs
    knobs = dict(max_depth=t_chaos.MAX_DEPTH, max_steps=200_000, schedule=schedule,
                 fuse=fuse, on_fault=policy, detect_nonfinite=True,
                 lane_step_budget=t_chaos.LANE_STEP_BUDGET)
    j_fn = j_batching.autobatch(j_prog, backend="pc", batch_size=16, **knobs)
    t_fn = t_batching.autobatch(t_prog, device="cpu", **knobs)
    zeros = np.zeros(16, np.int32)
    clean = t_fn(_t(X16), _t(zeros))["out"].numpy()
    j_out, j_exc = _outcome(lambda: j_fn(jnp.asarray(X16), jnp.asarray(MODES16)))
    t_out, t_exc = _outcome(lambda: t_fn(_t(X16), _t(MODES16)))
    j_res, t_res = j_fn.last_result, t_fn.last_result
    np.testing.assert_array_equal(t_res.fault_code.numpy(), np.asarray(j_res.fault_code))
    assert t_res.steps == int(j_res.steps)
    np.testing.assert_array_equal(t_res.block_exec, np.asarray(j_res.block_exec))
    np.testing.assert_array_equal(t_res.lane_steps.numpy(), np.asarray(j_res.lane_steps))
    assert type(t_exc).__name__ == type(j_exc).__name__
    if t_exc is not None:
        np.testing.assert_array_equal(t_exc.lanes, j_exc.lanes)
    if policy == "quarantine":
        assert t_exc is None and t_res.converged
        np.testing.assert_array_equal(t_res.fault_code.numpy(),
                                      [t_chaos.EXPECT_CODE[int(m)] for m in MODES16])
        healthy = MODES16 == 0
        np.testing.assert_array_equal(t_out["out"].numpy()[healthy], clean[healthy])
        np.testing.assert_array_equal(t_out["out"].numpy(), np.asarray(j_out["out"]))


def _nan_then_overflow_programs():
    """``rec(x, n)``: a self-call pushes ``x`` then ``n`` (then the pc) in one
    group, both new tops read from temps."""
    progs = []
    for fe, torch_like, f32, i32 in ((j_frontend, jnp, j_frontend.spec((), jnp.float32),
                                      j_frontend.spec((), jnp.int32)),
                                     (t_frontend, torch, F32, I32)):
        pb = fe.ProgramBuilder(main="rec")
        fb = pb.function("rec", ["x", "n"], ["out"], {"x": f32, "n": i32}, {"out": f32})
        c = fb.prim(lambda n: n <= 0, ["n"], name="base")
        with fb.if_(c):
            fb.copy("x", out="out")
            fb.return_()
        t1 = fb.prim(lambda x: x * 2.0, ["x"], name="dbl")
        t2 = fb.prim(lambda n: n - 1, ["n"], name="dec")
        fb.call("rec", [t1, t2], out="out")
        fb.return_()
        pb.add(fb)
        progs.append(pb.build())
    return progs


@pytest.mark.parametrize("detect", [True, False], ids=["detect", "nodetect"])
def test_nan_then_overflow_in_one_push_group(detect):
    """Lanes resting at the self-call block with crafted pointers and tops:
    the group pushes ``rec/x`` (new top ``2x``) then ``rec/n``, then the pc.
    With ``detect_nonfinite`` the reference checks each push in turn
    (overflow, new top) and the pc push's overflow at the terminator."""
    d = 6
    j_prog, t_prog = _nan_then_overflow_programs()
    x = np.array([np.nan, 1.0, np.nan, 1.0, np.nan, 1.0], np.float32)
    n = np.full(6, 3, np.int32)
    ptr_x = np.array([d - 1, d - 1, 1, 1, d, 1], np.int32)
    ptr_n = np.array([d, d, 1, 1, d, 1], np.int32)
    pc_ptr = np.array([2, 2, 2, d, 2, 2], np.int32)
    knobs = dict(max_depth=d, on_fault="quarantine", detect_nonfinite=detect)
    j_fn = j_batching.autobatch(j_prog, backend="pc", batch_size=6, **knobs)
    t_fn = t_batching.autobatch(t_prog, device="cpu", **knobs)
    ones = np.ones(6, np.float32)
    j_fn(jnp.asarray(ones), jnp.asarray(n))
    t_fn(_t(ones, np.float32), _t(n))
    j_vm, t_vm = j_fn._executor(6).vm, t_fn._last_executor.vm
    (b,) = [i for i, groups in enumerate(t_vm.stack_groups)
            for g in groups if g.kind == "push" and g.vars == ("rec/x", "rec/n") and g.pc]
    assert "rec/x" not in t_vm.lowered.temp_vars

    t_state = t_vm.init_state({"rec/x": _t(x, np.float32), "rec/n": _t(n)})
    t_state["pc_top"].fill_(b)
    t_state["pc_ptr"].copy_(_t(pc_ptr))
    t_state["ptrs"]["rec/x"].copy_(_t(ptr_x))
    t_state["ptrs"]["rec/n"].copy_(_t(ptr_n))
    t_vm.dispatch(t_state, b)

    j_state = j_vm.init_state({"rec/x": jnp.asarray(x), "rec/n": jnp.asarray(n)})
    j_state["pc_top"] = jnp.full((6,), b, jnp.int32)
    j_state["pc_ptr"] = jnp.asarray(pc_ptr)
    j_state["ptrs"] = dict(j_state["ptrs"], **{"rec/x": jnp.asarray(ptr_x),
                                               "rec/n": jnp.asarray(ptr_n)})
    j_state = j_vm._block_fns[b](j_state)

    codes = t_state["fault_code"].numpy()
    np.testing.assert_array_equal(codes, np.asarray(j_state["fault_code"]))
    np.testing.assert_array_equal(t_state["depth_exceeded"].numpy(),
                                  np.asarray(j_state["depth_exceeded"]))
    nonfinite, overflow = t_pc_vm.FAULT_NONFINITE, t_pc_vm.FAULT_STACK_OVERFLOW
    if detect:
        # Lane 0: NaN first, overflow second -> nonfinite; lane 4 overflows
        # on its first push; lane 3's pc push overflows at the terminator.
        np.testing.assert_array_equal(codes, [nonfinite, overflow, nonfinite, overflow,
                                              overflow, 0])
    else:
        np.testing.assert_array_equal(codes, [overflow, overflow, 0, overflow, overflow, 0])


@pytest.mark.parametrize("name", ["fib", "deep_recursion"])
def test_overflowed_lanes_halt_under_quarantine_without_a_step_bound(name):
    """The overflow program of test_stack_overflow_raised_on_the_same_lanes
    with ``lane_step_budget`` and no ``max_steps`` bound: quarantine takes
    each overflowed lane out at its overflow, so the run halts, with the
    JAX VM's codes, steps and per-lane step counts."""
    j_build, t_build = PROGRAMS[name]
    args = _inputs(name, seed=1)
    knobs = dict(max_depth=5, on_fault="quarantine", lane_step_budget=10_000)
    j_fn = j_batching.autobatch(j_build(), use_kernel=True, **knobs)
    t_fn = t_batching.autobatch(t_build(), device="cpu", **knobs)
    j_fn(*args)
    t_fn(*[torch.from_numpy(a) for a in args])
    j_res, t_res = j_fn.last_result, t_fn.last_result
    assert t_res.converged and t_res.steps == int(j_res.steps) < 100
    codes = t_res.fault_code.numpy()
    np.testing.assert_array_equal(codes, np.asarray(j_res.fault_code))
    np.testing.assert_array_equal(codes != 0, t_res.depth_exceeded.numpy())
    assert (codes[codes != 0] == t_pc_vm.FAULT_STACK_OVERFLOW).all() and codes.any()
    np.testing.assert_array_equal(t_res.lane_steps.numpy(), np.asarray(j_res.lane_steps))


def test_watchdog_does_not_end_an_overflowed_lane_under_raise():
    """Under ``"raise"`` an overflowed fib lane spins on in both packages
    whatever the budget: first fault wins, so the watchdog never re-codes
    it, and only non-finite and watchdog faults stop the loop early."""
    j_build, t_build = PROGRAMS["fib"]
    args = _inputs("fib", seed=1)
    knobs = dict(max_depth=5, on_fault="raise", lane_step_budget=200, max_steps=1_500)
    with pytest.raises(j_pc_vm.StackOverflow):
        j_batching.autobatch(j_build(), use_kernel=True, **knobs)(*args)
    fn = t_batching.autobatch(t_build(), device="cpu", **knobs)
    with pytest.raises(t_pc_vm.StackOverflow):
        fn(*[torch.from_numpy(a) for a in args])
    res = fn.last_result
    assert res.steps == 1_500 and not res.converged
    assert set(res.fault_code.numpy().tolist()) == {0, t_pc_vm.FAULT_STACK_OVERFLOW}
