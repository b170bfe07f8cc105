"""The port's program-counter VM against the JAX package's VM (with its
Pallas stack kernels, in interpret mode) and against the unbatched
oracles, on the integer programs at a batch of 9: outputs, dispatch count,
per-block execution and occupancy counters and per-lane step counts are
bit-exact; the dispatch sequence replays the NumPy scheduler oracle of
tests/test_scheduler_oracle.py; a too-small ``max_depth`` raises
``StackOverflow`` on the same lanes in both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as j_batching  # noqa: E402
from repro.core import pc_vm as j_pc_vm  # noqa: E402
from repro.core import reference as j_reference  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import pc_vm as t_pc_vm  # noqa: E402
from repro_torch.core import reference as t_reference  # noqa: E402
from tests.test_scheduler_oracle import _oracle_pick, _succ_matrix  # noqa: E402
from tests.test_torch_lowering import PROGRAMS  # noqa: E402

Z = 9


def _inputs(name: str, seed: int = 0) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    if name == "fib":
        return (rng.integers(0, 11, Z).astype(np.int32),)
    if name == "pow_loop":
        return (
            rng.uniform(0.5, 1.5, Z).astype(np.float32),
            rng.integers(0, 6, Z).astype(np.int32),
        )
    if name == "mutual":
        return (rng.integers(0, 20, Z).astype(np.int32),)
    return (rng.integers(0, 12, Z).astype(np.int32),)


INT_PROGRAMS = ("fib", "pow_loop", "mutual", "deep_recursion")
MAX_DEPTH = {"fib": 16, "pow_loop": None, "mutual": 24, "deep_recursion": 16}


@pytest.fixture(scope="module", params=INT_PROGRAMS)
def vm_runs(request):
    """One run of each program through both VMs and both oracles."""
    name = request.param
    j_build, t_build = PROGRAMS[name]
    args = _inputs(name)
    j_prog, t_prog = j_build(), t_build()
    j_fn = j_batching.autobatch(j_prog, use_kernel=True, max_depth=MAX_DEPTH[name])
    t_fn = t_batching.autobatch(t_prog, max_depth=MAX_DEPTH[name], device="cpu")
    j_out = j_fn(*args)
    t_out = t_fn(*[torch.from_numpy(a) for a in args])
    params = j_prog.functions[j_prog.main].params
    j_ref = j_reference.run_reference_batch(j_prog, dict(zip(params, args)))
    t_ref = t_reference.run_reference_batch(
        t_prog, {p: torch.from_numpy(a) for p, a in zip(params, args)}
    )
    return dict(name=name, args=args, j_fn=j_fn, t_fn=t_fn, j_out=j_out,
                t_out=t_out, j_ref=j_ref, t_ref=t_ref)


def test_outputs_bit_exact_with_jax_vm_and_oracles(vm_runs):
    for k, j_val in vm_runs["j_out"].items():
        t_val = vm_runs["t_out"][k].numpy()
        np.testing.assert_array_equal(t_val, np.asarray(j_val))
        np.testing.assert_array_equal(t_val, vm_runs["j_ref"][k])
        np.testing.assert_array_equal(t_val, vm_runs["t_ref"][k].numpy())


def test_dispatch_counters_bit_exact(vm_runs):
    j_res, t_res = vm_runs["j_fn"].last_result, vm_runs["t_fn"].last_result
    assert t_res.converged and bool(j_res.converged)
    assert t_res.steps == int(j_res.steps)
    np.testing.assert_array_equal(t_res.block_exec, np.asarray(j_res.block_exec))
    np.testing.assert_array_equal(t_res.block_active, np.asarray(j_res.block_active))
    np.testing.assert_array_equal(t_res.lane_steps.numpy(), np.asarray(j_res.lane_steps))
    assert t_res.block_exec.dtype == np.int32
    assert t_res.lane_steps.dtype == torch.int32
    assert vm_runs["t_fn"].tag_stats == vm_runs["j_fn"].tag_stats


def test_dispatch_sequence_replays_numpy_oracle(vm_runs):
    """Drive the port's VM one dispatch at a time: each pick equals the
    earliest-schedule oracle on the pc values read before it, and exactly
    that block's counter moves."""
    fn = vm_runs["t_fn"]
    low = fn.lowered
    vm = t_pc_vm.ProgramCounterVM(
        low, t_pc_vm.VMConfig(batch_size=Z, max_depth=fn.resolved_max_depth), "cpu"
    )
    params = fn.program.functions[fn.main].params
    state = vm.init_state({
        f"{fn.main}/{p}": torch.from_numpy(a) for p, a in zip(params, vm_runs["args"])
    })
    succ = _succ_matrix(low)
    picks = 0
    while True:
        pc = state["pc_top"].numpy().astype(np.int64)
        want = _oracle_pick(pc, low.exit_index, vm.num_blocks, "earliest", succ)
        got = vm.pick(state)
        assert got == want, f"dispatch {picks}: picked {got}, oracle {want}"
        if got >= low.exit_index:
            break
        before = state["block_exec"].copy()
        vm.dispatch(state, got)
        delta = state["block_exec"] - before
        assert delta.sum() == 1 and delta[got] == 1
        picks += 1
    assert picks == fn.last_result.steps


@pytest.mark.parametrize("name", ["fib", "deep_recursion"])
def test_stack_overflow_raised_on_the_same_lanes(name):
    j_build, t_build = PROGRAMS[name]
    args = _inputs(name, seed=1)
    # Overflowed lanes run on garbage and may never halt: bound the run.
    limits = dict(max_depth=5, max_steps=2_000)
    with pytest.raises(j_pc_vm.StackOverflow) as j_exc:
        j_batching.autobatch(j_build(), use_kernel=True, **limits)(*args)
    with pytest.raises(t_pc_vm.StackOverflow) as t_exc:
        t_batching.autobatch(t_build(), device="cpu", **limits)(
            *[torch.from_numpy(a) for a in args]
        )
    assert len(t_exc.value.lanes) > 0
    np.testing.assert_array_equal(t_exc.value.lanes, j_exc.value.lanes)
    np.testing.assert_array_equal(
        t_exc.value.depth_exceeded, np.asarray(j_exc.value.depth_exceeded)
    )


def test_shared_argument_and_batch_checks():
    from repro_torch.core.batching import Batched, Shared
    from repro_torch.core.frontend import F32, I32

    _, t_build = PROGRAMS["pow_loop"]
    fn = t_batching.autobatch(t_build(), in_specs=(Shared(F32), Batched(I32)),
                              device="cpu")
    k = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    out = fn(torch.tensor(2.0), k)["out"]
    assert torch.equal(out, torch.tensor([1.0, 2.0, 4.0, 8.0]))
    with pytest.raises(TypeError, match="shared argument"):
        fn(torch.ones(4), k)
    with pytest.raises(TypeError, match="positional"):
        fn(k)


def test_autobatch_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, t_build = PROGRAMS["fib"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_batching.autobatch(t_build())

