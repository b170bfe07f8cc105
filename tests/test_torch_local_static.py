"""The port's local static autobatching (Algorithm 1) against the JAX
package's ``LocalStaticBatcher`` in its eager mode: on the integer
programs (a tagged fib, mutual recursion, pow_loop and the scheduler
oracle's seeded random programs) the outputs, block executions, primitive
executions and tag counts are bit-exact.  On the CPU ``local`` runs its
segments eagerly, so both modes equal each other; NUTS through ``local``
equals the pc VM chain by chain; and the pc VM's gradient utilization
beats local static batching, the paper's headline property
(tests/test_core.py's ``test_batching_across_depth_beats_local``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import local_static as j_local  # noqa: E402
from repro_torch.core import batching as t_batching  # noqa: E402
from repro_torch.core import local_static as t_local  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from repro_torch.testing import build_tagged_fib, random_program_inputs  # noqa: E402
from tests.test_scheduler_oracle import _seeded_inputs  # noqa: E402
from tests.test_torch_lowering import PROGRAMS  # noqa: E402
from tests.test_torch_pc_vm import _inputs  # noqa: E402


def _j_tagged_fib():
    """tests/test_core.py's tagged fib, built with the JAX package's ProgramBuilder."""
    from repro.core import frontend
    from repro.core.frontend import I32

    pb = frontend.ProgramBuilder()
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


def _case(name):
    if name.startswith("random"):
        seed = int(name[len("random"):])
        j_prog, n, x = _seeded_inputs(seed)
        return j_prog, random_program_inputs(seed)[0], (n, x)
    if name == "tagged_fib":
        return _j_tagged_fib(), build_tagged_fib(), _inputs("fib")
    j_build, t_build = PROGRAMS[name]
    return j_build(), t_build(), _inputs(name)


@pytest.mark.parametrize("jit_blocks", [False, True], ids=["local_eager", "local"])
@pytest.mark.parametrize("name", ["tagged_fib", "mutual", "pow_loop", "random0", "random3"])
def test_bit_exact_with_jax_local_static(name, jit_blocks):
    j_prog, t_prog, args = _case(name)
    z = len(args[0])
    params = j_prog.functions[j_prog.main].params
    j_b = j_local.LocalStaticBatcher(j_prog, z, jit_blocks=False)
    t_b = t_local.LocalStaticBatcher(t_prog, z, jit_blocks=jit_blocks, device="cpu")
    j_out = j_b.run(dict(zip(params, args)))
    t_out = t_b.run({p: torch.from_numpy(a) for p, a in zip(params, args)})
    for k, v in j_out.items():
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(v))
    js, ts = j_b.stats, t_b.stats
    assert (ts.block_execs, ts.primitive_execs) == (js.block_execs, js.primitive_execs)
    assert ts.tag_execs == js.tag_execs and ts.tag_active == js.tag_active


def test_backends_through_autobatch_agree():
    _, t_prog, args = _case("tagged_fib")
    n = torch.from_numpy(args[0])
    outs = {}
    for backend in ("pc", "local", "local_eager", "reference"):
        fn = t_batching.autobatch(t_prog, backend=backend, max_depth=16, device="cpu")
        outs[backend] = fn(n)["out"]
        if backend == "reference":
            assert fn.tag_stats == {} and fn.local_stats is None
        elif backend != "pc":
            assert fn.tag_stats["leaf"][1] == fn.local_stats.tag_active["leaf"]
            assert fn.last_result is None and fn.scheduler_stats is None
    for backend, out in outs.items():
        assert torch.equal(out, outs["pc"]), backend


def test_nuts_local_equals_pc():
    target = t_targets.correlated_gaussian(6, 0.9, device="cpu")
    settings = t_nuts.NutsSettings(max_tree_depth=5, num_steps=3, steps_per_leaf=2)
    args = t_nuts.initial_state(target, 5, eps=0.3, seed=1, device="cpu")
    outs, grads = {}, {}
    for backend in ("pc", "local", "local_eager"):
        kern = t_nuts.make_nuts_kernel(target, settings, backend=backend, device="cpu")
        outs[backend] = kern(*args)
        grads[backend] = kern.tag_stats["grad"]
    for backend in ("local", "local_eager"):
        for k, v in outs["pc"].items():
            assert torch.equal(outs[backend][k], v), (backend, k)
        # The same gradient work, batched worse: as many active lanes, more
        # executions.
        assert grads[backend][1] == grads["pc"][1]
        assert grads[backend][0] >= grads["pc"][0]


def test_batching_across_depth_beats_local():
    """tests/test_core.py's property, on the port: the pc VM runs the
    tagged leaf fewer times, at a higher utilization, than local static
    batching; and both count what the JAX package counts."""
    n = np.random.default_rng(0).integers(8, 13, 32).astype(np.int32)
    stats = {}
    for backend in ("pc", "local"):
        fn = t_batching.autobatch(build_tagged_fib(), backend=backend, max_depth=24,
                                  device="cpu")
        fn(torch.from_numpy(n))
        stats[backend] = (fn.tag_stats["leaf"], fn.utilization["leaf"])
    (pc_execs, _), pc_util = stats["pc"]
    (loc_execs, _), loc_util = stats["local"]
    assert pc_execs < loc_execs
    assert pc_util > loc_util

    from repro.core import batching as j_batching

    for backend in ("pc", "local"):
        j_fn = j_batching.autobatch(_j_tagged_fib(), backend=backend, max_depth=24)
        j_fn(n)
        assert stats[backend][0] == tuple(j_fn.tag_stats["leaf"]), backend


def test_local_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_local.LocalStaticBatcher(build_tagged_fib(), 4)
