"""Profile-guided optimization in the port against the JAX package's.

On the divergent-parity program of tests/test_pgo.py and on tiny NUTS
(``max_tree_depth=3``, 8 chains), tracing a run, distilling its block
profile and re-lowering with ``fn.optimize`` gives what the reference
gives: ``num_blocks``, ``func_entries``, ``block_order``, layout groups,
``block_weights``, the lowered program op for op, ``vm_steps``,
``masked_updates`` and the outputs (NUTS's floats allclose, as in
tests/test_torch_nuts.py; both equal the port's unoptimized run bit for
bit).  A profile saved by the JAX package gives the port the same lowered
program.  The segmented Stepper reads (and ``inject`` writes) packed
members through their slots, two digests make two executors, and the
three tools run on the CPU.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as j_batching  # noqa: E402
from repro.core import ir as j_ir  # noqa: E402
from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro.obs import block_profile as j_block_profile  # noqa: E402
from repro_torch.core import analysis, batching, ir, passes  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402
from repro_torch.obs import BlockProfile, block_profile  # noqa: E402
from repro_torch.testing import build_parity, parity_inputs  # noqa: E402
from tests.test_pgo import build_parity as j_build_parity  # noqa: E402
from tests.test_torch_lowering import structure  # noqa: E402

PARITY = dict(max_depth=8, max_steps=100_000, fuse=True, verify=True)
NUTS_SETTINGS = dict(max_tree_depth=3, num_steps=2, steps_per_leaf=2)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _np(out) -> dict:
    return {k: np.asarray(v) for k, v in out.items()}


def _summary(fn) -> dict:
    st, low = fn.scheduler_stats, fn.lowered
    return dict(
        num_blocks=st.num_blocks, vm_steps=int(st.steps), masked_updates=st.masked_updates,
        func_entries=low.func_entries, block_order=low.block_order,
        block_weights=low.block_weights,
        layout=None if low.state_layout is None else low.state_layout.groups,
    )


def _structure(low, ir_mod) -> dict:
    """tests/test_torch_lowering.py's structure, with the pack and unpack
    prims' ``batched`` flag left out (the port's run on the batch, the
    reference's are vmapped), and the PGO provenance."""
    s = structure(low, ir_mod)
    s["blocks"] = [
        (label, [op[:4] + (None,) + op[5:] if op[0] == "prim" and op[3] in ("pack", "unpack")
                 else op for op in ops], term)
        for label, ops, term in s["blocks"]]
    s.update(block_weights=low.block_weights, block_order=low.block_order,
             layout=None if low.state_layout is None else low.state_layout.groups)
    return s


@pytest.fixture(scope="module")
def parity():
    """Both packages: a traced run, its profile and the optimized run."""
    args = parity_inputs()
    runs = {}
    for pkg, fn in (("jax", j_batching.autobatch(j_build_parity(), backend="pc",
                                                  trace=True, **PARITY)),
                    ("port", batching.autobatch(build_parity(), trace=True, device="cpu",
                                                **PARITY))):
        call = (lambda f: f(*args)) if pkg == "jax" else (lambda f: f(*map(_t, args)))
        base = _np(call(fn))
        prof = (j_block_profile if pkg == "jax" else block_profile)(fn.last_trace)
        opt = fn.optimize(prof)
        runs[pkg] = dict(fn=fn, base=base, base_sum=_summary(fn), prof=prof, opt=opt,
                         out=_np(call(opt)), sum=_summary(opt))
    return runs


@pytest.fixture(scope="module")
def tiny_nuts():
    j_t, t_t = j_targets.isotropic_gaussian(2), t_targets.isotropic_gaussian(2, device="cpu")
    j_kern = j_nuts.make_nuts_kernel(j_t, j_nuts.NutsSettings(**NUTS_SETTINGS), backend="pc",
                                     max_steps=200_000, verify=True)
    t_kern = t_nuts.make_nuts_kernel(t_t, t_nuts.NutsSettings(**NUTS_SETTINGS),
                                     max_steps=200_000, verify=True, device="cpu")
    j_args = j_nuts.initial_state(j_t, 8, eps=0.1, seed=0)
    t_args = t_nuts.initial_state(t_t, 8, eps=0.1, seed=0, device="cpu")
    runs = {}
    for pkg, kern, args, bp in (("jax", j_kern, j_args, j_block_profile),
                                ("port", t_kern, t_args, block_profile)):
        traced = kern.with_options(trace=True)
        base = _np(traced(*args))
        prof = bp(traced.last_trace)
        opt = kern.optimize(prof)
        runs[pkg] = dict(kern=kern, traced=traced, args=args, base=base,
                         base_sum=_summary(traced), prof=prof, opt=opt,
                         out=_np(opt(*args)), sum=_summary(opt))
    return runs


def test_parity_pgo_equals_the_reference(parity):
    j, t = parity["jax"], parity["port"]
    assert t["prof"].digest() == j["prof"].digest()
    assert t["sum"] == j["sum"]
    assert t["base_sum"] == j["base_sum"]
    for k in j["out"]:
        np.testing.assert_array_equal(t["out"][k], j["out"][k])
        np.testing.assert_array_equal(t["out"][k], t["base"][k])
    s, b = t["sum"], t["base_sum"]
    assert s["vm_steps"] < b["vm_steps"] and s["masked_updates"] < b["masked_updates"]
    assert s["num_blocks"] < b["num_blocks"]
    assert "h" not in s["func_entries"] and "g" not in s["func_entries"]
    assert "h" in t["fn"].lowered.func_entries  # structural fusion keeps the frame
    assert _structure(t["opt"].lowered, ir) == _structure(j["opt"].lowered, j_ir)


def test_nuts_pgo_equals_the_reference(tiny_nuts):
    j, t = tiny_nuts["jax"], tiny_nuts["port"]
    assert t["prof"].digest() == j["prof"].digest()
    assert t["base_sum"] == j["base_sum"]
    assert t["sum"] == j["sum"]
    assert (t["base_sum"]["num_blocks"], t["sum"]["num_blocks"]) == (21, 19)
    assert len(t["sum"]["layout"]) == 4
    assert t["sum"]["vm_steps"] < t["base_sum"]["vm_steps"]
    assert t["sum"]["masked_updates"] < t["base_sum"]["masked_updates"]
    for k in j["out"]:
        np.testing.assert_array_equal(t["out"][k], t["base"][k])
        np.testing.assert_allclose(t["out"][k], j["out"][k], rtol=1e-4, atol=1e-5)
    assert _structure(t["opt"].lowered, ir) == _structure(j["opt"].lowered, j_ir)
    # Packing touches state variables only: no stack group names a member.
    vm = t["opt"]._last_executor.vm
    members = t["opt"].lowered.state_layout.members()
    assert not members & {v for groups in vm.stack_groups for g in groups for v in g.vars}


@pytest.mark.parametrize("which", ["parity", "nuts"])
def test_a_profile_saved_by_jax_gives_the_same_program(which, parity, tiny_nuts, tmp_path):
    runs = parity if which == "parity" else tiny_nuts
    path = tmp_path / "jax_profile.json"
    runs["jax"]["prof"].save(str(path))
    port = runs["port"]
    fn = port["fn"] if which == "parity" else port["kern"]
    opt = fn.optimize(str(path))
    assert opt._pgo_digest() == port["prof"].digest()
    assert _structure(opt.lowered, ir) == _structure(port["opt"].lowered, ir)
    assert _structure(opt.lowered, ir) == _structure(runs["jax"]["opt"].lowered, j_ir)


def test_segmented_stepper_reads_and_injects_packed_members(parity):
    opt, args = parity["port"]["opt"], [_t(a) for a in parity_inputs()]
    layout = opt.lowered.state_layout
    assert {"par/n", "par/x", "par/out"} <= layout.members()
    st = opt.stepper(*args)
    state = st.init()
    while not st.done(state):
        state = st.step(state, 3)
    assert torch.equal(st.result(state)["out"], _t(parity["port"]["out"]["out"]))
    assert st.steps(state) == parity["port"]["sum"]["vm_steps"]
    # Refill half the lanes with new inputs (written into their slots).
    n2, x2 = parity_inputs(16)
    n2, x2 = n2[8:], x2[8:]
    mask = np.arange(8) % 2 == 0
    state = st.inject(state, _t(mask), _t(n2), _t(x2))
    while not st.done(state):
        state = st.step(state, 5)
    want = np.where(mask, opt(_t(n2), _t(x2))["out"].numpy(), parity["port"]["out"]["out"])
    np.testing.assert_array_equal(st.result(state)["out"].numpy(), want)


def test_packed_members_leave_vm_state(parity):
    low = parity["port"]["opt"].lowered
    for packed, members in low.state_layout.groups.items():
        assert low.var_specs[packed].shape == (len(members),) + low.var_specs[members[0]].shape
        for i, m in enumerate(members):
            assert m in low.temp_vars and low.state_layout.slot_of(m) == (packed, i)
    vm = parity["port"]["opt"]._last_executor.vm
    state = vm.init_state({p: torch.zeros(8, dtype=torch.int32) for p in low.main_params})
    assert not low.state_layout.members() & set(state["tops"])
    # Liveness keeps the packed output live at exit: DCE drops nothing.
    after = passes.DeadCodeElimination().run(low)
    assert set(after.var_specs) == set(low.var_specs)
    live = analysis.LoweredLiveness(low)
    exits = [i for i, b in enumerate(low.blocks) if isinstance(b.term, ir.LReturn)]
    assert any(p in live.live_out[i] for i in exits for p in low.state_layout.groups)
    text = low.pretty()
    assert "reordered: [" in text and "layout %pgo/pack0: [" in text and "<weight " in text


def test_digests_key_executors_and_share_lowerings(parity):
    fn, prof = parity["port"]["fn"], parity["port"]["prof"]
    opt = fn.optimize(prof)
    assert opt.optimize(prof) is not opt and fn.with_options(pgo=prof)._pgo_digest() == \
        prof.digest()
    n2, x2 = parity_inputs(8)
    other = fn.with_options(trace=True)
    other(_t(n2 + 1), _t(x2))
    prof2 = block_profile(other.last_trace)
    assert prof2.digest() != prof.digest()
    a, b = fn.optimize(prof), fn.optimize(prof2)
    a(_t(n2), _t(x2))
    b(_t(n2), _t(x2))
    (ka,), (kb,) = a._executors, b._executors
    assert ka != kb and prof.digest() in ka and prof2.digest() in kb
    # A knob outside the lowering shares it; fuse, verify or a profile do not.
    low = opt.lowered
    assert opt.with_options(max_steps=50_000).lowered is low
    assert fn.with_options(schedule="lookahead").lowered is fn.lowered
    assert fn.with_options(verify=False).lowered is not fn.lowered
    with pytest.raises(TypeError, match="unknown option"):
        fn.with_options(bogus=1)
    with pytest.raises(TypeError, match="pgo"):
        batching.autobatch(build_parity(), pgo=object(), device="cpu")


def test_a_profile_of_another_program_is_refused(parity):
    prof = parity["port"]["prof"]
    unfused = batching.autobatch(build_parity(), max_depth=8, fuse=False, pgo=prof,
                                 device="cpu")
    with pytest.raises(passes.PassError, match="re-profile with the same"):
        unfused.lowered


def test_pgo_profile_round_trip(parity, tmp_path):
    prof = parity["port"]["prof"]
    path = tmp_path / "p.json"
    prof.save(str(path))
    back = BlockProfile.load(str(path))
    assert back.digest() == prof.digest()
    np.testing.assert_array_equal(back.transitions, prof.transitions)


def _tool(name):
    return importlib.import_module(f"tools.{name}")


@pytest.mark.parametrize("name,argv", [
    ("torch_vmtrace", ["--nuts", "--batch", "4", "--device", "cpu"]),
    ("torch_pgo", ["--nuts", "--batch", "4", "--device", "cpu"]),
    ("torch_irlint", ["--nuts", "--device", "cpu"]),
], ids=["torch_vmtrace", "torch_pgo", "torch_irlint"])
def test_tool_runs_nuts_on_the_cpu(name, argv, capsys):
    assert _tool(name).main(argv) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    if name == "torch_pgo":
        assert "blocks:             21 ->     19" in out and "bit-exact" in out


def test_tools_share_a_profile_file(tmp_path, capsys):
    prof, trace = tmp_path / "p.json", tmp_path / "t.json"
    assert _tool("torch_vmtrace").main(["--nuts", "--batch", "4", "--device", "cpu",
                                        "--blockprof", str(prof), "--out", str(trace)]) == 0
    assert _tool("torch_pgo").main(["--nuts", "--batch", "4", "--device", "cpu",
                                    "--profile", str(prof)]) == 0
    assert f"loaded {prof}" in capsys.readouterr().out
