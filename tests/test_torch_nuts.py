"""NUTS in both packages on the same inputs (passed across through
``repro_torch.interop``): per-chain ``lane_steps`` and ``tag_stats["grad"]``
are exactly equal — the same control flow, chain by chain — and the
samples agree to ``rtol=1e-4, atol=1e-5``.  The floats cannot be bit-exact:
dot products and reductions sum in another order in the two libraries, and
``normal`` draws differ by ulps (see test_torch_prng.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402

CASES = {
    # tests/test_mcmc.py:16-17
    "isotropic_gaussian": dict(
        target=("isotropic_gaussian", (3,)),
        settings=dict(max_tree_depth=5, num_steps=4, steps_per_leaf=2),
        eps=0.4, seed=2,
    ),
    # tests/test_mcmc.py:79-80
    "logistic_regression": dict(
        target=("logistic_regression", (200, 8)),
        settings=dict(max_tree_depth=6, num_steps=3, steps_per_leaf=2),
        eps=0.05, seed=5,
    ),
}
CHAINS = 4
STATE_KEYS = ("theta", "sum_theta", "sum_sq")


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    case = CASES[request.param]
    name, targs = case["target"]
    j_target = getattr(j_targets, name)(*targs)
    t_target = getattr(t_targets, name)(*targs, device="cpu")
    j_kern = j_nuts.make_nuts_kernel(
        j_target, j_nuts.NutsSettings(**case["settings"]), max_steps=50_000
    )
    t_kern = t_nuts.make_nuts_kernel(
        t_target, t_nuts.NutsSettings(**case["settings"]), max_steps=50_000,
        device="cpu",
    )
    args = j_nuts.initial_state(j_target, CHAINS, eps=case["eps"], seed=case["seed"])
    j_out = j_kern(*args)
    t_out = t_kern(*interop.nuts_inputs_from_numpy(
        *[np.asarray(a) for a in args], device="cpu"))
    return dict(case=case, args=args, t_target=t_target, j_kern=j_kern,
                t_kern=t_kern, j_out=j_out, t_out=t_out)


def test_same_control_flow_chain_by_chain(runs):
    j_res, t_res = runs["j_kern"].last_result, runs["t_kern"].last_result
    assert t_res.converged and bool(j_res.converged)
    np.testing.assert_array_equal(t_res.lane_steps.numpy(), np.asarray(j_res.lane_steps))
    assert runs["t_kern"].tag_stats["grad"] == runs["j_kern"].tag_stats["grad"]
    assert t_res.steps == int(j_res.steps)
    np.testing.assert_array_equal(t_res.block_exec, np.asarray(j_res.block_exec))


@pytest.mark.parametrize("key", STATE_KEYS)
def test_samples_allclose(runs, key):
    got = runs["t_out"][key]
    assert got.dtype == torch.float32 and tuple(got.shape) == (CHAINS, runs["t_target"].dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(runs["j_out"][key]),
                               rtol=1e-4, atol=1e-5)


def test_initial_state_matches_reference(runs):
    case = runs["case"]
    ours = t_nuts.initial_state(runs["t_target"], CHAINS, eps=case["eps"],
                                seed=case["seed"], device="cpu")
    theirs = runs["args"]
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
    assert float(ours[1]) == float(theirs[1])
    np.testing.assert_array_equal(interop.keys_to_numpy(ours[2]), np.asarray(theirs[2]))


def test_target_data_identical():
    j_t = j_targets.logistic_regression(50, 4, seed=3)
    t_t = t_targets.logistic_regression(50, 4, seed=3, device="cpu")
    w = np.linspace(-1, 1, 4).astype(np.float32)
    np.testing.assert_allclose(float(t_t.logp(torch.from_numpy(w))),
                               float(j_t.logp(w)), rtol=1e-6)


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target = t_targets.isotropic_gaussian(3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_nuts.make_nuts_kernel(target, t_nuts.NutsSettings(3, 1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_targets.logistic_regression(10, 2)
