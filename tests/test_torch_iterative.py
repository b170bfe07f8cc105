"""The port's hand-batched iterative NUTS against the JAX package's
``repro.mcmc.iterative`` (``jax.vmap`` of its while loops), chain by
chain: equal gradient counts, and ``theta``/``sum_theta``/``sum_sq``
within ``rtol=1e-5, atol=1e-6``.  The floats are not bit-exact: the
targets' reductions sum in another order in the two libraries (``logp``
differs in its last bit) and ``normal`` draws by an ulp or two, and
leapfrog trajectories carry such differences forward, so they grow with
the chain's length (correlated Gaussian, 16 chains: largest difference
2e-6 after 4 trajectories, 4e-6 on a running sum after 6).  Also the
sampler's moments (tests/test_mcmc.py's ``TestIterativeBaseline``) and
the popcount bit trick against numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.mcmc import iterative as j_iterative  # noqa: E402
from repro.mcmc import nuts as j_nuts  # noqa: E402
from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.mcmc import iterative as t_iterative  # noqa: E402
from repro_torch.mcmc import nuts as t_nuts  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402

CASES = {
    # tests/test_mcmc.py's grad-count comparison.
    "isotropic_gaussian": dict(
        target=("isotropic_gaussian", (4,), {}),
        settings=dict(max_tree_depth=6, num_steps=5, steps_per_leaf=2),
        eps=0.3, seed=7, chains=8,
    ),
    # tests/test_mcmc.py's moments target, over 4 trajectories.
    "correlated_gaussian": dict(
        target=("correlated_gaussian", (8,), {"rho": 0.9}),
        settings=dict(max_tree_depth=8, num_steps=4, steps_per_leaf=4),
        eps=0.25, seed=7, chains=16,
    ),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    case = CASES[request.param]
    name, targs, tkw = case["target"]
    j_target = getattr(j_targets, name)(*targs, **tkw)
    t_target = getattr(t_targets, name)(*targs, **tkw, device="cpu")
    args = j_nuts.initial_state(j_target, case["chains"], eps=case["eps"], seed=case["seed"])
    j_out = j_iterative.run_batched(j_target, j_nuts.NutsSettings(**case["settings"]), *args)
    t_run = t_iterative.make_batched(t_target, t_nuts.NutsSettings(**case["settings"]),
                                     device="cpu")
    t_out = t_run(*interop.nuts_inputs_from_numpy(*[np.asarray(a) for a in args],
                                                  device="cpu"))
    return dict(j_out=j_out, t_out=t_out, t_run=t_run, chains=case["chains"],
                dim=t_target.dim)


def test_grads_equal_chain_by_chain(runs):
    got = runs["t_out"]["grads"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(runs["j_out"]["grads"]))
    assert runs["t_run"].chain.iterations > 0


@pytest.mark.parametrize("key", ["theta", "sum_theta", "sum_sq"])
def test_samples_allclose(runs, key):
    got = runs["t_out"][key]
    assert got.dtype == torch.float32 and tuple(got.shape) == (runs["chains"], runs["dim"])
    np.testing.assert_allclose(got.numpy(), np.asarray(runs["j_out"][key]),
                               rtol=1e-5, atol=1e-6)


def test_moments():
    """The hand-batched sampler samples the target distribution."""
    t = t_targets.correlated_gaussian(8, rho=0.9, device="cpu")
    s = t_nuts.NutsSettings(max_tree_depth=8, num_steps=60, steps_per_leaf=4)
    z = 64
    theta0, eps, keys = t_nuts.initial_state(t, z, eps=0.25, seed=3, device="cpu")
    out = t_iterative.run_batched(t, s, theta0, eps, keys, device="cpu")
    n = z * s.num_steps
    mean = out["sum_theta"].sum(0).numpy() / n
    ex2 = out["sum_sq"].sum(0).numpy() / n
    std = np.sqrt(ex2 - mean**2)
    np.testing.assert_allclose(mean, 0.0, atol=0.12)
    np.testing.assert_allclose(std, 1.0, atol=0.12)
    assert int(out["grads"].sum()) > 0


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(-2**31, 2**31, 1000, dtype=np.int64).astype(np.int32),
        np.array([0, 1, -1, 2**31 - 1, -2**31, 1023, 1024], np.int32),
    ])
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x], np.int32)
    got = t_iterative.popcount(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_make_batched_without_device_raises_without_cuda(monkeypatch):
    t = t_targets.isotropic_gaussian(3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_iterative.make_batched(t, t_nuts.NutsSettings(3, 1, 1))
