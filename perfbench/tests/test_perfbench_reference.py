"""The benchmark's plain reference against the port on the CPU at a tiny
size (the test imports both; the reference imports nothing of the port)."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import compare, nuts as ref_nuts, prng as ref_prng
from perfbench.reference import targets as ref_targets

CFGS = {
    "logistic_regression": {"target": "logistic_regression", "num_data": 300, "dim": 6,
                            "eps": 0.05},
    "correlated_gaussian": {"target": "correlated_gaussian", "dim": 8, "rho": 0.95,
                            "eps": 0.1},
}


def test_reference_imports_nothing_of_the_program():
    for path in Path(ref_nuts.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("numpy", "torch", "__future__"), (path, m)


def test_prng_matches_the_port_draws():
    from repro_torch.mcmc import prng

    keys = np.random.default_rng(1).integers(-2**31, 2**31, (40, 2)).astype(np.int32)
    t = torch.tensor(keys)
    rk = ref_prng.as_keys(keys)
    assert (torch.func.vmap(lambda k: prng.split(k, 4))(t).numpy()
            == ref_prng.split(rk, 4).view(np.int32)).all()
    assert (torch.func.vmap(prng.uniform)(t).numpy() == ref_prng.uniform(rk)).all()
    n = torch.func.vmap(lambda k: prng.normal(k, (16,)))(t).numpy()
    np.testing.assert_allclose(ref_prng.normal(rk, 16), n, rtol=0, atol=1e-6)


def test_targets_match_the_port():
    from repro_torch.mcmc import targets

    w = torch.randn(5, 6, generator=torch.Generator().manual_seed(0))
    ref = ref_targets.make(CFGS["logistic_regression"], 7, torch.float64, "cpu")
    tgt = targets.logistic_regression(300, 6, seed=7, device="cpu")
    g = torch.func.vmap(tgt.grad())(w)
    np.testing.assert_allclose(ref.grad(w.double()).numpy(), g.numpy(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ref.logp(w.double()).numpy(),
                               torch.func.vmap(tgt.logp)(w).numpy(), rtol=1e-5)
    ref = ref_targets.make(CFGS["correlated_gaussian"] | {"dim": 6}, 0, torch.float64, "cpu")
    tgt = targets.correlated_gaussian(6, 0.95, device="cpu")
    np.testing.assert_allclose(ref.grad(w.double()).numpy(),
                               torch.func.vmap(tgt.grad())(w).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["pc", "local"])
@pytest.mark.parametrize("target", sorted(CFGS))
def test_reference_follows_the_port(target, backend):
    from repro_torch.mcmc import nuts, targets

    cfg = CFGS[target]
    if target == "logistic_regression":
        tgt = targets.logistic_regression(cfg["num_data"], cfg["dim"], seed=3, device="cpu")
    else:
        tgt = targets.correlated_gaussian(cfg["dim"], cfg["rho"], device="cpu")
    settings = nuts.NutsSettings(max_tree_depth=5, num_steps=2, steps_per_leaf=4)
    kern = nuts.make_nuts_kernel(tgt, settings, backend=backend, device="cpu")
    g = torch.Generator().manual_seed(11)
    theta0 = 0.1 * torch.randn(12, cfg["dim"], generator=g)
    keys = torch.randint(-2**31, 2**31, (12, 2), generator=g, dtype=torch.int64).to(torch.int32)
    out = kern(theta0, torch.tensor(cfg["eps"]), keys)
    ref = ref_nuts.Nuts(ref_targets.make(cfg, 3, torch.float64, "cpu"), max_tree_depth=5,
                        num_steps=2, steps_per_leaf=4).chain(theta0, cfg["eps"], keys.numpy())
    gaps = compare.chain_gaps(out, ref, 2)
    assert float(gaps.max()) < 1e-4
