"""``Target.grad`` and ``Target.value_and_grad`` of the port
(``repro_torch.mcmc.targets``, on ``torch.func``) against the JAX
package's ``jax.grad`` / ``jax.value_and_grad`` of the same target, for
every target, in float32 (``rtol=1e-5``: two libraries sum the same terms
in another order; ``atol`` 1e-5 of the gradient's largest entry for
entries near zero)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.mcmc import targets as j_targets  # noqa: E402
from repro_torch.mcmc import targets as t_targets  # noqa: E402

TARGETS = {
    "correlated_gaussian": (12, 0.9),
    "isotropic_gaussian": (7,),
    "logistic_regression": (200, 9, 4),
}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_grad_and_value_and_grad_match_jax(name):
    j_t = getattr(j_targets, name)(*TARGETS[name])
    t_t = getattr(t_targets, name)(*TARGETS[name], device="cpu")
    x = np.random.default_rng(5).normal(size=(t_t.dim,)).astype(np.float32)
    want_v, want_g = (np.asarray(a) for a in j_t.value_and_grad()(jnp.asarray(x)))
    atol = 1e-5 * np.abs(want_g).max()
    g = t_t.grad()(torch.from_numpy(x))
    assert g.shape == (t_t.dim,) and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), np.asarray(j_t.grad()(jnp.asarray(x))),
                               rtol=1e-5, atol=atol)
    v, g2 = t_t.value_and_grad()(torch.from_numpy(x))
    assert v.shape == () and g2.shape == (t_t.dim,)
    np.testing.assert_allclose(v.item(), want_v, rtol=1e-5)
    np.testing.assert_allclose(g2.numpy(), want_g, rtol=1e-5, atol=atol)


def test_grad_agrees_with_autograd_and_vmaps():
    """The same gradient as ``torch.autograd.grad`` of ``logp``, and
    batched over chains by ``torch.func.vmap``."""
    t = t_targets.logistic_regression(100, 6, seed=2, device="cpu")
    xs = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 6)).astype(np.float32))
    batched = torch.func.vmap(t.grad())(xs)
    for x, g in zip(xs, batched):
        xr = x.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(t.logp(xr), xr)
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)
