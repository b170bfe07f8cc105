"""Differentiable target densities for the NUTS experiments, on PyTorch.

Both of the paper's test problems:

* a ``dim``-dimensional correlated Gaussian (Section 4.2's utilization
  study), and
* Bayesian logistic regression with synthetic data (Section 4.1's
  throughput study: 10,000 data points x 100 regressors at full scale).

The data is made with the same numpy code and seed as the JAX package's
``repro.mcmc.targets``, so both packages see bit-identical data.  The
tensors a target closes over live on ``device`` (``None``: the card, and a
machine without CUDA raises).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device


@dataclass(frozen=True)
class Target:
    """A log-density with its gradient and ground-truth moments (if known)."""

    name: str
    dim: int
    logp: Callable[[torch.Tensor], torch.Tensor]
    device: torch.device
    # Ground-truth mean/marginal-std for moment tests (None if unknown).
    true_mean: np.ndarray | None = None
    true_std: np.ndarray | None = None


def correlated_gaussian(dim: int = 100, rho: float = 0.95, *, device=None) -> Target:
    """N(0, Sigma) with AR(1)-style correlation ``rho`` between neighbours.

    The precision matrix of an AR(1) process is tridiagonal, which keeps
    ``logp`` cheap (O(dim)) while the distribution is strongly correlated —
    exactly the regime where NUTS trajectory lengths vary a lot between
    chains, stressing batch utilization (paper Fig. 6).
    """
    device = resolve_device(device)
    s = 1.0 / (1.0 - rho * rho)
    main = np.full((dim,), s * (1 + rho * rho))
    main[0] = main[-1] = s
    off = np.full((dim - 1,), -s * rho)
    prec_main = torch.tensor(main.astype(np.float32), device=device)
    prec_off = torch.tensor(off.astype(np.float32), device=device)

    def logp(x: torch.Tensor) -> torch.Tensor:
        quad = torch.sum(prec_main * x * x) + 2.0 * torch.sum(
            prec_off * x[:-1] * x[1:]
        )
        return -0.5 * quad

    # Marginal variances of the AR(1) process are all 1.
    return Target(
        name=f"correlated_gaussian(dim={dim},rho={rho})",
        dim=dim,
        logp=logp,
        device=device,
        true_mean=np.zeros(dim),
        true_std=np.ones(dim),
    )


def isotropic_gaussian(dim: int = 10, *, device=None) -> Target:
    device = resolve_device(device)

    def logp(x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(x * x)

    return Target(
        name=f"isotropic_gaussian(dim={dim})",
        dim=dim,
        logp=logp,
        device=device,
        true_mean=np.zeros(dim),
        true_std=np.ones(dim),
    )


def logistic_regression(
    num_data: int = 10_000, dim: int = 100, seed: int = 0, *, device=None
) -> Target:
    """Bayesian logistic regression on synthetic data (paper Section 4.1).

    Standard-normal prior on weights; features drawn N(0, 1); labels drawn
    from the model at a ground-truth weight vector.  The gradient costs
    O(num_data * dim) — an expensive leaf, as in the paper.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(num_data, dim)).astype(np.float32)
    w_true = (rng.normal(size=(dim,)) / np.sqrt(dim)).astype(np.float32)
    logits = x @ w_true
    y = (rng.uniform(size=(num_data,)) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32
    )
    xt = torch.tensor(x, device=device)
    # y in {-1, +1} lets us write the likelihood as log_sigmoid(y * logits).
    y_pm = torch.tensor(2.0 * y - 1.0, device=device)

    def logp(w: torch.Tensor) -> torch.Tensor:
        logits = xt @ w
        loglik = torch.sum(F.logsigmoid(y_pm * logits))
        logprior = -0.5 * torch.sum(w * w)
        return loglik + logprior

    return Target(
        name=f"logistic_regression(n={num_data},d={dim})",
        dim=dim,
        logp=logp,
        device=device,
    )
