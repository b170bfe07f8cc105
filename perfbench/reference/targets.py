"""The two targets of the paper, regenerated from the seed by the benchmark's
own code, with closed-form log densities and gradients over a batch of
positions ``[chains, dim]``.

* Bayesian logistic regression (Section 4.1): features ``x ~ N(0, 1)``
  ``[N, D]`` and a true weight ``w ~ N(0, 1/D)`` drawn in float32 by NumPy's
  ``default_rng(seed)``, labels ``y ~ Bernoulli(sigmoid(x w))`` as ``+-1``;
  ``logp(w) = sum_n log sigmoid(y_n x_n.w) - |w|^2 / 2`` and
  ``grad = x^T (y * sigmoid(-y x w)) - w``.
* A ``D``-dimensional Gaussian with AR(1) correlation ``rho`` (Section
  4.2): a tridiagonal precision ``P`` with ``s = 1/(1-rho^2)`` on the
  diagonal ends, ``s(1+rho^2)`` inside and ``-s rho`` off it, in float32;
  ``logp(x) = -x^T P x / 2`` and ``grad = -P x``.

Every computation runs in the ``dtype`` and on the ``device`` given.
"""
from __future__ import annotations

import numpy as np
import torch


class LogisticRegression:
    def __init__(self, num_data: int, dim: int, seed: int, dtype, device):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(num_data, dim)).astype(np.float32)
        w_true = (rng.normal(size=(dim,)) / np.sqrt(dim)).astype(np.float32)
        p = 1.0 / (1.0 + np.exp(-(x @ w_true)))
        y = (rng.uniform(size=(num_data,)) < p).astype(np.float32)
        self.dim = dim
        self.x = torch.tensor(x, device=device).to(dtype)
        self.y = torch.tensor(2.0 * y - 1.0, device=device).to(dtype)

    def logp(self, w: torch.Tensor) -> torch.Tensor:
        z = self.y * (w @ self.x.T)
        return torch.nn.functional.logsigmoid(z).sum(-1) - 0.5 * (w * w).sum(-1)

    def grad(self, w: torch.Tensor) -> torch.Tensor:
        z = self.y * (w @ self.x.T)
        return (self.y * torch.sigmoid(-z)) @ self.x - w


class CorrelatedGaussian:
    def __init__(self, dim: int, rho: float, dtype, device):
        s = 1.0 / (1.0 - rho * rho)
        main = np.full((dim,), s * (1 + rho * rho))
        main[0] = main[-1] = s
        self.dim = dim
        self.main = torch.tensor(main.astype(np.float32), device=device).to(dtype)
        self.off = torch.tensor(np.full((dim - 1,), -s * rho, np.float32),
                                device=device).to(dtype)

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        quad = (self.main * x * x).sum(-1) + 2.0 * (self.off * x[:, :-1] * x[:, 1:]).sum(-1)
        return -0.5 * quad

    def grad(self, x: torch.Tensor) -> torch.Tensor:
        g = self.main * x
        g[:, :-1] += self.off * x[:, 1:]
        g[:, 1:] += self.off * x[:, :-1]
        return -g


def make(cfg: dict, seed: int, dtype, device):
    """The target a configuration names (``cfg["target"]``)."""
    t = cfg["target"]
    if t == "logistic_regression":
        return LogisticRegression(cfg["num_data"], cfg["dim"], seed, dtype, device)
    if t == "correlated_gaussian":
        return CorrelatedGaussian(cfg["dim"], cfg["rho"], dtype, device)
    raise ValueError(f"the reference has no target {t!r}")
