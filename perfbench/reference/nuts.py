"""Plain NUTS (Hoffman and Gelman's Algorithm 3, multinomial-free slice
version, as the paper's Section 4 runs it) over a batch of chains, written
with masks: every chain of the batch walks the same recursion and a mask
keeps each update to the chains it belongs to.

It follows the program's algorithm draw for draw: each trajectory splits
its key into (momentum, slice, rest); each doubling splits the rest into
(direction, tree, accept, rest); each inner tree node splits its key into
(left, right, out) and accepts the right half with the right half's
returned key.  A leaf takes ``steps_per_leaf`` leapfrog steps.  The random
draws come from :mod:`.prng` on the host and stay float32, as the
algorithm defines them; the dynamics (positions, momenta, log densities,
U-turn products) run in ``dtype`` on the target's device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

DELTA_MAX = 1000.0


class Nuts:
    def __init__(self, target, *, max_tree_depth: int, num_steps: int, steps_per_leaf: int,
                 dtype=torch.float64, device="cpu"):
        self.t = target
        self.max_tree_depth = max_tree_depth
        self.num_steps = num_steps
        self.spl = steps_per_leaf
        self.dtype = dtype
        self.device = torch.device(device)

    # -- helpers ---------------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @staticmethod
    def _sel(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.view(mask.shape + (1,) * (new.dim() - 1)), new, old)

    def _joint(self, theta, r):
        return self.t.logp(theta) - 0.5 * (r * r).sum(-1)

    def _leapfrog(self, theta, r, v, eps):
        step = (v * eps).unsqueeze(-1)
        g = self.t.grad(theta)
        for _ in range(self.spl):
            r_half = r + 0.5 * step * g
            theta = theta + step * r_half
            g = self.t.grad(theta)
            r = r_half + 0.5 * step * g
        return theta, r

    @staticmethod
    def _uturn_ok(tm, rm, tp, rp):
        d = tp - tm
        return (((d * rm).sum(-1) >= 0) & ((d * rp).sum(-1) >= 0)).to(torch.int32)

    def _accept(self, keys: np.ndarray, n_total: torch.Tensor, n_new: torch.Tensor):
        """``uniform * n_total < n_new`` in float32, as the program draws it."""
        u = self._dev(prng.uniform(keys))
        return u * n_total.to(torch.float32) < n_new.to(torch.float32)

    # -- the algorithm ---------------------------------------------------
    def build_tree(self, theta, r, log_u, v, j, eps, keys, act):
        """Returns ``(tm, rm, tp, rp, th1, n1, s1, key_out)``; rows outside
        ``act`` hold junk that the caller masks out."""
        if j == 0:
            th, rr = self._leapfrog(theta, r, v, eps)
            jnt = self._joint(th, rr)
            n1 = (log_u <= jnt).to(torch.int32)
            s1 = (jnt > log_u - DELTA_MAX).to(torch.int32)
            return th, rr, th, rr, th, n1, s1, keys
        ks = prng.split(keys, 3)
        tm, rm, tp, rp, th1, n1, s1, _ = self.build_tree(theta, r, log_u, v, j - 1, eps,
                                                         ks[:, 0], act)
        going = act & (s1 == 1)
        if bool(going.any()):
            neg = v < 0
            st, sr = self._sel(neg, tm, tp), self._sel(neg, rm, rp)
            btm, brm, btp, brp, th2, n2, s2, kd1 = self.build_tree(
                st, sr, log_u, v, j - 1, eps, ks[:, 1], going)
            left, right = going & neg, going & ~neg
            tm, rm = self._sel(left, btm, tm), self._sel(left, brm, rm)
            tp, rp = self._sel(right, btp, tp), self._sel(right, brp, rp)
            acc = self._accept(kd1, n1 + n2, n2)
            th1 = self._sel(going & acc, th2, th1)
            ut = self._uturn_ok(tm, rm, tp, rp)
            s1 = torch.where(going, s2 * ut, s1)
            n1 = torch.where(going, n1 + n2, n1)
        return tm, rm, tp, rp, th1, n1, s1, ks[:, 2]

    def step(self, theta, eps, keys):
        """One trajectory from ``theta`` for every chain; returns the new
        positions and the keys to carry."""
        z = theta.shape[0]
        ks = prng.split(keys, 3)
        r0 = self._dev(prng.normal(ks[:, 0], self.t.dim)).to(self.dtype)
        joint0 = self._joint(theta, r0)
        log_u = joint0 + torch.log1p(-self._dev(prng.uniform(ks[:, 1])).to(self.dtype))
        key_run = ks[:, 2]
        tm = tp = theta_out = theta
        rm = rp = r0
        n = torch.ones(z, dtype=torch.int32, device=self.device)
        s = torch.ones_like(n)
        for j in range(self.max_tree_depth):
            go = s == 1
            go_np = go.cpu().numpy()
            if not go_np.any():
                break
            k4 = prng.split(key_run, 4)
            key_run = np.where(go_np[:, None], k4[:, 3], key_run)
            v = torch.where(self._dev(prng.uniform(k4[:, 0])) < 0.5, 1.0, -1.0).to(self.dtype)
            neg = v < 0
            st, sr = self._sel(neg, tm, tp), self._sel(neg, rm, rp)
            btm, brm, btp, brp, th1, n1, s1, _ = self.build_tree(
                st, sr, log_u, v, j, eps, k4[:, 1], go)
            left, right = go & neg, go & ~neg
            tm, rm = self._sel(left, btm, tm), self._sel(left, brm, rm)
            tp, rp = self._sel(right, btp, tp), self._sel(right, brp, rp)
            acc = (s1 == 1) & self._accept(k4[:, 2], n, n1)
            theta_out = self._sel(go & acc, th1, theta_out)
            ut = self._uturn_ok(tm, rm, tp, rp)
            s = torch.where(go, s1 * ut, s)
            n = torch.where(go, n + n1, n)
        return theta_out, key_run

    def chain(self, theta0: torch.Tensor, eps: float, keys) -> dict:
        """``num_steps`` trajectories from ``theta0`` ``[chains, dim]`` with
        key words ``keys`` ``[chains, 2]``; returns ``theta``, ``sum_theta``
        and ``sum_sq`` as the program's kernel does."""
        theta = theta0.to(device=self.device, dtype=self.dtype)
        eps_t = torch.tensor(np.float32(eps), dtype=torch.float32).to(self.dtype)
        key_run = prng.as_keys(keys)
        sum_theta = torch.zeros_like(theta)
        sum_sq = torch.zeros_like(theta)
        for _ in range(self.num_steps):
            theta, key_run = self.step(theta, eps_t.to(self.device), key_run)
            sum_theta = sum_theta + theta
            sum_sq = sum_sq + theta * theta
        return {"theta": theta, "sum_theta": sum_theta, "sum_sq": sum_sq}
