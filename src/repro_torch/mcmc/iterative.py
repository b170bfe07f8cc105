"""Hand-batched *iterative* NUTS on PyTorch (the expert-effort baseline).

The counterpart of the JAX package's ``repro.mcmc.iterative``: recursion
is replaced by the checkpoint-stack trick (a depth-``j`` subtree is built
as ``2**j`` consecutive leaves, with the U-turn checks of every completed
sub-subtree reconstructed from O(max_depth) stored left-edge checkpoints,
using the binary structure of the leaf index), and the chains run as one
batch.

JAX batches it with ``jax.vmap`` of its ``lax.while_loop``s.
``torch.func.vmap`` cannot map a data-dependent loop, so here it is
batched by hand: every tensor carries a leading chain axis, and each loop
is a host loop of masked updates that runs while any chain's condition
holds (one host read an iteration).  A chain whose condition is false
keeps its whole state, its key included — exactly ``vmap``'s semantics —
so each chain computes what the single-chain JAX function computes.

Draws use :mod:`.prng` (threefry keys as int32 words, bit-exact with
``jax.random`` for ``split``/``uniform``/``bernoulli``; ``normal`` within
a few ulp).  ``lax.population_count`` has no torch op: :func:`popcount`
is a bit trick on int64.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import prng
from .nuts import DELTA_MAX, NutsSettings
from .targets import Target

_I32 = torch.int32


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of the 32-bit pattern of each element (int32), as
    ``lax.population_count`` of an int32 array."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(_I32)


def _trailing_ones(i: torch.Tensor) -> torch.Tensor:
    # popcount(i ^ (i+1)) == trailing_ones(i) + 1
    return popcount(i ^ (i + 1)) - 1


def _col(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A ``[Z]`` tensor broadcast against a ``[Z, ...]`` one."""
    return x.view(x.shape + (1,) * (like.dim() - 1))


def _select(cond: torch.Tensor, new: dict, old: dict) -> dict:
    """Per chain: ``new`` where ``cond``, else ``old`` (vmap's while)."""
    return {k: torch.where(_col(cond, v), v, old[k]) for k, v in new.items()}


class IterativeNuts:
    """``chain(theta0, eps, key) -> (theta, sum_theta, sum_sq, grads)``
    over a batch of chains: ``theta0`` ``[Z, dim]`` float32, ``eps`` a
    shared scalar, ``key`` ``[Z, 2]`` int32 key words; ``grads`` is each
    chain's int32 count of gradient evaluations.  ``iterations`` counts
    the batched leaf steps of the last call (each a leapfrog over all
    chains)."""

    def __init__(self, target: Target, settings: NutsSettings):
        logp = target.logp
        self.dim = target.dim
        self.settings = settings
        self._logp = torch.func.vmap(logp)
        self._grad = torch.func.vmap(torch.func.grad(logp))
        self._split2 = torch.func.vmap(lambda k: prng.split(k, 2))
        self._split3 = torch.func.vmap(lambda k: prng.split(k, 3))
        self._split4 = torch.func.vmap(lambda k: prng.split(k, 4))
        self._uniform = torch.func.vmap(prng.uniform)
        self._bernoulli = torch.func.vmap(prng.bernoulli)
        self._normal = torch.func.vmap(lambda k: prng.normal(k, (target.dim,)))
        self.iterations = 0

    # ------------------------------------------------------------------

    def _leapfrog(self, theta, r, step):
        step = _col(step, theta)
        g = self._grad(theta)
        for _ in range(self.settings.steps_per_leaf):
            r_half = r + 0.5 * step * g
            theta = theta + step * r_half
            g = self._grad(theta)
            r = r_half + 0.5 * step * g
        return theta, r

    def _joint(self, theta, r):
        return self._logp(theta) - 0.5 * torch.sum(r * r, dim=-1)

    @staticmethod
    def _uturn_ok(tm, rm, tp, rp):
        d = tp - tm
        return torch.logical_and((d * rm).sum(-1) >= 0.0, (d * rp).sum(-1) >= 0.0)

    def _build_subtree(self, theta, r, log_u, v, depth, eps, key, active):
        """The depth-``depth`` subtree from the edge ``(theta, r)``, for the
        ``active`` chains (the others keep the initial state)."""
        z, dim = theta.shape
        max_depth = self.settings.max_tree_depth
        spl = self.settings.steps_per_leaf
        dev = theta.device
        num_leaves = torch.ones_like(depth) << depth
        ks = torch.arange(max_depth, device=dev)
        st = dict(
            i=torch.zeros(z, dtype=_I32, device=dev),
            theta=theta, r=r,
            ckpt_theta=torch.zeros((z, max_depth, dim), device=dev),
            ckpt_r=torch.zeros((z, max_depth, dim), device=dev),
            prop=theta,
            cnt=torch.zeros(z, dtype=_I32, device=dev),
            n=torch.zeros(z, dtype=_I32, device=dev),
            s=torch.ones(z, dtype=_I32, device=dev),
            grads=torch.zeros(z, dtype=_I32, device=dev),
            key=key,
        )
        step = v * eps
        while True:
            cond = active & (st["i"] < num_leaves) & (st["s"] == 1)
            if not bool(cond.any()):
                return st
            self.iterations += 1
            th, rr = self._leapfrog(st["theta"], st["r"], step)
            jnt = self._joint(th, rr)
            passes = log_u <= jnt
            not_div = jnt > log_u - DELTA_MAX
            # Reservoir-sample uniformly among slice-passing leaves.
            cnt = st["cnt"] + passes.to(_I32)
            keys = self._split2(st["key"])
            k_res = keys[:, 1]
            take = torch.logical_and(passes, self._uniform(k_res) * cnt < 1.0)
            prop = torch.where(_col(take, th), th, st["prop"])
            # Checkpoint-stack U-turn checks (binary leaf-index structure).
            i = st["i"]
            even = (i % 2) == 0
            idx_max = popcount(i >> 1)
            idx_min = idx_max - _trailing_ones(i) + 1
            row = torch.where(even, idx_max, max_depth)  # no row when odd
            at_row = (ks == row.unsqueeze(1)).unsqueeze(2)
            ckpt_theta = torch.where(at_row, th.unsqueeze(1), st["ckpt_theta"])
            ckpt_r = torch.where(at_row, rr.unsqueeze(1), st["ckpt_r"])
            in_range = (ks >= idx_min.unsqueeze(1)) & (ks <= idx_max.unsqueeze(1))
            # d points from the minus-most to the plus-most edge.
            d = v.view(z, 1, 1) * (th.unsqueeze(1) - st["ckpt_theta"])
            turn_k = torch.logical_or(
                torch.einsum("zkd,zkd->zk", d, st["ckpt_r"]) < 0.0,
                torch.einsum("zkd,zd->zk", d, rr) < 0.0,
            )
            turned = torch.logical_and(~even, (in_range & turn_k).any(dim=1))
            s = st["s"] * not_div.to(_I32) * (1 - turned.to(_I32))
            new = dict(
                i=i + 1, theta=th, r=rr, ckpt_theta=ckpt_theta, ckpt_r=ckpt_r,
                prop=prop, cnt=cnt, n=st["n"] + passes.to(_I32), s=s,
                grads=st["grads"] + (spl + 1), key=keys[:, 0],
            )
            st = _select(cond, new, st)

    def _nuts_step(self, theta, eps, key):
        """One trajectory of every chain: ``(theta, key, grads)``."""
        keys = self._split3(key)
        k_mom, k_slice, key = keys[:, 0], keys[:, 1], keys[:, 2]
        r0 = self._normal(k_mom)
        log_u = self._joint(theta, r0) + torch.log1p(-self._uniform(k_slice))
        z = theta.shape[0]
        one = torch.ones(z, dtype=_I32, device=theta.device)
        st = dict(tm=theta, rm=r0, tp=theta, rp=r0, theta_out=theta, n=one, s=one,
                  j=torch.zeros_like(one), grads=torch.zeros_like(one), key=key)
        while True:
            cond = (st["s"] == 1) & (st["j"] < self.settings.max_tree_depth)
            if not bool(cond.any()):
                return st["theta_out"], st["key"], st["grads"]
            keys = self._split4(st["key"])
            k_dir, k_tree, k_acc = keys[:, 0], keys[:, 1], keys[:, 2]
            v = torch.where(self._bernoulli(k_dir), 1.0, -1.0).to(torch.float32)
            neg = _col(v < 0.0, theta)
            sub = self._build_subtree(
                torch.where(neg, st["tm"], st["tp"]), torch.where(neg, st["rm"], st["rp"]),
                log_u, v, st["j"], eps, k_tree, cond,
            )
            tm = torch.where(neg, sub["theta"], st["tm"])
            rm = torch.where(neg, sub["r"], st["rm"])
            tp = torch.where(neg, st["tp"], sub["theta"])
            rp = torch.where(neg, st["rp"], sub["r"])
            acc = torch.logical_and(sub["s"] == 1, self._uniform(k_acc) * st["n"] < sub["n"])
            new = dict(
                tm=tm, rm=rm, tp=tp, rp=rp,
                theta_out=torch.where(_col(acc, theta), sub["prop"], st["theta_out"]),
                n=st["n"] + sub["n"],
                s=sub["s"] * self._uturn_ok(tm, rm, tp, rp).to(_I32),
                j=st["j"] + 1, grads=st["grads"] + sub["grads"], key=keys[:, 3],
            )
            st = _select(cond, new, st)

    def __call__(self, theta0, eps, key):
        self.iterations = 0
        theta = theta0
        s1 = torch.zeros_like(theta0)
        s2 = torch.zeros_like(theta0)
        grads = torch.zeros(theta0.shape[0], dtype=_I32, device=theta0.device)
        for _ in range(self.settings.num_steps):
            theta, key, g = self._nuts_step(theta, eps, key)
            s1 = s1 + theta
            s2 = s2 + theta * theta
            grads = grads + g
        return theta, s1, s2, grads


def make_chain_fn(target: Target, settings: NutsSettings) -> IterativeNuts:
    """The hand-batched chain function (see :class:`IterativeNuts`)."""
    return IterativeNuts(target, settings)


def make_batched(target: Target, settings: NutsSettings, *, device=None):
    """The multi-chain iterative NUTS runner (build once), with the
    autobatched kernel's calling convention: ``theta0`` and ``keys`` carry
    the chain axis, ``eps`` is a shared scalar.  It returns ``{"theta",
    "sum_theta", "sum_sq", "grads"}`` and runs on ``device`` (default: the
    card), where the target's data must live."""
    device = resolve_device(device)
    chain = make_chain_fn(target, settings)

    def batched(theta0, eps, keys):
        theta, s1, s2, grads = chain(
            torch.as_tensor(theta0, dtype=torch.float32, device=device),
            torch.as_tensor(eps, dtype=torch.float32, device=device),
            torch.as_tensor(keys, dtype=_I32, device=device),
        )
        return {"theta": theta, "sum_theta": s1, "sum_sq": s2, "grads": grads}

    batched.chain = chain
    return batched


def run_batched(target: Target, settings: NutsSettings, theta0, eps, keys, *, device=None):
    """One-shot convenience wrapper of :func:`make_batched`."""
    return make_batched(target, settings, device=device)(theta0, eps, keys)
