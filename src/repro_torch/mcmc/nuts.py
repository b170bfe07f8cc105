"""The No-U-Turn Sampler as an autobatchable program (paper Section 4), on
PyTorch.

The same CFG as the JAX package's ``repro.mcmc.nuts``, built with the
port's builder: ``build_tree`` calls itself, ``nuts_step`` runs the
doubling loop, ``nuts_chain`` runs ``num_steps`` trajectories with running
moments.  Each leaf of the tree takes ``steps_per_leaf`` leapfrog steps;
the leaf integrator is tagged ``"grad"`` so the VM reports gradient
evaluations (``steps_per_leaf + 1`` per leaf execution) and utilization.

Random draws come from :mod:`.prng`, a bit-exact port of ``jax.random``'s
threefry keys, carried through the VM as int32 bit patterns; so the two
packages take the same branches from the same keys.

Public entry point: :func:`make_nuts_kernel` — ``kernel(theta0, eps, key)``
with per-chain ``theta0`` ``[chains, dim]`` float32 and ``key``
``[chains, 2]`` int32, and a shared scalar step size ``eps``; it returns
``{"theta", "sum_theta", "sum_sq"}``, each ``[chains, dim]``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import batching, frontend, ir
from ..core.batching import Batched, Shared
from ..core.frontend import spec
from ..device import resolve_device
from . import prng
from .targets import Target

KEY = spec((2,), torch.int32)
F32 = spec((), torch.float32)
I32 = spec((), torch.int32)

DELTA_MAX = 1000.0  # divergence threshold (standard)


@dataclass(frozen=True)
class NutsSettings:
    max_tree_depth: int = 10
    num_steps: int = 10  # Markov-chain length (trajectories per chain)
    steps_per_leaf: int = 4  # leapfrog steps per tree leaf (paper: 4)

    @property
    def grads_per_leaf(self) -> int:
        return self.steps_per_leaf + 1


def make_primitives(target: Target, settings: NutsSettings):
    """Per-member PyTorch functions used as IR primitives (all vmappable)."""
    logp = target.logp
    grad = torch.func.grad(logp)
    spl = settings.steps_per_leaf

    def leapfrog(theta, r, v, eps):
        """``steps_per_leaf`` leapfrog steps with step size ``v * eps``."""
        step = v * eps
        g = grad(theta)
        for _ in range(spl):
            r_half = r + 0.5 * step * g
            theta = theta + step * r_half
            g = grad(theta)
            r = r_half + 0.5 * step * g
        return theta, r

    def joint(theta, r):
        return logp(theta) - 0.5 * torch.sum(r * r)

    def uturn_ok(tm, rm, tp, rp):
        """1 if the (tm..tp) trajectory has NOT made a U-turn."""
        d = tp - tm
        ok = torch.logical_and(torch.dot(d, rm) >= 0.0, torch.dot(d, rp) >= 0.0)
        return ok.to(torch.int32)

    def split3(key):
        ks = prng.split(key, 3)
        return ks[0], ks[1], ks[2]

    def split4(key):
        ks = prng.split(key, 4)
        return ks[0], ks[1], ks[2], ks[3]

    def momentum(key):
        return prng.normal(key, (target.dim,))

    def slice_log_u(key, joint0):
        # log of the slice variable u ~ Uniform(0, exp(joint0)).
        return joint0 + torch.log1p(-prng.uniform(key))

    def direction(key):
        one = torch.ones((), dtype=torch.float32, device=key.device)
        return torch.where(prng.bernoulli(key), one, -one)

    return dict(
        leapfrog=leapfrog,
        joint=joint,
        uturn_ok=uturn_ok,
        split3=split3,
        split4=split4,
        momentum=momentum,
        slice_log_u=slice_log_u,
        direction=direction,
    )


def build_nuts_program(
    target: Target, settings: NutsSettings = NutsSettings()
) -> ir.Program:
    """The full multi-trajectory NUTS chain as a Fig-2 IR program.

    Functions:
      * ``build_tree(theta, r, log_u, v, j, eps, key)`` — the recursive
        doubling procedure (Hoffman & Gelman Algorithm 3's BuildTree);
      * ``nuts_step(theta, eps, key)`` — one trajectory (one draw);
      * ``nuts_chain(theta0, eps, key)`` — ``num_steps`` draws, accumulating
        running first/second moments (main function).
    """
    p = make_primitives(target, settings)
    vec = spec((target.dim,), torch.float32)
    pb = frontend.ProgramBuilder(main="nuts_chain")

    # ------------------------------------------------------------------
    # build_tree — the recursive core
    # ------------------------------------------------------------------
    bt = pb.function(
        "build_tree",
        params=["theta", "r", "log_u", "v", "j", "eps", "key"],
        outputs=["tm", "rm", "tp", "rp", "th1", "n1", "s1", "key_out"],
        param_specs={
            "theta": vec, "r": vec, "log_u": F32, "v": F32,
            "j": I32, "eps": F32, "key": KEY,
        },
        output_specs={
            "tm": vec, "rm": vec, "tp": vec, "rp": vec,
            "th1": vec, "n1": I32, "s1": I32, "key_out": KEY,
        },
    )
    is_leaf = bt.prim(lambda j: j == 0, ["j"], name="is_leaf")
    with bt.if_(is_leaf):
        # Base case: one leaf = steps_per_leaf leapfrog steps (tag: grad).
        bt.prim(
            p["leapfrog"], ["theta", "r", "v", "eps"],
            out=("th_new", "r_new"), n_out=2, name="leapfrog", tag="grad",
        )
        bt.prim(p["joint"], ["th_new", "r_new"], out="jnt", name="joint")
        bt.assign(
            "n1",
            lambda lu, jt: (lu <= jt).to(torch.int32),
            ["log_u", "jnt"], name="slice_ind",
        )
        bt.assign(
            "s1",
            lambda lu, jt: (jt > lu - DELTA_MAX).to(torch.int32),
            ["log_u", "jnt"], name="not_divergent",
        )
        bt.copy("th_new", out="tm")
        bt.copy("r_new", out="rm")
        bt.copy("th_new", out="tp")
        bt.copy("r_new", out="rp")
        bt.copy("th_new", out="th1")
        bt.copy("key", out="key_out")
        bt.return_()
    # Recursive case: build left half, then (if still going) the right half.
    bt.assign("jm1", lambda j: j - 1, ["j"])
    bt.prim(p["split3"], ["key"], out=("k2", "k3", "key_out"), n_out=3,
            name="split3")
    bt.call(
        "build_tree",
        ["theta", "r", "log_u", "v", "jm1", "eps", "k2"],
        out=("tm", "rm", "tp", "rp", "th1", "n1", "s1", "kd0"), n_out=8,
    )
    going = bt.prim(lambda s: s == 1, ["s1"], name="still_going")
    with bt.if_(going):
        is_neg = bt.prim(lambda v: v < 0.0, ["v"], name="is_neg")
        with bt.if_(is_neg):
            bt.call(
                "build_tree",
                ["tm", "rm", "log_u", "v", "jm1", "eps", "k3"],
                out=("tm", "rm", "d0", "d1", "th2", "n2", "s2", "kd1"),
                n_out=8,
            )
        with bt.orelse():
            bt.call(
                "build_tree",
                ["tp", "rp", "log_u", "v", "jm1", "eps", "k3"],
                out=("d0", "d1", "tp", "rp", "th2", "n2", "s2", "kd1"),
                n_out=8,
            )
        # Accept the right-half proposal with prob n2 / (n1 + n2).
        bt.prim(
            lambda k, n1, n2: prng.uniform(k) * (n1 + n2) < n2,
            ["kd1", "n1", "n2"], out="acc", name="subtree_accept",
        )
        bt.assign(
            "th1",
            lambda a, t1, t2: torch.where(a, t2, t1),
            ["acc", "th1", "th2"], name="select_proposal",
        )
        bt.prim(p["uturn_ok"], ["tm", "rm", "tp", "rp"], out="ut",
                name="uturn_ok")
        bt.assign("s1", lambda s2, ut: s2 * ut, ["s2", "ut"])
        bt.assign("n1", lambda n1, n2: n1 + n2, ["n1", "n2"])
    bt.return_()
    pb.add(bt)

    # ------------------------------------------------------------------
    # nuts_step — one trajectory (the doubling loop)
    # ------------------------------------------------------------------
    st = pb.function(
        "nuts_step",
        params=["theta", "eps", "key"],
        outputs=["theta_out", "key_run"],
        param_specs={"theta": vec, "eps": F32, "key": KEY},
        output_specs={"theta_out": vec, "key_run": KEY},
    )
    st.prim(p["split3"], ["key"], out=("k_mom", "k_slice", "key_run"),
            n_out=3, name="split3")
    st.prim(p["momentum"], ["k_mom"], out="r0", name="momentum")
    st.prim(p["joint"], ["theta", "r0"], out="joint0", name="joint0")
    st.prim(p["slice_log_u"], ["k_slice", "joint0"], out="log_u",
            name="slice_log_u")
    st.copy("theta", out="tm")
    st.copy("r0", out="rm")
    st.copy("theta", out="tp")
    st.copy("r0", out="rp")
    st.copy("theta", out="theta_out")
    st.const(1, torch.int32, out="n")
    st.const(1, torch.int32, out="s")
    st.const(0, torch.int32, out="j")
    with st.while_(
        lambda s, j: torch.logical_and(s == 1, j < settings.max_tree_depth),
        ["s", "j"],
    ):
        st.prim(p["split4"], ["key_run"],
                out=("k_dir", "k_tree", "k_acc", "key_run"), n_out=4,
                name="split4")
        st.prim(p["direction"], ["k_dir"], out="v", name="direction")
        is_neg = st.prim(lambda v: v < 0.0, ["v"], name="is_neg")
        with st.if_(is_neg):
            st.call(
                "build_tree",
                ["tm", "rm", "log_u", "v", "j", "eps", "k_tree"],
                out=("tm", "rm", "d0", "d1", "th1", "n1", "s1", "kd"),
                n_out=8,
            )
        with st.orelse():
            st.call(
                "build_tree",
                ["tp", "rp", "log_u", "v", "j", "eps", "k_tree"],
                out=("d0", "d1", "tp", "rp", "th1", "n1", "s1", "kd"),
                n_out=8,
            )
        # Metropolis-within-slice: accept with prob min(1, n1/n).
        st.prim(
            lambda k, s1, n1, n: torch.logical_and(
                s1 == 1, prng.uniform(k) * n < n1
            ),
            ["k_acc", "s1", "n1", "n"], out="acc", name="trajectory_accept",
        )
        st.assign(
            "theta_out",
            lambda a, to, t1: torch.where(a, t1, to),
            ["acc", "theta_out", "th1"], name="select_sample",
        )
        st.prim(p["uturn_ok"], ["tm", "rm", "tp", "rp"], out="ut",
                name="uturn_ok")
        st.assign("s", lambda s1, ut: s1 * ut, ["s1", "ut"])
        st.assign("n", lambda n, n1: n + n1, ["n", "n1"])
        st.assign("j", lambda j: j + 1, ["j"])
    st.return_()
    pb.add(st)

    # ------------------------------------------------------------------
    # nuts_chain — num_steps trajectories with running moments (main)
    # ------------------------------------------------------------------
    ch = pb.function(
        "nuts_chain",
        params=["theta0", "eps", "key"],
        outputs=["theta", "sum_theta", "sum_sq"],
        param_specs={"theta0": vec, "eps": F32, "key": KEY},
        output_specs={"theta": vec, "sum_theta": vec, "sum_sq": vec},
    )
    ch.copy("theta0", out="theta")
    ch.copy("key", out="key_run")
    ch.const(np.zeros(target.dim, np.float32), out="sum_theta")
    ch.const(np.zeros(target.dim, np.float32), out="sum_sq")
    ch.const(0, torch.int32, out="it")
    with ch.while_(lambda it: it < settings.num_steps, ["it"]):
        ch.call("nuts_step", ["theta", "eps", "key_run"],
                out=("theta", "key_run"), n_out=2)
        ch.assign("sum_theta", lambda s, t: s + t, ["sum_theta", "theta"])
        ch.assign("sum_sq", lambda s, t: s + t * t, ["sum_sq", "theta"])
        ch.assign("it", lambda i: i + 1, ["it"])
    ch.return_()
    pb.add(ch)

    return pb.build()


def make_nuts_kernel(
    target: Target,
    settings: NutsSettings = NutsSettings(),
    *,
    backend: str = "pc",
    max_steps: int = 1_000_000,
    schedule: str = "earliest",
    fuse: bool = True,
    compact_every: Optional[int] = None,
    verify: bool = False,
    pgo=None,
    device=None,
) -> batching.AutobatchedFunction:
    """The public NUTS entry point: ``kernel(theta0, eps, key) -> state``.

    * ``theta0`` is per-chain (``Batched``): ``[chains, dim]`` float32,
    * ``eps`` is the step size shared by every chain (``Shared``): a scalar,
    * ``key`` is per-chain (``Batched``): ``[chains, 2]`` int32 key words,

    and ``state`` is ``{"theta", "sum_theta", "sum_sq"}``, each
    ``[chains, dim]``: final positions and running moments.  ``backend``
    is one of ``batching.BACKENDS``; ``schedule``, ``fuse`` and
    ``compact_every`` are the pc backend's knobs, all bit-exact, so every
    combination samples identical chains.  ``verify=True`` runs the
    lowered-IR verifier between every pass; ``pgo=`` re-lowers through the
    profile-guided passes from a :class:`repro_torch.obs.BlockProfile` (or
    a saved profile's path) of a traced run of the same kernel — still
    bit-exact, with fewer dispatches.  On the card the pc backend's
    stack traffic always goes through K1/K2.  It runs on ``device``
    (default: the CUDA card; no CUDA and no device raises), which must be
    where the target's data lives.
    """
    device = resolve_device(device)
    program = build_nuts_program(target, settings)
    vec = spec((target.dim,), torch.float32)
    return batching.autobatch(
        program,
        in_specs=(Batched(vec), Shared(F32), Batched(KEY)),
        out_spec={"theta": "theta", "sum_theta": "sum_theta", "sum_sq": "sum_sq"},
        backend=backend,
        max_depth=recommended_max_depth(settings),
        max_steps=max_steps,
        schedule=schedule,
        fuse=fuse,
        compact_every=compact_every,
        verify=verify,
        pgo=pgo,
        device=device,
    )


def initial_state(
    target: Target, batch_size: int, *, eps: float, seed: int = 0, device=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Positional ``(theta0, eps, key)`` arguments for the NUTS kernel: the
    same values as the JAX package's ``initial_state`` with these arguments
    (keys as int32 words)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta0 = 0.1 * rng.normal(size=(batch_size, target.dim)).astype(np.float32)
    keys = torch.stack([
        prng.prng_key(s) for s in range(seed * 100_000, seed * 100_000 + batch_size)
    ])
    return (
        torch.tensor(theta0, device=device),
        torch.tensor(eps, dtype=torch.float32, device=device),
        keys.to(device),
    )


def recommended_max_depth(settings: NutsSettings) -> int:
    """Stack slots needed: chain -> step -> tree_depth nested build_trees,
    plus one slot for the exit sentinel and one of headroom."""
    return settings.max_tree_depth + 4
