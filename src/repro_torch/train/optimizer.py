"""AdamW with a cosine schedule, global-norm clipping and optional int8
gradient compression with error feedback (a port of the JAX package's
``train/optimizer.py``).

Functional, as the reference is: every function returns new tensors and
leaves its inputs as they were, so a caller may keep an earlier state (the
restart loop keeps its initial one, an async checkpoint its source).  The
state is a plain tree (``step``, ``mu``, ``nu`` and, with compression,
``error``) that checkpoints like the parameters.  ``step`` is an int32
tensor and the schedule is computed from it in float32 on its device, so a
step reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from ..core.tree import tree_flatten, tree_map, tree_unflatten

PyTree = Any


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # int8 gradient compression with error feedback (the cross-pod
    # all-reduce of the reference; here it runs on one device).
    compress_grads: bool = False


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``min_lr_frac * peak_lr`` at ``total_steps``; float32 on step's device."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: PyTree, cfg: OptimizerConfig) -> PyTree:
    """Zero moments (float32, one per parameter) and ``step`` 0 (int32)."""
    leaves = tree_flatten(params)[0]
    device = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
    }
    if cfg.compress_grads:
        state["error"] = tree_map(zeros, params)
    return state


def global_norm(tree: PyTree) -> torch.Tensor:
    """The float32 2-norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_flatten(tree)[0]))


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: PyTree, error: PyTree) -> tuple[PyTree, PyTree]:
    """Quantize ``grad + carried error``; the residual becomes the new
    error, so the sum of the restored gradients over steps stays unbiased.
    Returns (restored grads, new error)."""
    g_leaves, treedef = tree_flatten(grads)
    e_leaves = tree_flatten(error)[0]
    restored, new_err = [], []
    for g, e in zip(g_leaves, e_leaves):
        target = g.to(torch.float32) + e
        r = decompress_int8(*compress_int8(target))
        restored.append(r)
        new_err.append(target - r)
    return tree_unflatten(treedef, restored), tree_unflatten(treedef, new_err)


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------


def apply_updates(params: PyTree, grads: PyTree, state: PyTree, cfg: OptimizerConfig
                  ) -> tuple[PyTree, PyTree, dict]:
    """One AdamW step: clip to ``clip_norm``, bias-corrected moments,
    decoupled weight decay on leaves of two or more dimensions, each new
    parameter cast back to its leaf's dtype.  Returns (new params, new
    state, metrics); the inputs are not written."""
    metrics: dict = {}
    if cfg.compress_grads:
        grads, new_error = compress_with_feedback(grads, state["error"])
        metrics["compress_error_norm"] = global_norm(new_error)
    gnorm = global_norm(grads)
    metrics["grad_norm"] = gnorm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    metrics["lr"] = lr
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    p_leaves, treedef = tree_flatten(params)
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(p_leaves, tree_flatten(grads)[0], tree_flatten(state["mu"])[0],
                            tree_flatten(state["nu"])[0]):
        g = g.to(torch.float32) * scale
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    new_state = {"step": step, "mu": tree_unflatten(treedef, new_mu),
                 "nu": tree_unflatten(treedef, new_nu)}
    if cfg.compress_grads:
        new_state["error"] = new_error
    return tree_unflatten(treedef, new_p), new_state, metrics
