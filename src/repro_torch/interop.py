"""State carried between the JAX package and the port, through numpy.

NUTS has no model weights: its "weights" are the target's data (rebuilt
bit-identically from the same numpy seed by ``mcmc.targets``) and the
chains' initial state.  These helpers turn the JAX package's NUTS
arguments, taken as numpy, into the port's, and keys back again.  Keys are
``uint32`` word pairs in JAX and the same bits viewed as ``int32`` here.
The LM's weights cross with :func:`lm_params_from_numpy`, AdamW's state
with :func:`opt_state_from_numpy`, and either comes back with
:func:`to_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.utils._pytree as pytree


def keys_from_numpy(keys, device) -> torch.Tensor:
    """``[..., 2]`` uint32 keys -> int32 key words on ``device`` (same bits)."""
    arr = np.ascontiguousarray(np.asarray(keys))
    if arr.dtype != np.uint32:
        raise TypeError(f"keys must be uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def keys_to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int32 key words -> the ``uint32`` keys JAX uses (same bits)."""
    if keys.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {keys.dtype}")
    return keys.cpu().numpy().view(np.uint32)


def nuts_inputs_from_numpy(theta0, eps, keys, device):
    """The JAX package's ``nuts.initial_state`` output (as numpy) -> the
    positional ``(theta0, eps, key)`` arguments of the port's NUTS kernel."""
    return (
        torch.tensor(np.asarray(theta0, np.float32), device=device),
        torch.tensor(np.float32(eps), device=device),
        keys_from_numpy(keys, device),
    )


def _params_like(cfg) -> dict:
    """The port's parameter tree for ``cfg`` on the ``meta`` device."""
    from .models.transformer import Model

    return Model(cfg, device="meta").init(torch.Generator())


def _tree_from_numpy(tree_np, want, device):
    """``tree_np`` (numpy leaves) as tensors on ``device``, after checking
    that its paths, shapes and dtypes are those of ``want``."""
    got = pytree.tree_map(lambda a: torch.from_numpy(np.array(a)), tree_np)
    want_paths = {pytree.keystr(p): t for p, t in pytree.tree_flatten_with_path(want)[0]}
    got_paths = {pytree.keystr(p): t for p, t in pytree.tree_flatten_with_path(got)[0]}
    if want_paths.keys() != got_paths.keys():
        raise ValueError(
            f"trees differ: missing {sorted(want_paths.keys() - got_paths.keys())}, "
            f"unexpected {sorted(got_paths.keys() - want_paths.keys())}"
        )
    for name, w in want_paths.items():
        g = got_paths[name]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise ValueError(
                f"leaf {name}: got {g.dtype} {tuple(g.shape)}, the port "
                f"expects {w.dtype} {tuple(w.shape)}"
            )
    return pytree.tree_map(lambda t: t.to(device), got)


def lm_params_from_numpy(params_np, cfg, device) -> dict:
    """The JAX package's LM parameter pytree as numpy
    (``jax.tree.map(np.asarray, Model(cfg).init(key))``, layers stacked on
    a leading ``[L]`` axis) -> the port's params dict for ``cfg`` on
    ``device``.  The tree structure, shapes and dtypes must be the ones the
    port's ``Model.init`` makes; anything else raises."""
    return _tree_from_numpy(params_np, _params_like(cfg), device)


def opt_state_from_numpy(state_np, cfg, device) -> dict:
    """The JAX package's AdamW state for ``cfg``'s parameters as numpy
    (``step`` int32, ``mu`` and ``nu`` float32 trees of the parameters'
    shapes, ``error`` too with gradient compression) -> the port's, on
    ``device``; anything else raises."""
    params = _params_like(cfg)
    f32 = pytree.tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                          params)
    want = {"step": torch.empty((), dtype=torch.int32, device="meta"), "mu": f32, "nu": f32}
    if "error" in state_np:
        want["error"] = f32
    return _tree_from_numpy(state_np, want, device)


def to_numpy(tree):
    """Every tensor leaf of ``tree`` (params or optimizer state) as a host
    numpy array, for the JAX package's side of a parity test."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), tree)
