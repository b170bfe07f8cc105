"""State carried between the JAX package and the port, through numpy.

The system has no model weights: its "weights" are the target's data
(rebuilt bit-identically from the same numpy seed by ``mcmc.targets``) and
the chains' initial state.  These helpers turn the JAX package's NUTS
arguments, taken as numpy, into the port's, and keys back again.  Keys are
``uint32`` word pairs in JAX and the same bits viewed as ``int32`` here.
"""
from __future__ import annotations

import numpy as np
import torch


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
