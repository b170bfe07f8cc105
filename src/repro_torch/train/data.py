"""Deterministic, resumable synthetic data (a port of the JAX package's
``train/data.py``), bit-exact with it for every step.

A batch is a pure function of ``(seed, step)`` through threefry
``fold_in`` and ``split``, so a restart at step k sees the batches an
uninterrupted run saw (resume is replay), and the two packages train on
the same tokens.  Token streams follow a fixed affine Markov chain
``t' = (mult * t + 17 + eps) % vocab`` with small noise ``eps``, so a
model's loss falls within a few hundred steps.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ShapeSpec
from ..mcmc import prng
from ..models.transformer import Model, arange_positions


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Markov-chain structure: t_{i+1} = (mult * t_i + 17 + eps) % vocab
    mult: int = 6_364_136_223_846_793_005 % 65_521
    noise_levels: int = 4


def _wrap_i32(x: np.ndarray) -> np.ndarray:
    """int64 values -> the int32 values two's-complement arithmetic leaves."""
    return (x + 2**31) % 2**32 - 2**31


class SyntheticStream:
    """Deterministic batch source for a (model, shape) pair; batches land
    on the model's device."""

    def __init__(self, model: Model, shape: ShapeSpec, cfg: DataConfig = DataConfig()):
        self.model = model
        self.shape = shape
        self.cfg = cfg
        self._base_key = prng.prng_key(cfg.seed)

    def _markov_tokens(self, key: torch.Tensor, b: int, s: int, vocab: int) -> np.ndarray:
        k0, k1 = prng.split(key)
        t = prng.randint(k0, (b,), 0, vocab).numpy().astype(np.int64)
        noise = prng.randint(k1, (b, s), 0, self.cfg.noise_levels).numpy().astype(np.int64)
        toks = np.empty((b, s), np.int32)
        for i in range(s):  # lax.scan over the sequence in the reference
            # int32 arithmetic wraps (vocab * mult can pass 2**31), then the
            # floor modulo of jnp's %.
            t = _wrap_i32(t * self.cfg.mult + 17 + noise[:, i]) % vocab
            toks[:, i] = t
        return toks

    def batch(self, step: int) -> dict:
        """The batch for global step ``step`` (pure; resume == replay)."""
        key = prng.fold_in(self._base_key, step)
        out = {}
        for name, spec in self.model.input_specs(self.shape).items():
            key, k = prng.split(key)
            shape = tuple(spec.shape)
            if name in ("tokens", "labels"):
                b, s = shape if len(shape) == 2 else (shape[0], 1)
                x = torch.from_numpy(self._markov_tokens(k, b, s, self.model.cfg.vocab_size)
                                     .reshape(shape))
            elif name == "positions":
                x = arange_positions(shape)
            elif spec.is_floating_point():
                x = prng.normal(k, shape, spec.dtype)
            else:  # pos and any other integer input
                x = torch.zeros(shape, dtype=spec.dtype)
            out[name] = x.to(self.model.device)
        return out
