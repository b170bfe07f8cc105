"""The two serving primitives (a port of the JAX package's
``serve/steps.py``):

* ``make_prefill_step``  — full-sequence forward over the prompt batch
  (the ``prefill_*`` shapes);
* ``make_serve_step``    — one new token against a KV cache of
  ``seq_len`` (the ``decode_*`` shapes), including sampling.

Both run where the model's parameters live (the card unless the model was
made with ``device="cpu"``).  Sampling is greedy only: ``temperature > 0``
needs ``jax.random.categorical`` ported bit for bit on top of
``mcmc/prng.py`` first.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models.transformer import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        # next-token distribution at the prompt boundary
        return logits[:, -1].float()

    return prefill_step


def check_greedy(temperature: float) -> None:
    """Raise unless ``temperature`` is 0 (the only sampling ported)."""
    if temperature != 0.0:
        raise NotImplementedError(
            f"temperature={temperature}: temperature sampling is not ported "
            "yet; it needs jax.random.categorical bit for bit on top of "
            "mcmc/prng.py"
        )


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (T=0) sampling. logits: [B, V] f32 -> int32 [B]."""
    check_greedy(temperature)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_serve_step(model: Model, temperature: float = 0.0) -> Callable:
    """decode: (params, cache, tokens [B], pos [B], key) ->
    (new_tokens [B], cache)."""
    check_greedy(temperature)

    def serve_step(params, cache, tokens, pos, key):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        return sample_token(logits, key, temperature), cache

    return serve_step


LONG_CONTEXT_THRESHOLD = 131_072


def decode_cache_window(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Cache window for a decode shape: sub-quadratic archs switch their
    attention to a sliding window at >= 128k tokens; ordinary decode shapes
    keep the full context."""
    if cfg.subquadratic and shape.seq_len >= LONG_CONTEXT_THRESHOLD:
        return cfg.long_context_window
    return shape.seq_len
