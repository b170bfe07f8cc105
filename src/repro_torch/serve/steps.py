"""The two serving primitives (a port of the JAX package's
``serve/steps.py``):

* ``make_prefill_step``  — full-sequence forward over the prompt batch
  (the ``prefill_*`` shapes);
* ``make_serve_step``    — one new token against a KV cache of
  ``seq_len`` (the ``decode_*`` shapes), including sampling.

Both run where the model's parameters live (the card unless the model was
made with ``device="cpu"``).  Sampling is greedy at ``temperature == 0``
and otherwise ``prng.categorical`` (``jax.random.categorical``) of the
logits over the temperature: the uniform draws are bit-exact with JAX's,
the Gumbel transform's ``log`` within an ulp of XLA's, so tokens differ
only where two noisy logits nearly tie.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..mcmc import prng
from ..models import shard_ctx
from ..models.transformer import Model


def make_prefill_step(model: Model) -> Callable:
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        # next-token distribution at the prompt boundary
        return logits[:, -1].float()

    return prefill_step


def sample_token(logits: torch.Tensor, key: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling with one key for the batch.
    logits: [B, V] f32 -> int32 [B].  Under a model's rules the vocabulary
    is gathered first (each rank keeps its batch rows)."""
    logits = shard_ctx.constrain(logits, ("batch", None))
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return prng.categorical(key, logits / temperature).to(torch.int32)


def make_serve_step(model: Model, temperature: float = 0.0) -> Callable:
    """decode: (params, cache, tokens [B], pos [B], key) ->
    (new_tokens [B], cache)."""

    def serve_step(params, cache, tokens, pos, key):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        with shard_ctx.use_rules(model.axis_rules):
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
