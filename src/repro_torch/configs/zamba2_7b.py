"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 backbone + shared
attention blocks (single weight copy applied periodically)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        d_ff=14_336,  # shared block FFN
        vocab_size=32_000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=128,
        shared_attn_every=6,  # shared attn+FFN block applied every 6 layers
        long_context_window=4096,  # sliding-window KV in long-context serve
    )
