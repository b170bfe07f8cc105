"""Qwen2-VL-2B [arXiv:2409.12191; hf] — decoder backbone with M-RoPE.

Backbone only: the vision tower is a STUB (``input_specs()`` provides
precomputed patch embeddings and 3-axis M-RoPE position ids)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),  # (t, h, w) in half-head-dim units
        tie_embeddings=True,
    )
