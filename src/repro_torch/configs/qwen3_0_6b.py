"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family; hf] — dense, qk_norm, GQA."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=3072,
        vocab_size=151_936,
        head_dim=128,  # qwen3 uses explicit head_dim=128
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
