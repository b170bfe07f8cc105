"""Qwen3-14B [hf:Qwen/Qwen3-8B family; hf] — dense, qk_norm, GQA kv=8."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=17_408,
        vocab_size=151_936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
