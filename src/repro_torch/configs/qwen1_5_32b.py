"""Qwen1.5-32B [hf:Qwen/Qwen1.5 family; hf] — dense, QKV bias, MHA."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        d_ff=27_392,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
