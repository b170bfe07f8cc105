"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf] —
128 routed experts, top-8, no shared expert, qk_norm, GQA kv=4."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=94,
        d_model=4096,
        num_heads=64,
        num_kv_heads=4,
        d_ff=1536,  # routed-expert hidden size
        vocab_size=151_936,
        head_dim=128,
        qk_norm=True,
        num_experts=128,
        num_shared_experts=0,
        top_k=8,
        moe_d_ff=1536,
        moe_renorm_topk=True,
        rope_theta=1_000_000.0,
    )
