"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE:
2 shared + 64 routed top-6 experts; first layer dense."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,  # routed-expert hidden size (fine-grained)
        vocab_size=102_400,
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        moe_d_ff=1408,
        dense_d_ff=10_944,  # layer-0 dense FFN
        first_dense_layers=1,
        moe_renorm_topk=False,  # deepseek scales by raw softmax probs
        rope_theta=10_000.0,
    )
