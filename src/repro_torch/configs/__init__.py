"""Registry of the architectures the port runs, and the workload shapes.

The configurations of the families the port runs: the dense decoders
(SmolLM-135M, the serving model; Qwen3-0.6B and Qwen3-14B with
``qk_norm`` and an explicit ``head_dim``; Qwen1.5-32B with QKV biases),
the MoE decoders (DeepSeek-MoE-16B, Qwen3-MoE-235B-A22B), xLSTM-350M
(``ssm``), Zamba2-7B (``hybrid``), HuBERT-XLarge (``audio``, an encoder
over precomputed frame embeddings) and Qwen2-VL-2B (``vlm``, a decoder with
M-RoPE over precomputed patch embeddings and text).
"""
from __future__ import annotations

from . import (
    deepseek_moe_16b,
    hubert_xlarge,
    qwen1_5_32b,
    qwen2_vl_2b,
    qwen3_0_6b,
    qwen3_14b,
    qwen3_moe_235b_a22b,
    smollm_135m,
    xlstm_350m,
    zamba2_7b,
)
from .base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    applicable_shapes,
    reduce_for_smoke,
    skipped_shapes,
)

REGISTRY: dict[str, ArchConfig] = {
    cfg.name: cfg for cfg in (m.config() for m in (
        qwen3_0_6b, qwen1_5_32b, qwen3_14b, smollm_135m, deepseek_moe_16b,
        qwen3_moe_235b_a22b, xlstm_350m, zamba2_7b, hubert_xlarge, qwen2_vl_2b))
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(REGISTRY)}"
        )
    return REGISTRY[name]


def get_smoke_config(name: str) -> ArchConfig:
    return reduce_for_smoke(get_config(name))


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "REGISTRY",
    "applicable_shapes",
    "skipped_shapes",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "reduce_for_smoke",
]
