"""Registry of the architectures the port runs, and the workload shapes.

Only the two dense configurations are here: SmolLM-135M (the serving
model) and Qwen3-0.6B (``qk_norm`` and an explicit ``head_dim``).  The
JAX package's other families wait for their slices of the port.
"""
from __future__ import annotations

from . import qwen3_0_6b, smollm_135m
from .base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    reduce_for_smoke,
)

REGISTRY: dict[str, ArchConfig] = {
    cfg.name: cfg for cfg in (m.config() for m in (qwen3_0_6b, smollm_135m))
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
    "get_config",
    "get_smoke_config",
    "list_archs",
    "reduce_for_smoke",
]
