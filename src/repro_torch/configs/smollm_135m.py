"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M; hf] — llama-arch small."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        d_ff=1536,
        vocab_size=49_152,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
