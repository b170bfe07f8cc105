"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only backbone
(same arch as wav2vec2-large x2); modality frontend is a STUB:
``input_specs()`` supplies precomputed frame embeddings."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,  # HuBERT cluster codebook
        causal=False,
        is_encoder=True,
        norm="ln",
        norm_eps=1e-5,
    )
