"""xLSTM-350M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks.

The public paper gives block ratios rather than a fixed 350M layout; we use
a 3:1 mLSTM:sLSTM cycle over 24 layers (noted in DESIGN.md)."""
from .base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        num_layers=24,
        d_model=1024,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,  # xLSTM blocks carry their own up-projection (expand=2)
        vocab_size=50_304,
        ssm_expand=2,
        ssm_head_dim=256,  # d_inner (2048) / num_heads (4) per-head width
        ssm_chunk=128,
        xlstm_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    )
