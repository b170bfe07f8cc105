"""Model definitions: every family of the JAX package (dense, moe, ssm,
hybrid, vlm, audio)."""
from .transformer import Model, get_model  # noqa: F401
