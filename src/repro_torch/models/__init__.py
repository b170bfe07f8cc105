"""Model definitions ported so far: the dense decoder family."""
from .transformer import Model, get_model  # noqa: F401
