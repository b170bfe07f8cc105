"""Where the port runs: the card unless the caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    With ``None`` and no CUDA present this raises rather than carrying on
    on the CPU: a CPU run must be asked for (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default — pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
