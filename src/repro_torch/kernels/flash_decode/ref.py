"""Plain PyTorch version of single-token decode attention over a KV cache
(K4).

It follows the TPU kernel ``src/repro/kernels/flash_decode/kernel.py``:
float32 scores, softmax and P.V whatever the input type, the output
rounded once to ``q``'s type, and a sequence with ``count == 0`` giving
zeros (the kernel skips every block and divides a zero accumulator by
``max(l, 1e-30)``).  The JAX package's ``ref.py`` returns the mean of
``v`` there instead.  The CPU path of :mod:`.ops` runs this; on the card
only the kernel checks use it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     count: torch.Tensor) -> torch.Tensor:
    """q: [B, H, Dh]; k, v: [B, W, Hkv, Dh]; count: [B] -> [B, H, Dh]."""
    b, h, dh = q.shape
    w, hk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hk, h // hk, dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.float()) * (1.0 / math.sqrt(dh))
    valid = torch.arange(w, device=q.device)[None] < count[:, None]  # [B, W]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    out = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, dim=-1), v.float())
    out = torch.where((count > 0)[:, None, None, None], out, 0.0)
    return out.reshape(b, h, dh).to(q.dtype)
