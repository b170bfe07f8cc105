"""Plain PyTorch version of causal GQA flash attention (K3).

It follows the TPU kernel ``src/repro/kernels/flash_attention/kernel.py``,
not the JAX package's ``ref.py``: scores, softmax and the P.V product are
float32 whatever the input type, the output is rounded once to ``q``'s
type, and the causal mask is top-left aligned (``row >= col``), which is
what the kernel computes.  The JAX ``ref.py`` masks bottom-right
(``tril(k=t-s)``); the two agree only when ``S == T``, so a causal call
with ``S != T`` raises here.  The CPU path of :mod:`.ops` runs this; on
the card only the kernel checks use it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: [B, S, H, Dh]; k, v: [B, T, Hkv, Dh] -> [B, S, H, Dh]."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    if causal and s != t:
        raise ValueError(
            f"causal attention needs S == T (the kernel's mask is top-left "
            f"aligned), got S={s}, T={t}"
        )
    g = h // hk
    qg = q.float().reshape(b, s, hk, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (1.0 / math.sqrt(dh))
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(rows >= cols, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)
