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


def decode_attention_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           count: torch.Tensor, chunk: int) -> torch.Tensor:
    """The CUDA kernel's split-and-combine arithmetic in plain PyTorch, for
    the tests: the window cut into chunks of ``chunk`` rows, each chunk's
    partial softmax state (max ``m``, sum ``l``, unnormalised ``acc``) in
    float32, then the chunks that start below ``count`` merged; none merged
    gives zeros.  (The kernel's bf16 path also rounds P to bf16 for its
    tensor-core product; this mirror keeps P in float32.)  Same signature
    and result as :func:`decode_attention`."""
    b, h, dh = q.shape
    w, hk = k.shape[1], k.shape[2]
    splits = -(-w // chunk)
    pad = splits * chunk - w
    kf, vf = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (k, v))
    qg = q.float().reshape(b, hk, h // hk, dh)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, kf) * (1.0 / math.sqrt(dh))
    s = s.reshape(b, hk, h // hk, splits, chunk)
    rows = torch.arange(splits * chunk, device=q.device).reshape(splits, chunk)
    live = rows[None] < count[:, None, None]                        # [B, splits, chunk]
    s = torch.where(live[:, None, None], s, -math.inf)
    m = s.amax(dim=-1)                                              # [B, Hkv, G, splits]
    used = live[:, :, 0][:, None, None]                             # chunk starts below count
    p = torch.exp(s - torch.where(used, m, 0.0)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgsc,bsckd->bkgsd", p, vf.reshape(b, splits, chunk, hk, dh))
    top = torch.where(used, m, -math.inf).amax(dim=-1, keepdim=True)
    f = torch.where(used, torch.exp(m - torch.where(used, top, 0.0)), 0.0)
    out = (acc * f[..., None]).sum(dim=3) / torch.clamp((l * f).sum(dim=3), min=1e-30)[..., None]
    return out.reshape(b, h, dh).to(q.dtype)
