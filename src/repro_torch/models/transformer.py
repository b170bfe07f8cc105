"""Model assembly for the dense decoder family (a port of the JAX package's
``models/transformer.py``).

:class:`Model` is a plain class, not an ``nn.Module``: like the JAX model
it holds no weights, and its methods take a params dict that mirrors the
JAX pytree leaf for leaf (layers stacked on a leading ``[L]`` axis), so
``interop.lm_params_from_numpy`` carries the JAX package's weights across
unchanged.  It exposes:

* ``init(generator)``                       — parameter dict (stacked layers);
* ``forward(params, batch)``                — full-sequence logits (prefill);
* ``init_cache(batch, window)``             — decode cache dict;
* ``decode_step(params, cache, tokens, pos)`` — one serve step.

The layer stack is a Python loop over the stacked params (``lax.scan`` in
JAX).  ``use_flash`` sends causal prefill attention through K3; decode
attention always goes through K4.  Only the ``dense`` family is ported;
the others raise ``NotImplementedError``, and ``loss`` and ``remat`` wait
for the training slice (ROADMAP queue 1, items 11 and 13).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers as L

Params = dict


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: only "
            "'dense' runs in repro_torch (ROADMAP queue 1, item 11)"
        )


def init_attn_block(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    p = {
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
    }
    if cfg.norm == "ln":
        p["mlp"] = L.init_gelu_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)
    else:
        p["mlp"] = L.init_swiglu(gen, cfg, cfg.d_model, cfg.d_ff, device)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    hn = L.norm(p["ln2"], h, cfg)
    return L.gelu_mlp(p["mlp"], hn) if cfg.norm == "ln" else L.swiglu(p["mlp"], hn)


def attn_block(p, h, cfg, positions, use_flash=False):
    h = h + L.attention(p["attn"], L.norm(p["ln1"], h, cfg), cfg, positions,
                        use_flash=use_flash)
    return h + _ffn(p, h, cfg)


def attn_block_decode(p, h, cfg, cache, pos):
    out, cache = L.attention_decode(p["attn"], L.norm(p["ln1"], h, cfg), cfg, cache, pos)
    h = h + out
    return h + _ffn(p, h, cfg), cache


def _index(tree, i: int):
    """Layer ``i`` of a dict of stacked tensors (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@dataclass
class Model:
    cfg: ArchConfig
    use_flash: bool = False
    device: Optional[torch.device] = field(default=None)

    def __post_init__(self):
        _check_family(self.cfg)
        self.device = resolve_device(self.device)

    # ------------------------------------------------------------- init

    def init(self, generator: torch.Generator) -> Params:
        """Random parameters from ``generator`` (its draws, not JAX's: tests
        carry the JAX package's weights across instead)."""
        cfg, dev = self.cfg, self.device
        return {
            "final_norm": L.init_norm(cfg, cfg.d_model, dev),
            "embed": L.init_embed(generator, cfg, dev),
            "layers": _stack([init_attn_block(generator, cfg, dev)
                              for _ in range(cfg.num_layers)]),
        }

    # ------------------------------------------------------------- fwd

    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """Full-sequence logits ``[B, S, V]`` in the compute dtype, and an
        aux dict (empty for the dense family)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        h = L.embed(params["embed"], tokens, cfg)
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        for i in range(cfg.num_layers):
            h = attn_block(_index(params["layers"], i), h, cfg, positions,
                           use_flash=self.use_flash)
        h = L.norm(params["final_norm"], h, cfg)
        return L.unembed(params["embed"], h, cfg), {}

    # ------------------------------------------------------------- serve

    def init_cache(self, batch: int, window: int, device=None) -> Params:
        """``{"kv": {"k": [L, B, W, Hkv, Dh], "v": ...}}`` zeros in the
        compute dtype, on ``device`` (default: the model's)."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        layer = L.init_kv_cache(cfg, batch, window, L.cdtype(cfg), dev)
        return {"kv": {k: v.unsqueeze(0).repeat((cfg.num_layers,) + (1,) * v.dim())
                       for k, v in layer.items()}}

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
        """One token per sequence. tokens [B] int32, pos [B] int32.
        Returns (logits [B, V] float32, new cache); ``cache`` is not written."""
        cfg = self.cfg
        h = L.embed(params["embed"], tokens[:, None], cfg)  # [B,1,d]
        new_layers = []
        for i in range(cfg.num_layers):
            h, lc = attn_block_decode(_index(params["layers"], i), h, cfg,
                                      _index(cache["kv"], i), pos)
            new_layers.append(lc)
        h = L.norm(params["final_norm"], h, cfg)
        logits = L.unembed(params["embed"], h, cfg)[:, 0]
        return logits.float(), {"kv": _stack(new_layers)}


def get_model(cfg: ArchConfig, use_flash: bool = False, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default: the CUDA card)."""
    return Model(cfg, use_flash=use_flash, device=device)
