"""Model assembly for the dense decoder family (a port of the JAX package's
``models/transformer.py``).

:class:`Model` is a plain class, not an ``nn.Module``: like the JAX model
it holds no weights, and its methods take a params dict that mirrors the
JAX pytree leaf for leaf (layers stacked on a leading ``[L]`` axis), so
``interop.lm_params_from_numpy`` carries the JAX package's weights across
unchanged.  It exposes:

* ``init(generator)``                       — parameter dict (stacked layers);
* ``forward(params, batch, remat)``         — full-sequence logits;
* ``loss(params, batch, remat)``            — scalar loss and metrics;
* ``cast_for_compute(params)``              — the compute copy of the weights;
* ``init_cache(batch, window)``             — decode cache dict;
* ``decode_step(params, cache, tokens, pos)`` — one serve step;
* ``input_specs(shape)`` / ``make_batch``   — the inputs of a shape.

The layer stack is a Python loop over the stacked params (``lax.scan`` in
JAX); ``remat`` checkpoints each layer (``none | full | dots``).
``use_flash`` sends causal prefill attention through K3, which has no
backward: under autograd it raises, as the reference's Pallas kernel does
under ``jax.grad``, so training leaves it off.  Decode attention always
goes through K4.  Only the ``dense`` family is ported; the others raise
``NotImplementedError`` (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from ..mcmc import prng
from . import layers as L
from ..core.tree import tree_flatten_with_path, tree_unflatten

Params = dict

# The outputs ``remat="dots"`` keeps: products with a 2-D weight (``x @ W``
# reaches the dispatcher as ``mm``/``addmm``), JAX's
# ``checkpoint_dots_with_no_batch_dims``.  Batched products (``bmm``: the
# attention scores and values) and everything else are recomputed.
_WEIGHT_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _WEIGHT_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, mode: str):
    """``fn`` under activation checkpointing: ``none`` keeps every
    activation, ``full`` recomputes the whole call in the backward pass,
    ``dots`` keeps only the weight products."""
    if mode == "none":
        return fn
    if mode == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if mode == "dots":
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))
    raise ValueError(f"unknown remat mode {mode!r}")


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

    # Parameter leaves that are matmul weights (streamed in the compute
    # dtype); norms and biases stay in the param dtype.  The reference's
    # list, other families' names included.
    _MATRIX_KEYS = (
        "wq", "wk", "wv", "wo", "wg", "wu", "wd", "w1", "w2",
        "w_in", "w_out", "w_up", "w_down", "w_if", "w_gates", "r_gates",
        "embedding", "lm_head", "router", "conv_w",
    )

    def cast_for_compute(self, params: Params) -> Params:
        """One copy of the matmul weights in the compute dtype, made once a
        step; AdamW still updates the param-dtype masters.  ``params``
        itself when the two dtypes are the same."""
        cd = L.cdtype(self.cfg)
        if cd == L.pdtype(self.cfg):
            return params
        flat, treedef = tree_flatten_with_path(params)
        return tree_unflatten(treedef, [
            leaf.to(cd) if path and path[-1] in self._MATRIX_KEYS and leaf.is_floating_point()
            else leaf for path, leaf in flat])

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

    @staticmethod
    def _inputs(batch: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(tokens [B, S], positions [B, S], loss mask [B, S] float32)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones((b, s), dtype=torch.float32, device=tokens.device)
        return tokens, positions, mask

    def forward(self, params: Params, batch: dict, remat: str = "none"
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence logits ``[B, S, V]`` in the compute dtype, and the
        aux dict (``moe_aux_loss``, 0 for the dense family)."""
        cfg = self.cfg
        tokens, positions, _ = self._inputs(batch)
        h = L.embed(params["embed"], tokens, cfg)

        def body(h, lp):
            return attn_block(lp, h, cfg, positions, use_flash=self.use_flash)

        body = _remat(body, remat)
        for i in range(cfg.num_layers):
            h = body(h, _index(params["layers"], i))
        h = L.norm(params["final_norm"], h, cfg)
        aux = {"moe_aux_loss": torch.zeros((), dtype=torch.float32, device=h.device)}
        return L.unembed(params["embed"], h, cfg), aux

    # ------------------------------------------------------------- loss

    def loss(self, params: Params, batch: dict, remat: str = "none"
             ) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy in float32 over the loss mask (the last
        position and any position whose successor is masked drop out),
        plus ``0.01 * moe_aux_loss``.  Returns (loss, {"ce", "moe_aux_loss"})."""
        logits, aux = self.forward(params, batch, remat)
        labels, _, mask = self._inputs(batch)
        tgt = torch.roll(labels, -1, dims=1).long()
        m = mask * torch.roll(mask, -1, dims=1)
        m[:, -1] = 0.0
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, tgt[..., None], dim=-1)[..., 0]
        ce = ((logz - gold) * m).sum() / torch.clamp(m.sum(), min=1.0)
        return ce + 0.01 * aux["moe_aux_loss"], {"ce": ce, **aux}

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


    # ------------------------------------------------------------- specs

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Every model input of ``shape`` as a tensor on the ``meta``
        device (shape and dtype only): ``tokens [B, S]`` for train and
        prefill, ``tokens [B]`` and ``pos [B]`` for decode."""
        b, s = shape.global_batch, shape.seq_len
        meta = dict(dtype=torch.int32, device="meta")
        if shape.kind == "decode":
            return {"tokens": torch.empty((b,), **meta), "pos": torch.empty((b,), **meta)}
        return {"tokens": torch.empty((b, s), **meta)}

    def make_batch(self, key: torch.Tensor, shape: ShapeSpec) -> dict:
        """Random inputs matching ``input_specs`` from a threefry key, on
        the model's device: the reference's draws (``tokens`` uniform over
        the vocabulary, ``pos`` zeros)."""
        out = {}
        for name, spec in self.input_specs(shape).items():
            key, k = prng.split(key)
            if name == "tokens":
                x = prng.randint(k, tuple(spec.shape), 0, self.cfg.vocab_size)
            else:
                x = torch.zeros(tuple(spec.shape), dtype=spec.dtype)
            out[name] = x.to(self.device)
        return out


def get_model(cfg: ArchConfig, use_flash: bool = False, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default: the CUDA card)."""
    return Model(cfg, use_flash=use_flash, device=device)
