"""Model assembly for every architecture family (a port of the JAX
package's ``models/transformer.py``).

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
goes through K4.

Families, with the reference's trees:

* ``dense``: ``layers`` stacked on ``[L]``; cache ``kv`` ``[L, ...]``.
* ``vlm`` (Qwen2-VL): the dense tree.  Its batch holds precomputed
  ``patch_embeds`` (the vision tower is a stub, as in the reference),
  placed before the text's embeddings, and ``positions [B, 3, S]`` for
  M-RoPE; the loss skips the patches.  Decode takes text tokens, each at
  the same position on the three axes.
* ``audio`` (HuBERT): an encoder (non-causal) over precomputed ``frames``
  through a GELU MLP ``head``, ``layers`` stacked on ``[L]``, a top-level
  ``lm_head`` and no ``embed``; the loss is per-frame classification of
  ``labels``.  It has no decode path: ``init_cache`` and ``decode_step``
  raise the reference's ``ValueError``, so the serving engine refuses it.
* ``moe``: ``dense_layers``, a list of the first ``first_dense_layers``
  blocks (FFN width ``dense_d_ff``), and ``layers``, the MoE blocks
  stacked on ``[L - fd]``; cache ``dense_kv`` (a list) and ``kv``.
* ``ssm`` (xLSTM): ``groups`` stacked on ``[G]``, one per cycle of
  ``xlstm_pattern``, each with ``mlstm`` stacked on ``[n_m]`` and one
  ``slstm``; the cache nests the same way.
* ``hybrid`` (Zamba2): ``layers`` (mamba2) stacked on ``[L]`` and one
  ``shared`` attention block, applied after every ``shared_attn_every``
  mamba layers (one weight copy); cache ``mamba`` ``[L, ...]`` and
  ``shared_kv``, one ring cache per site of the shared block.
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
from ..core.tree import tree_flatten_with_path, tree_unflatten
from . import layers as L
from . import mamba2 as M
from . import moe as MOE
from . import shard_ctx
from . import xlstm as X

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
    if mode not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {mode!r}")
    kw = {} if mode == "full" else dict(
        context_fn=lambda: create_selective_checkpoint_contexts(_dots_policy))

    def call(*args):
        rules = shard_ctx.current_rules()

        def body(*a):  # the backward pass recomputes outside the caller's rules
            with shard_ctx.use_rules(rules):
                return fn(*a)

        return checkpoint(body, *args, use_reentrant=False, **kw)

    return call


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); the families are "
                         f"{', '.join(PORTED_FAMILIES)}")


def init_attn_block(gen: torch.Generator, cfg: ArchConfig, device, moe_layer: bool = False
                    ) -> Params:
    p = {
        "ln1": L.init_norm(cfg, cfg.d_model, device),
        "attn": L.init_attention(gen, cfg, device),
        "ln2": L.init_norm(cfg, cfg.d_model, device),
    }
    if moe_layer:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    elif cfg.norm == "ln":
        p["mlp"] = L.init_gelu_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device)
    else:
        d_ff = cfg.dense_d_ff if cfg.family == "moe" else cfg.d_ff
        p["mlp"] = L.init_swiglu(gen, cfg, cfg.d_model, d_ff, device)
    return p


def _ffn(p: Params, h: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    hn = L.norm(p["ln2"], h, cfg)
    if "moe" in p:
        return MOE.moe_ffn(p["moe"], hn, cfg)
    return (L.gelu_mlp(p["mlp"], hn) if cfg.norm == "ln" else L.swiglu(p["mlp"], hn)), {}


def attn_block(p, h, cfg, positions, seg_mask=None, use_flash=False
               ) -> tuple[torch.Tensor, dict]:
    """One attention block; returns (h, aux), aux empty unless MoE."""
    h = h + L.attention(p["attn"], L.norm(p["ln1"], h, cfg), cfg, positions,
                        seg_mask=seg_mask, use_flash=use_flash)
    y, aux = _ffn(p, h, cfg)
    return h + y, aux


def attn_block_decode(p, h, cfg, cache, pos):
    out, cache = L.attention_decode(p["attn"], L.norm(p["ln1"], h, cfg), cfg, cache, pos)
    h = h + out
    return h + _ffn(p, h, cfg)[0], cache


def _index(tree, i: int):
    """Entry ``i`` of a dict of stacked tensors (views, no copies)."""
    return _map(lambda t: t[i], tree)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stacked(n: int, make) -> Params:
    """``make()`` called ``n`` times, its trees stacked on a new leading
    axis.  Each is copied into the stack as it comes, so one lives beside
    the stack at a time: a list of all of them would double the peak
    memory of a full-width init."""
    out = None
    for i in range(n):
        entry = make()
        if out is None:
            out = _map(lambda t: t.new_empty((n,) + t.shape), entry)
        _map(lambda dst, src: dst[i].copy_(src), out, entry)
    return out


def _map(fn, tree, *rest):
    """``fn`` over the leaves of dicts of tensors, keeping each dict's key
    order: a decode step's new cache must flatten in its ``init_cache``'s
    order, which the serving engine relies on."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _n_stacked(tree) -> int:
    """The leading (layer) axis of a dict of stacked tensors."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _no_decode(cfg: ArchConfig) -> ValueError:
    return ValueError(f"{cfg.family} has no decode path")


def _n_mlstm(cfg: ArchConfig) -> int:
    return cfg.xlstm_pattern.count("mlstm")


@dataclass
class Model:
    cfg: ArchConfig
    use_flash: bool = False
    device: Optional[torch.device] = field(default=None)
    # Activation sharding rules, set by the launcher under a mesh:
    # {"batch": ("pod","data"), "tp": "model", "ep": "model",
    #  "sizes": {axis: size}, "mesh": DeviceMesh}.  forward, loss and
    # decode_step install them (shard_ctx), and the residual stream and
    # logits are redistributed to keep the batch data-parallel.  None => no
    # constraints (one device).
    axis_rules: Optional[dict] = None

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
        cfg, dev, gen = self.cfg, self.device, generator
        params: Params = {"final_norm": L.init_norm(cfg, cfg.d_model, dev)}
        if cfg.family == "audio":
            # The frontend is a stub that supplies frame embeddings.
            params["head"] = L.init_gelu_mlp(gen, cfg, cfg.d_model, cfg.d_model, dev)
            params["lm_head"] = L._normal(gen, (cfg.d_model, cfg.vocab_size), L.pdtype(cfg),
                                          dev) / cfg.d_model ** 0.5
        else:
            params["embed"] = L.init_embed(gen, cfg, dev)
        if cfg.family in ("dense", "vlm", "audio"):
            params["layers"] = _stacked(cfg.num_layers, lambda: init_attn_block(gen, cfg, dev))
        elif cfg.family == "moe":
            fd = cfg.first_dense_layers
            params["dense_layers"] = [init_attn_block(gen, cfg, dev) for _ in range(fd)]
            params["layers"] = _stacked(cfg.num_layers - fd, lambda: init_attn_block(
                gen, cfg, dev, moe_layer=True))
        elif cfg.family == "ssm":
            def init_group() -> Params:
                g: Params = {}
                if _n_mlstm(cfg):
                    g["mlstm"] = _stacked(_n_mlstm(cfg), lambda: {
                        "ln": L.init_norm(cfg, cfg.d_model, dev),
                        "cell": X.init_mlstm(gen, cfg, dev)})
                if "slstm" in cfg.xlstm_pattern:
                    g["slstm"] = {"ln": L.init_norm(cfg, cfg.d_model, dev),
                                  "cell": X.init_slstm(gen, cfg, dev)}
                return g

            params["groups"] = _stacked(self._n_groups, init_group)
        else:  # hybrid
            params["layers"] = _stacked(cfg.num_layers, lambda: {
                "ln": L.init_norm(cfg, cfg.d_model, dev), "mamba": M.init_mamba2(gen, cfg, dev)})
            params["shared"] = init_attn_block(gen, cfg, dev)
        return params

    @property
    def attention_sites(self) -> int:
        """Attention layers a decode step runs, each one K4 launch (none in
        xLSTM or in the decode-less audio encoder; one a site of Zamba2's
        shared block)."""
        if self.cfg.family in ("ssm", "audio"):
            return 0
        return self._n_groups if self.cfg.family == "hybrid" else self.cfg.num_layers

    @property
    def _n_groups(self) -> int:
        """xLSTM pattern cycles (``ssm``) or sites of the shared block
        (``hybrid``)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return cfg.num_layers // len(cfg.xlstm_pattern)
        return cfg.num_layers // cfg.shared_attn_every

    # ------------------------------------------------------------- fwd

    def _embed_batch(self, params: Params, batch: dict):
        """(h [B, S, d], positions [B, S] or [B, 3, S], loss mask [B, S]
        float32, labels [B, S]) of a batch (see the module docstring)."""
        cfg = self.cfg
        if cfg.family == "audio":
            h = L.gelu_mlp(params["head"], batch["frames"].to(L.cdtype(cfg)))
            b, s, _ = h.shape
            mask = torch.ones((b, s), dtype=torch.float32, device=h.device)
            return h, arange_positions((b, s), h.device), mask, batch.get("labels")
        tokens = batch["tokens"]
        h = L.embed(params["embed"], tokens, cfg)
        b, st = tokens.shape
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(h.dtype)
            si = patches.shape[1]
            mask = torch.cat([torch.zeros((b, si), dtype=torch.float32, device=h.device),
                              torch.ones((b, st), dtype=torch.float32, device=h.device)], dim=1)
            labels = torch.cat([tokens.new_zeros((b, si)), tokens], dim=1)
            # (the residual stream's constraint, before the text meets the
            # patches: a vocab-sharded lookup's partial sum cannot be joined)
            h = shard_ctx.constrain(h, ("batch", None, None))
            return torch.cat([patches, h], dim=1), batch["positions"], mask, labels
        mask = batch.get("loss_mask")
        if mask is None:
            mask = torch.ones((b, st), dtype=torch.float32, device=h.device)
        return h, arange_positions((b, st), h.device), mask, tokens

    def forward(self, params: Params, batch: dict, remat: str = "none"
                ) -> tuple[torch.Tensor, dict]:
        """Full-sequence logits ``[B, S, V]`` in the compute dtype, and the
        aux dict (``moe_aux_loss``, summed over the MoE layers; 0 for the
        other families)."""
        with shard_ctx.use_rules(self.axis_rules):
            h, positions, _, _ = self._embed_batch(params, batch)
            return self._logits(params, h, positions, remat)

    def _logits(self, params: Params, h: torch.Tensor, positions: torch.Tensor, remat: str):
        cfg = self.cfg
        h = shard_ctx.constrain(h, ("batch", None, None))
        h, aux_loss = self.backbone(params, h, positions, remat)
        h = L.norm(params["final_norm"], h, cfg)
        if cfg.family == "audio":
            logits = h @ params["lm_head"].to(h.dtype)
        else:
            logits = L.unembed(params["embed"], h, cfg)
        logits = shard_ctx.constrain(logits, ("batch", None, "tp"))
        return logits, {"moe_aux_loss": aux_loss}

    def backbone(self, params: Params, h: torch.Tensor, positions: torch.Tensor,
                 remat: str = "none") -> tuple[torch.Tensor, torch.Tensor]:
        """The layer stack: (h, the MoE layers' summed ``moe_aux_loss``).
        ``remat`` checkpoints each scanned body of the reference: a layer,
        an xLSTM group, a Zamba2 group with its shared block, a tail layer."""
        cfg = self.cfg
        aux_loss = torch.zeros((), dtype=torch.float32, device=h.device)

        def block(h, lp):
            h, aux = attn_block(lp, h, cfg, positions, use_flash=self.use_flash)
            return shard_ctx.constrain(h, ("batch", None, None)), aux.get("moe_aux_loss")

        if cfg.family in ("dense", "moe", "vlm", "audio"):
            dense_layers = params.get("dense_layers", [])
            for lp in dense_layers:
                h, _ = block(h, lp)
            body = _remat(block, remat)
            for i in range(cfg.num_layers - len(dense_layers)):
                h, layer_aux = body(h, _index(params["layers"], i))
                if layer_aux is not None:
                    aux_loss = aux_loss + layer_aux
        elif cfg.family == "ssm":
            def group(h, gp):
                for j in range(_n_mlstm(cfg)):
                    mp = _index(gp["mlstm"], j)
                    h = h + X.mlstm_forward(mp["cell"], L.norm(mp["ln"], h, cfg), cfg)
                if "slstm" in gp:
                    sp = gp["slstm"]
                    h = h + X.slstm_forward(sp["cell"], L.norm(sp["ln"], h, cfg), cfg)
                return shard_ctx.constrain(h, ("batch", None, None))

            body = _remat(group, remat)
            for g in range(self._n_groups):
                h = body(h, _index(params["groups"], g))
        else:  # hybrid
            every, layers = cfg.shared_attn_every, params["layers"]

            def mamba(h, lp):
                h = h + M.mamba2_forward(lp["mamba"], L.norm(lp["ln"], h, cfg), cfg)
                return shard_ctx.constrain(h, ("batch", None, None))

            def group(h, first):
                for i in range(first, first + every):
                    h = mamba(h, _index(layers, i))
                h = attn_block(params["shared"], h, cfg, positions, use_flash=self.use_flash)[0]
                return shard_ctx.constrain(h, ("batch", None, None))

            group, mamba = _remat(group, remat), _remat(mamba, remat)
            for g in range(self._n_groups):
                h = group(h, g * every)
            for i in range(self._n_groups * every, cfg.num_layers):
                h = mamba(h, _index(layers, i))
        return h, aux_loss

    # ------------------------------------------------------------- loss

    def loss(self, params: Params, batch: dict, remat: str = "none"
             ) -> tuple[torch.Tensor, dict]:
        """Cross-entropy in float32 over the loss mask, plus ``0.01 *
        moe_aux_loss``: of the next token for a decoder (the last position
        and any position whose successor is masked drop out), of each
        position's own label for an encoder.  Returns (loss, {"ce",
        "moe_aux_loss"})."""
        with shard_ctx.use_rules(self.axis_rules):
            return self._loss(params, batch, remat)

    def _loss(self, params: Params, batch: dict, remat: str) -> tuple[torch.Tensor, dict]:
        h, positions, mask, labels = self._embed_batch(params, batch)
        logits, aux = self._logits(params, h, positions, remat)
        encoder = self.cfg.is_encoder

        def targets(labels, mask):
            if encoder:
                return labels.long(), mask
            tgt, m = torch.roll(labels, -1, dims=1).long(), mask * torch.roll(mask, -1, dims=1)
            m[:, -1].zero_()  # (zero_, not a scalar write: the same ops on every device)
            return tgt, m

        # roll has no DTensor strategy: each rank shifts its batch rows.
        rows = ("batch", None)
        tgt, m = shard_ctx.local(targets, [rows, rows], [rows, rows],
                                 shard_ctx.replicate_like(labels, logits),
                                 shard_ctx.replicate_like(mask, logits))
        nll = shard_ctx.token_nll(logits, tgt) * m
        ce = nll.sum() / torch.clamp(m.sum(), min=1.0)
        return ce + 0.01 * aux["moe_aux_loss"], {"ce": ce, **aux}

    # ------------------------------------------------------------- serve

    def init_cache(self, batch: int, window: int, device=None) -> Params:
        """The decode cache in the reference's tree (see the module
        docstring), on ``device`` (default: the model's).  KV rings are
        zeros of ``[B, W, Hkv, Dh]`` in the compute dtype; recurrent states
        are float32, with the xLSTM stabilizers ``m`` at ``-1e30``."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        dt = L.cdtype(cfg)

        def kv(n: int) -> Params:
            return _stacked(n, lambda: L.init_kv_cache(cfg, batch, window, dt, dev))

        if cfg.family in ("dense", "vlm"):
            return {"kv": kv(cfg.num_layers)}
        if cfg.family == "moe":
            fd = cfg.first_dense_layers
            return {"dense_kv": [L.init_kv_cache(cfg, batch, window, dt, dev) for _ in range(fd)],
                    "kv": kv(cfg.num_layers - fd)}
        if cfg.family == "ssm":
            cache: Params = {}
            if _n_mlstm(cfg):
                cache["mlstm"] = _stacked(self._n_groups, lambda: _stacked(
                    _n_mlstm(cfg), lambda: X.init_mlstm_cache(cfg, batch, dt, dev)))
            if "slstm" in cfg.xlstm_pattern:
                cache["slstm"] = _stacked(self._n_groups,
                                          lambda: X.init_slstm_cache(cfg, batch, dt, dev))
            return cache
        if cfg.family == "audio":
            raise _no_decode(cfg)
        return {"mamba": _stacked(cfg.num_layers, lambda: M.init_mamba2_cache(cfg, batch, dt, dev)),
                "shared_kv": kv(self._n_groups)}

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
        """One token per sequence. tokens [B] int32, pos [B] int32.
        Returns (logits [B, V] float32, new cache); ``cache`` is not written."""
        with shard_ctx.use_rules(self.axis_rules):
            return self._decode_step(params, cache, tokens, pos)

    def _decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                     pos: torch.Tensor) -> tuple[torch.Tensor, Params]:
        cfg = self.cfg
        if cfg.family == "audio":
            raise _no_decode(cfg)
        h = L.embed(params["embed"], tokens[:, None], cfg)  # [B,1,d]
        h = shard_ctx.constrain(h, ("batch", None, None))
        if cfg.family in ("dense", "moe", "vlm"):
            new = {}
            if cfg.family == "moe":
                new["dense_kv"] = []
                for lp, lc in zip(params["dense_layers"], cache["dense_kv"]):
                    h, lc = attn_block_decode(lp, h, cfg, lc, pos)
                    new["dense_kv"].append(lc)
            layers = []
            for i in range(_n_stacked(cache["kv"])):
                h, lc = attn_block_decode(_index(params["layers"], i), h, cfg,
                                          _index(cache["kv"], i), pos)
                layers.append(lc)
            new["kv"] = _stack(layers)
        elif cfg.family == "ssm":
            groups = []
            for g in range(self._n_groups):
                gp, gc = _index(params["groups"], g), _index(cache, g)
                new_gc = {}
                if "mlstm" in gp:
                    cells = []
                    for j in range(_n_mlstm(cfg)):
                        mp = _index(gp["mlstm"], j)
                        y, mc = X.mlstm_decode_step(mp["cell"], L.norm(mp["ln"], h, cfg), cfg,
                                                    _index(gc["mlstm"], j))
                        h = h + y
                        cells.append(mc)
                    new_gc["mlstm"] = _stack(cells)
                if "slstm" in gp:
                    sp = gp["slstm"]
                    y, new_gc["slstm"] = X.slstm_decode_step(
                        sp["cell"], L.norm(sp["ln"], h, cfg), cfg, gc["slstm"])
                    h = h + y
                groups.append(new_gc)
            new = _stack(groups)
        else:  # hybrid
            every = cfg.shared_attn_every
            mamba, sites = [], []
            for i in range(cfg.num_layers):
                lp = _index(params["layers"], i)
                y, lc = M.mamba2_decode_step(lp["mamba"], L.norm(lp["ln"], h, cfg), cfg,
                                             _index(cache["mamba"], i))
                h = h + y
                mamba.append(lc)
                if (i + 1) % every == 0:  # a site of the shared block
                    h, skv = attn_block_decode(params["shared"], h, cfg,
                                               _index(cache["shared_kv"], len(sites)), pos)
                    sites.append(skv)
            new = {"mamba": _stack(mamba), "shared_kv": _stack(sites)}
        h = L.norm(params["final_norm"], h, cfg)
        logits = L.unembed(params["embed"], shard_ctx.split_contraction(h), cfg)[:, 0]
        logits = shard_ctx.constrain(logits, ("batch", "tp"))
        return logits.float(), new

    # ------------------------------------------------------------- specs

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Every model input of ``shape`` as a tensor on the ``meta``
        device (shape and dtype only): ``tokens [B]`` and ``pos [B]`` for
        decode; for train and prefill ``tokens [B, S]``, or the audio
        encoder's ``frames [B, S, d]`` and ``labels [B, S]``, or the vlm's
        ``S // 8`` patches ``patch_embeds [B, S // 8, d]``, the rest as
        ``tokens`` and ``positions [B, 3, S]`` over both."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        meta = dict(dtype=torch.int32, device="meta")
        cd = dict(dtype=L.cdtype(cfg), device="meta")
        if shape.kind == "decode":
            return {"tokens": torch.empty((b,), **meta), "pos": torch.empty((b,), **meta)}
        if cfg.family == "audio":
            return {"frames": torch.empty((b, s, cfg.d_model), **cd),
                    "labels": torch.empty((b, s), **meta)}
        if cfg.family == "vlm":
            si = s // 8  # image patches take 1/8 of the sequence
            return {"tokens": torch.empty((b, s - si), **meta),
                    "patch_embeds": torch.empty((b, si, cfg.d_model), **cd),
                    "positions": torch.empty((b, 3, s), **meta)}
        return {"tokens": torch.empty((b, s), **meta)}

    def make_batch(self, key: torch.Tensor, shape: ShapeSpec) -> dict:
        """Random inputs matching ``input_specs`` from a threefry key, on
        the model's device, drawn as the reference draws them: ``tokens``
        and ``labels`` uniform over the vocabulary, ``positions`` an arange
        on every axis, ``pos`` and other integers zeros, floats standard
        normals in their dtype."""
        out = {}
        for name, spec in self.input_specs(shape).items():
            key, k = prng.split(key)
            shp = tuple(spec.shape)
            if spec.is_floating_point():
                x = prng.normal(k, shp, spec.dtype)
            elif name in ("tokens", "labels"):
                x = prng.randint(k, shp, 0, self.cfg.vocab_size)
            elif name == "positions":
                x = arange_positions(shp)
            else:
                x = torch.zeros(shp, dtype=spec.dtype)
            out[name] = x.to(self.device)
        return out


def arange_positions(shape: tuple[int, ...], device=None) -> torch.Tensor:
    """int32 positions ``0 .. S-1`` along the last axis of ``shape``,
    broadcast over the rest."""
    return torch.arange(shape[-1], dtype=torch.int32, device=device).expand(shape)


def get_model(cfg: ArchConfig, use_flash: bool = False, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (default: the CUDA card)."""
    return Model(cfg, use_flash=use_flash, device=device)
