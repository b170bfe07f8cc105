"""Architecture + shape configuration system (a pure-Python copy of the
JAX package's ``configs/base.py``, which the port may not import).

Every assigned architecture is an :class:`ArchConfig`; every workload shape
is a :class:`ShapeSpec`.  The cross product (with per-family applicability
rules) defines the dry-run / roofline matrix.

Families
--------
``dense``   decoder-only transformer (GQA, RoPE, SwiGLU)
``moe``     dense + mixture-of-experts FFN (shared + routed top-k)
``ssm``     xLSTM (mLSTM + sLSTM blocks)
``hybrid``  Mamba2 backbone + shared attention blocks (Zamba2)
``audio``   encoder-only transformer backbone (HuBERT); stub frame frontend
``vlm``     decoder transformer with M-RoPE (Qwen2-VL); stub patch frontend
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    causal: bool = True
    is_encoder: bool = False
    norm: str = "rms"  # rms | ln
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # M-RoPE (vlm): half-head-dim split into (temporal, height, width)
    mrope_sections: tuple[int, ...] = ()
    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # routed-expert hidden size (fine-grained)
    dense_d_ff: int = 0  # FFN size of the leading dense layers (deepseek)
    first_dense_layers: int = 0
    moe_renorm_topk: bool = True
    capacity_factor: float = 1.25
    # SSM (mamba2 in hybrid; mLSTM/sLSTM in ssm family)
    ssm_state: int = 0  # N (mamba2) — 0 for non-ssm
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # chunked-scan block length
    # hybrid (zamba2): apply the single shared attention block every k layers
    shared_attn_every: int = 0
    # xlstm: per-layer block kinds cycle through this pattern
    xlstm_pattern: tuple[str, ...] = ()  # e.g. ("mlstm","mlstm","mlstm","slstm")
    # long-context serving: sliding window for attention KV in long_500k
    long_context_window: int = 4096
    # query-chunk size for row-blocked attention (memory-bounded softmax)
    attn_q_chunk: int = 512
    # KV-cache storage: "compute" (=compute_dtype) or "int8" (quantized
    # per (position, head) with bf16 scales — halves decode cache bytes)
    kv_cache_dtype: str = "compute"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    @property
    def subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (O(1)/O(w) per step)?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline checks)."""
        d, v = self.d_model, self.vocab_size
        dh = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                attn = d * dh * (self.num_heads + 2 * self.num_kv_heads)
                attn += self.num_heads * dh * d  # out proj
                if self.qkv_bias:
                    attn += dh * (self.num_heads + 2 * self.num_kv_heads)
                total += attn
                total += self.ffn_params(i)
                total += 2 * d  # norms
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                # in_proj: d -> [z(d_in), x(d_in), B(N), C(N), dt(H)]
                total += d * (2 * d_in + 2 * self.ssm_state + nheads)
                total += d_in * d  # out proj
                total += self.ssm_conv_width * d_in  # conv
                total += 2 * d
            elif kind in ("mlstm", "slstm"):
                d_in = self.ssm_expand * d
                total += d * d_in * 4 + d_in * d + 2 * d
        if self.family == "hybrid" and self.shared_attn_every:
            dh_s = self.resolved_head_dim
            shared = d * dh_s * (self.num_heads + 2 * self.num_kv_heads)
            shared += self.num_heads * dh_s * d
            shared += d * self.d_ff * 3
            total += shared
        return total

    def ffn_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.family == "moe" and layer_idx >= self.first_dense_layers:
            routed = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.num_experts
            return routed + shared + router
        if self.family == "moe":
            return 3 * d * self.dense_d_ff
        if self.norm == "ln":  # hubert-style GELU MLP (2 mats)
            return 2 * d * self.d_ff
        return 3 * d * self.d_ff  # SwiGLU

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k active)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        for i in range(self.first_dense_layers, self.num_layers):
            routed_all = self.num_experts * 3 * d * self.moe_d_ff
            routed_act = self.top_k * 3 * d * self.moe_d_ff
            total -= routed_all - routed_act
        return total

    def layer_kind(self, i: int) -> str:
        if self.family == "ssm":
            return self.xlstm_pattern[i % len(self.xlstm_pattern)]
        if self.family == "hybrid":
            return "mamba"
        return "attn"


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeSpec]:
    """Per-instruction applicability: encoders skip decode shapes;
    ``long_500k`` only for sub-quadratic (ssm/hybrid) archs."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.supports_decode:
        out.append(SHAPES["decode_32k"])
        if cfg.subquadratic:
            out.append(SHAPES["long_500k"])
    return out


def skipped_shapes(cfg: ArchConfig) -> dict[str, str]:
    skip: dict[str, str] = {}
    if not cfg.supports_decode:
        skip["decode_32k"] = "encoder-only arch has no decode step"
        skip["long_500k"] = "encoder-only arch has no decode step"
    elif not cfg.subquadratic:
        skip["long_500k"] = (
            "pure full-attention arch; 500k decode needs sub-quadratic mixing"
        )
    return skip


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    kw: dict = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128,
        vocab_size=256,
        head_dim=16 if cfg.head_dim else 0,
        compute_dtype="float32",
    )
    if cfg.family == "moe":
        kw.update(
            num_experts=4, top_k=2, moe_d_ff=32,
            dense_d_ff=128 if cfg.dense_d_ff else 0,
            num_shared_experts=min(cfg.num_shared_experts, 1),
            first_dense_layers=min(cfg.first_dense_layers, 1),
        )
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_head_dim=8, ssm_chunk=16)
    if cfg.family == "ssm":
        kw.update(
            ssm_chunk=16, ssm_head_dim=8,
            xlstm_pattern=("mlstm", "slstm"), num_layers=2,
        )
    if cfg.family == "hybrid":
        kw.update(shared_attn_every=2)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))
    return replace(cfg, name=cfg.name + "-smoke", **kw)
