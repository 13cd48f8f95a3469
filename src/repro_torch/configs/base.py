"""Config dataclasses for models and shapes (port of ``repro.configs.base``).

Every assigned architecture is expressed as a :class:`ModelConfig`; the
shape suite (train_4k / prefill_32k / decode_32k / long_500k) is a
:class:`ShapeConfig`.  Plain frozen dataclasses, field for field the JAX
package's, so a config reads the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "gqa"                 # "gqa" | "mla"
    rope_theta: float = 10000.0
    rope_local_theta: Optional[float] = None  # gemma3: local layers use 10k
    sliding_window: Optional[int] = None   # window size for local layers
    #: layer pattern period: within each period of ``pattern_period`` layers,
    #: the first ``pattern_local`` are sliding-window and the rest global.
    #: (gemma2: period 2, 1 local; gemma3: period 6, 5 local; 0 = all global)
    pattern_period: int = 0
    pattern_local: int = 0
    attn_softcap: Optional[float] = None   # gemma2 logit soft-capping
    qk_norm: bool = False                  # gemma3 / qwen3
    attn_bias: bool = False                # qwen2-style qkv bias
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    def is_local(self, layer_idx: int) -> bool:
        if self.pattern_period <= 0:
            return False
        return (layer_idx % self.pattern_period) < self.pattern_local


# ---------------------------------------------------------------------------
# MoE / SSM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0                 # shared (always-on) experts
    capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading dense layers (DeepSeek-V2: 1)
    d_ff_dense: int = 0               # FFN width of those dense layers
    group_size: int = 4096            # GShard dispatch group (tokens)
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                         # "mamba1" | "mamba2"
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64                # mamba2 only
    chunk: int = 256                  # chunked-scan block length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    #: hybrid (zamba2-style): a weight-shared attention+FFN block applied
    #: every ``shared_attn_every`` backbone layers.
    shared_attn_every: int = 0
    causal: bool = True               # False → encoder-only (hubert)
    act: str = "silu"                 # silu | gelu (GLU-gated FFN)
    norm_eps: float = 1e-6
    final_softcap: Optional[float] = None  # gemma2 final-logit capping
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    #: modality frontend stub: None | "vit" | "audio".  ``frontend_dim`` is
    #: the precomputed patch/frame embedding width; ``frontend_len`` the
    #: number of prefix positions they occupy.
    frontend: Optional[str] = None
    frontend_dim: int = 0
    frontend_len: int = 0
    # --- numerics / structure ---
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"
    scan_layers: bool = True
    remat: bool = True
    q_chunk: int = 1024               # chunked-attention block sizes
    kv_chunk: int = 1024
    # --- distribution ---
    fsdp: bool = False                # shard params over the data axis too
    #: optimizer moment dtype ("float32" | "bfloat16") — bf16 for the
    #: largest archs so the train state fits 16 GB/chip.
    moment_dtype: str = "float32"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/lm-head
        (and the logits!) shard over the model axis — vocabularies like
        internvl2's 151655 are otherwise fully replicated per chip.
        Logical ``vocab_size`` is unchanged; padded logit columns are
        never valid targets."""
        return ((self.vocab_size + 255) // 256) * 256

    def active_params(self) -> int:
        """Approximate active parameter count (per-token, for 6ND FLOPs)."""
        return count_params(self, active_only=True)

    def total_params(self) -> int:
        return count_params(self, active_only=False)


def _attn_params(cfg: ModelConfig) -> int:
    a = cfg.attention
    if a is None:
        return 0
    d = cfg.d_model
    if a.kind == "mla":
        q = d * a.q_lora_rank + a.q_lora_rank * a.n_heads * (a.qk_nope_dim + a.qk_rope_dim)
        kv = d * (a.kv_lora_rank + a.qk_rope_dim)
        kv += a.kv_lora_rank * a.n_heads * (a.qk_nope_dim + a.v_head_dim)
        o = a.n_heads * a.v_head_dim * d
        return q + kv + o
    qkv = d * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
    o = a.n_heads * a.head_dim * d
    return qkv + o


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # gated (SwiGLU/GeGLU): up, gate, down


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    if s is None:
        return 0
    d, di, n = cfg.d_model, s.d_inner(cfg.d_model), s.d_state
    p = d * 2 * di                      # in_proj (x and z branches)
    p += di * s.d_conv                  # depthwise conv
    if s.kind == "mamba1":
        p += di * (2 * n + 1) + di * n  # x_proj (B, C, dt) + A
    else:
        h = s.n_heads(cfg.d_model)
        p += di * (2 * n) + h + h * n   # B, C proj; dt bias; A per head
    p += di * d                         # out_proj
    return p


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count; ``active_only`` counts top-k routed experts only."""
    d = cfg.d_model
    total = cfg.vocab_size * d          # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d     # lm head
    per_layer = _attn_params(cfg) + 2 * d  # attn + 2 norms

    if cfg.family in ("ssm",):
        per_layer = _ssm_params(cfg) + d
        total += cfg.n_layers * per_layer
    elif cfg.family == "hybrid":
        per_layer = _ssm_params(cfg) + d
        total += cfg.n_layers * per_layer
        if cfg.shared_attn_every:
            total += _attn_params(cfg) + _ffn_params(d, cfg.d_ff) + 2 * d
    elif cfg.moe is not None:
        m = cfg.moe
        n_moe = cfg.n_layers - m.first_dense_layers
        router = d * m.n_experts
        if active_only:
            experts = (m.top_k + m.n_shared) * _ffn_params(d, m.d_ff_expert)
        else:
            experts = (m.n_experts + m.n_shared) * _ffn_params(d, m.d_ff_expert)
        total += n_moe * (per_layer + router + experts)
        dense_ff = m.d_ff_dense or cfg.d_ff
        total += m.first_dense_layers * (per_layer + _ffn_params(d, dense_ff))
    else:
        total += cfg.n_layers * (per_layer + _ffn_params(d, cfg.d_ff))
    return int(total)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Task-spec skips: returns (applicable, reason-if-not)."""
    if model.is_encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and model.family not in ("ssm", "hybrid"):
        return False, ("long_500k requires sub-quadratic attention; "
                       "skipped for full-attention archs per task spec")
    return True, ""


# ---------------------------------------------------------------------------
# Train / serve step configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"          # cosine | constant
    compress_grads: bool = False      # int8 all-reduce with error feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    microbatch: int = 0               # 0 → no microbatching (single pass)
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator for 405B
    z_loss: float = 1e-4
    seed: int = 0
