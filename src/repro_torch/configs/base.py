"""Architecture + shape configuration for the repro framework.

Every assigned architecture gets one file in this package exporting CONFIG,
an :class:`ArchConfig`. ``registry.get_config(name)`` resolves them.

Shapes are the four assigned benchmark cells; ``train_*`` lowers a train
step, ``prefill_*`` a prefill (encode) step, ``decode_*``/``long_*`` a
single-token serve step against a KV/state cache of the given length.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned input-shape cells (identical sets for all 10 archs).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"  # dense|moe|ssm|hybrid|audio|vlm
    # transformer backbone --------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_head: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 1024
    norm: str = "rmsnorm"  # rmsnorm|layernorm
    activation: str = "swiglu"  # swiglu|geglu|gelu|squared_relu
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA width (h2o-danube)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0  # deepseek-moe: leading dense layers
    d_ff_first_dense: int = 0
    moe_capacity_factor: float = 1.25
    moe_buffer_hint: int = 0  # §Perf A3: EP-shard dispatch buffers
    bf16_grads: int = 0       # §Perf C7: bf16 cotangents at attn boundary
    moe_expert_shard: str = ""  # ""=module default; "din"|"dff" per arch
    # SSM / hybrid ------------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0  # zamba2: shared attention block cadence
    slstm_every: int = 0  # xlstm: one sLSTM per this many layers (rest mLSTM)
    chunk_len: int = 256  # chunkwise-recurrent chunk for SSD/mLSTM
    # enc-dec / modality frontends -------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 0  # whisper: fixed precomputed-frame context
    n_image_tokens: int = 0  # internvl: stub patch embeddings per sample
    # numerics / training ------------------------------------------------------
    dtype: str = "bfloat16"
    remat: str = "full"  # none|dots|full  (activation-checkpoint policy)
    microbatch: int = 1  # gradient-accumulation steps for train_4k
    optimizer_state_dtype: str = "float32"  # bf16 for the largest archs
    act_shard: str = "none"  # none|dmodel|seq — hidden-state extra sharding
    attn_chunk: int = 1024  # q/kv chunk for the flash-style attention
    # notes carried into DESIGN/EXPERIMENTS ----------------------------------
    source: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived -----------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if long_500k decode is sub-quadratic-feasible."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Total parameter count N (analytical)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE-aware)."""
        return _param_count(self, active_only=True)

    def shapes(self) -> list[ShapeSpec]:
        out = []
        for s in SHAPES.values():
            if s.name == "long_500k" and not self.supports_long_context:
                continue
            out.append(s)
        return out

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def _attn_params(cfg: ArchConfig) -> int:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = d * (h * dh) + 2 * d * (kv * dh) + (h * dh) * d
    if cfg.qkv_bias:
        p += (h + 2 * kv) * dh
    return p


def _mlp_params(d_model: int, d_ff: int, activation: str) -> int:
    if activation in ("swiglu", "geglu"):
        return 3 * d_model * d_ff
    return 2 * d_model * d_ff


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    d = cfg.d_model
    emb = cfg.vocab_size * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    total = emb + head + d  # final norm

    if cfg.family == "ssm":
        # xLSTM-style blocks (see models/xlstm.py for the exact shapes).
        per_m = _mlstm_params(cfg)
        per_s = _slstm_params(cfg)
        n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
        n_m = cfg.n_layers - n_s
        return total + n_m * per_m + n_s * per_s

    if cfg.family == "hybrid":
        per_mamba = _mamba2_params(cfg)
        shared = _attn_params(cfg) + _mlp_params(d, cfg.d_ff, "gelu") + 2 * d
        n_shared_applications = 0  # parameters are shared -> count once
        total += cfg.n_layers * (per_mamba + d)
        total += shared  # one shared block, reused
        return total

    # transformer families ---------------------------------------------------
    per_layer_attn = _attn_params(cfg) + 2 * d  # + 2 norms
    n_dec = cfg.n_layers
    for i in range(n_dec):
        total += per_layer_attn
        if cfg.is_moe and i >= cfg.first_dense_layers:
            e_p = _mlp_params(d, cfg.d_ff_expert, cfg.activation)
            router = d * cfg.n_experts
            shared = cfg.n_shared_experts * e_p
            if active_only:
                total += cfg.moe_top_k * e_p + router + shared
            else:
                total += cfg.n_experts * e_p + router + shared
        elif cfg.is_moe:
            total += _mlp_params(d, cfg.d_ff_first_dense or cfg.d_ff, cfg.activation)
        else:
            total += _mlp_params(d, cfg.d_ff, cfg.activation)
    if cfg.is_encoder_decoder:
        # encoder layers + decoder cross-attn
        enc_layer = per_layer_attn + _mlp_params(d, cfg.d_ff, cfg.activation)
        total += cfg.n_encoder_layers * enc_layer
        total += n_dec * (_attn_params(cfg) + d)  # cross-attn + norm
    return total


def _mamba2_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n_h = d_in // cfg.ssm_head_dim
    n_g = 1
    proj_in = d * (2 * d_in + 2 * n_g * cfg.ssm_state + n_h)
    conv = (d_in + 2 * n_g * cfg.ssm_state) * cfg.ssm_conv
    out = d_in * d
    extra = n_h * 2 + d_in  # A, D, norm
    return proj_in + conv + out + extra


def _mlstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    d_in = 2 * d
    qkv = 3 * d_in * d_in
    gates = 2 * (d_in * cfg.n_heads)  # i,f per head (projected)
    proj = d * d_in * 2 + d_in * d  # up (x2 for gate) + down ... see module
    return qkv + gates + proj + 2 * d_in


def _slstm_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    per_head = d // cfg.n_heads
    rec = cfg.n_heads * per_head * per_head * 4
    inp = d * d * 4
    ff = int(d * 4 / 3) * d * 2
    return rec + inp + ff + 4 * d


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=max(2, min(4, cfg.attn_every or 2, cfg.slstm_every or 2)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        microbatch=1,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, moe_top_k=2, d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  d_ff_first_dense=128 if cfg.first_dense_layers else 0)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, chunk_len=32)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.slstm_every:
        kw.update(slstm_every=2, n_layers=4)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_len=16)
    if cfg.n_image_tokens:
        kw.update(n_image_tokens=8)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.replace(**kw)
