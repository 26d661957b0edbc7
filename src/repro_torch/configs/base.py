"""Model / shape configuration system for the LLMS reproduction.

Every assigned architecture is expressed as a :class:`ModelConfig`.  The
config is a *pure description*: model code in ``repro_torch.models``
consumes it.  A copy of the JAX package's ``configs/base.py`` with the
same fields and behaviour, so the two packages read one config alike.

Families
--------
``dense``        decoder-only transformer (GQA / MHA)
``moe``          decoder-only transformer with mixture-of-experts FFN
``mla_moe``      DeepSeek-style Multi-head Latent Attention + MoE
``rglru_hybrid`` RecurrentGemma: RG-LRU recurrent blocks + local attention
``rwkv6``        RWKV-6 "Finch": attention-free, data-dependent decay
``encdec``       Whisper-style encoder-decoder (audio frontend stubbed)
``vlm``          Llama-3.2-Vision-style: self-attn + interleaved cross-attn
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

Family = Literal[
    "dense", "moe", "mla_moe", "rglru_hybrid", "rwkv6", "encdec", "vlm"
]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (dropping/capacity dispatch)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # number of always-on shared experts
    d_shared: int = 0             # hidden size of the fused shared expert
    capacity_factor: float = 1.25
    # tokens are dispatched in groups of this size; a key perf lever --
    # smaller groups shrink the one-hot dispatch tensors (see DESIGN.md)
    group_size: int = 1024
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank Q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""

    lru_width: int = 2560
    conv_width: int = 4
    window: int = 2048            # local-attention window for attn blocks
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclass(frozen=True)
class RWKV6Config:
    """RWKV-6 (Finch) time-mix / channel-mix."""

    head_dim: int = 64
    decay_lora: int = 64          # rank of the data-dependent decay LoRA
    mix_lora: int = 32            # rank of the token-shift mix LoRA
    chunk_len: int = 16           # chunked prefill length (16*5 < ln(fp32max))


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder.  The conv/audio frontend is a STUB: the
    runtime provides precomputed frame embeddings of shape
    (batch, n_frames, d_model)."""

    n_layers: int = 6
    n_frames: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """Cross-attention VLM plumbing.  The vision tower is a STUB: the
    runtime provides precomputed patch embeddings of shape
    (batch, n_image_tokens, d_vision)."""

    n_image_tokens: int = 1601
    d_vision: int = 7680
    cross_attn_every: int = 5     # one cross-attn layer per this many layers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 => d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    max_seq: int = 4096
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # streaming / long-context: sliding-window attention with attention
    # sinks (the paper applies exactly this -- StreamingLLM [71] -- to run
    # LLM inference over unbounded contexts, see paper section 4).
    sliding_window: int = 0       # 0 => full attention
    n_sink_tokens: int = 128
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    rwkv: Optional[RWKV6Config] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    source: str = ""              # provenance note from the assignment

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- analytic parameter counting (used by roofline MODEL_FLOPS) ----- #
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def kv_bytes_per_token(self, bytes_per_elem: float = 2.0) -> float:
        """KV-cache bytes for ONE token across all layers (context memory)."""
        if self.family == "rwkv6":
            return 0.0  # constant-size state, not per-token
        if self.family == "mla_moe" and self.mla is not None:
            d = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
            return self.n_layers * d * bytes_per_elem
        if self.family == "rglru_hybrid" and self.rglru is not None:
            pat = self.rglru.block_pattern
            n_attn = sum(1 for _ in range(self.n_layers)
                         if pat[_ % len(pat)] == "attn")
            return n_attn * 2 * self.n_kv_heads * self.head_dim * bytes_per_elem
        n = self.n_layers
        if self.family == "encdec" and self.encoder is not None:
            n = self.n_layers  # decoder self-attn layers only
        return n * 2 * self.n_kv_heads * self.head_dim * bytes_per_elem


def _ffn_params(cfg: ModelConfig) -> int:
    """Gated (SwiGLU) FFN parameter count per layer."""
    return 3 * cfg.d_model * cfg.d_ff


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    return q + kv + o


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    emb = cfg.vocab * cfg.d_model
    head = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    total = emb + head
    if cfg.family == "rwkv6":
        assert cfg.rwkv is not None
        d = cfg.d_model
        per_layer = (
            5 * d * d                       # r,k,v,g,o time-mix projections
            + d * cfg.rwkv.decay_lora * 2   # decay LoRA
            + 5 * d * cfg.rwkv.mix_lora * 2 # token-shift mix LoRAs
            + 2 * d * cfg.d_ff              # channel-mix (k, v)... r below
            + d * d                         # channel-mix receptance
        )
        return total + cfg.n_layers * per_layer

    if cfg.family == "rglru_hybrid":
        assert cfg.rglru is not None
        w = cfg.rglru.lru_width
        d = cfg.d_model
        rec = 2 * d * w + w * d + 2 * w * cfg.rglru.conv_width + 2 * w
        attn = _attn_params(cfg)
        pat = cfg.rglru.block_pattern
        n_attn = sum(1 for i in range(cfg.n_layers) if pat[i % len(pat)] == "attn")
        n_rec = cfg.n_layers - n_attn
        total += n_rec * (rec + _ffn_params(cfg)) + n_attn * (attn + _ffn_params(cfg))
        return total

    if cfg.family == "mla_moe":
        assert cfg.mla is not None and cfg.moe is not None
        m = cfg.mla
        d = cfg.d_model
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = (d * cfg.n_heads * qk_hd                      # q proj
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)  # kv down
                + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + cfg.n_heads * m.v_head_dim * d)            # o proj
        moe = cfg.moe
        expert = 3 * d * moe.d_expert
        shared = 3 * d * moe.d_shared if moe.d_shared else 0
        router = d * moe.n_experts
        per_layer = attn + moe.n_experts * expert + shared + router
        total += cfg.n_layers * per_layer
        if active_only:
            active_per_layer = attn + moe.top_k * expert + shared + router
            return emb + head + cfg.n_layers * active_per_layer
        return total

    if cfg.family == "moe":
        assert cfg.moe is not None
        moe = cfg.moe
        d = cfg.d_model
        expert = 3 * d * moe.d_expert
        shared = 3 * d * moe.d_shared if moe.d_shared else 0
        router = d * moe.n_experts
        per_layer = _attn_params(cfg) + moe.n_experts * expert + shared + router
        total += cfg.n_layers * per_layer
        if active_only:
            active = _attn_params(cfg) + moe.top_k * expert + shared + router
            return emb + head + cfg.n_layers * active
        return total

    if cfg.family == "encdec":
        assert cfg.encoder is not None
        enc_layer = _attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff
        dec_layer = 2 * _attn_params(cfg) + 2 * cfg.d_model * cfg.d_ff
        total += cfg.encoder.n_layers * enc_layer + cfg.n_layers * dec_layer
        return total

    if cfg.family == "vlm":
        assert cfg.vision is not None
        n_cross = cfg.n_layers // cfg.vision.cross_attn_every
        n_self = cfg.n_layers - n_cross
        cross = _attn_params(cfg) + _ffn_params(cfg)
        self_l = _attn_params(cfg) + _ffn_params(cfg)
        total += n_self * self_l + n_cross * cross
        total += cfg.vision.d_vision * cfg.d_model  # projector
        return total

    # dense
    total += cfg.n_layers * (_attn_params(cfg) + _ffn_params(cfg))
    return total


# ---------------------------------------------------------------------- #
# Input shapes assigned to this paper.
# ---------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicability(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, note).  See DESIGN.md section 'Arch-applicability'.

    ``long_500k`` requires sub-quadratic context handling.  SSM / hybrid
    archs run natively.  Full-attention archs run in the paper's own
    streaming mode (sliding window + attention sinks, paper section 4)
    EXCEPT whisper, whose decoder context is architecturally capped.
    """
    if shape.name == "long_500k":
        if cfg.family in ("rwkv6", "rglru_hybrid"):
            return True, "native (constant-size / windowed state)"
        if cfg.family == "encdec":
            return False, "skip: enc-dec decoder context architecturally capped"
        return True, "streaming mode: sliding window 8192 + 128 sink tokens"
    return True, ""
