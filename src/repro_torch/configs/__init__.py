"""Architecture registry of the port: the ported configurations.

``REGISTRY`` holds every dense configuration of the JAX package's
registry (the paper's llama2-7b and opt-6.7b, and smollm-360m,
qwen2.5-14b, qwen3-32b and deepseek-67b), the MLA + MoE
deepseek-v2-lite-16b, the MoE llama4-maverick-400b-a17b, the RWKV6
rwkv6-1.6b, the VLM llama-3.2-vision-90b, the encoder-decoder
whisper-base and the RG-LRU hybrid recurrentgemma-2b, with the same
fields: every configuration of the JAX package's registry.
``ASSIGNED`` holds the ten architectures of the dry-run cells (all but
llama2-7b and opt-6.7b), ``SHAPES`` the four input shapes of those
cells, and ``shape_applicability`` says which pairs run.
``reduced(cfg)`` derives the CPU-sized config the tests use, with the
same numbers as the JAX package's ``reduced``, so both packages build
identical shapes.
"""
from __future__ import annotations

from repro_torch.configs.base import (SHAPES, EncoderConfig, MLAConfig,
                                      ModelConfig, MoEConfig, RGLRUConfig,
                                      RWKV6Config, ShapeSpec, VisionConfig,
                                      shape_applicability)
from repro_torch.configs.deepseek_67b import CONFIG as _ds67
from repro_torch.configs.deepseek_v2_lite import CONFIG as _dsv2lite
from repro_torch.configs.llama2_7b import CONFIG as _llama2
from repro_torch.configs.llama3_2_vision_90b import CONFIG as _llamav
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.opt_6_7b import CONFIG as _opt
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.rwkv6_1p6b import CONFIG as _rwkv6
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.whisper_base import CONFIG as _whisper

# the ten assigned architectures (the dry-run cells) ...
ASSIGNED = {c.name: c for c in (_llama4, _dsv2lite, _ds67, _qwen3, _smollm,
                                _qwen25, _rgemma, _rwkv6, _whisper, _llamav)}
# ... plus the paper's own evaluation models
REGISTRY = dict(ASSIGNED)
REGISTRY[_llama2.name] = _llama2
REGISTRY[_opt.name] = _opt


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU tests."""
    kw = dict(n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4)
    if cfg.family == "moe":
        kw["moe"] = MoEConfig(n_experts=4, top_k=min(cfg.moe.top_k, 2),
                              d_expert=96, n_shared=cfg.moe.n_shared,
                              d_shared=96 if cfg.moe.d_shared else 0,
                              capacity_factor=2.0, group_size=32)
    if cfg.family == "mla_moe":
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_expert=96, n_shared=2,
                              d_shared=96, capacity_factor=2.0, group_size=32)
        kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=0,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.family == "rglru_hybrid":
        kw["n_layers"] = 5                      # rec, rec, attn, rec, rec
        kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4, window=64,
                                  block_pattern=cfg.rglru.block_pattern)
        kw["head_dim"] = 32
        kw["n_kv_heads"] = 1
    if cfg.family == "rwkv6":
        kw["n_kv_heads"] = 4
        kw["rwkv"] = RWKV6Config(head_dim=16, decay_lora=8, mix_lora=4,
                                 chunk_len=16)
    kw.setdefault("n_layers", min(cfg.n_layers, 4))
    if cfg.family == "encdec":
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=32)
        kw["n_layers"] = 2
    if cfg.family == "vlm":
        kw["n_layers"] = 10
        kw["vision"] = VisionConfig(n_image_tokens=16, d_vision=48,
                                    cross_attn_every=5)
    return cfg.with_overrides(**{
        "name": cfg.name + "-reduced", "d_model": 64, "n_heads": 4,
        "d_ff": 128, "vocab": 512, "head_dim": 16, "max_seq": 256, **kw})


__all__ = ["ASSIGNED", "REGISTRY", "SHAPES", "ShapeSpec", "ModelConfig",
           "get_config", "reduced", "shape_applicability"]
