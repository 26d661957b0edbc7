"""Architecture registry of the port: the dense configurations.

``REGISTRY`` holds every dense configuration of the JAX package's
registry (the paper's llama2-7b and opt-6.7b, and smollm-360m,
qwen2.5-14b, qwen3-32b and deepseek-67b), with the same fields.
``reduced(cfg)`` derives the CPU-sized config the tests use, with the
same numbers as the JAX package's ``reduced`` for a dense model, so
both packages build identical shapes.  The other families join as they
are ported (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_67b import CONFIG as _ds67
from repro_torch.configs.llama2_7b import CONFIG as _llama2
from repro_torch.configs.opt_6_7b import CONFIG as _opt
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3
from repro_torch.configs.smollm_360m import CONFIG as _smollm

REGISTRY = {c.name: c for c in (_llama2, _opt, _smollm, _qwen25, _qwen3,
                                _ds67)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)} "
                       "(other architectures: see ROADMAP.md)")
    return REGISTRY[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU tests (dense families)."""
    return cfg.with_overrides(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab=512,
        head_dim=16,
        max_seq=256,
    )


__all__ = ["REGISTRY", "ModelConfig", "get_config", "reduced"]
