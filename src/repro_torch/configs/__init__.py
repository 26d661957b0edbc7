"""Architecture registry of the port: ``llama2-7b`` only.

``reduced(cfg)`` derives the CPU-sized config the tests use, with the
same numbers as the JAX package's ``reduced`` for a dense model, so
both packages build identical shapes.  Other architectures join as
their families are ported (``ROADMAP.md``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.llama2_7b import CONFIG as _llama2

REGISTRY = {_llama2.name: _llama2}


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
