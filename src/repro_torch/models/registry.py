"""Family -> model-class registry of the port.  ``build_model(cfg)`` is
the single construction point and ``family_spec(cfg)`` the capability
query, as in the JAX package.  Only the dense family is ported; every
other family raises ``NotImplementedError`` (see ``ROADMAP.md``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import ModelBase
from repro_torch.models.common import configure_numerics
from repro_torch.models.dense import DenseModel
from repro_torch.models.kvspec import KVSpec

FAMILY_CLASSES = {"dense": DenseModel}


def build_model(cfg: ModelConfig, device="cuda") -> ModelBase:
    cls = FAMILY_CLASSES.get(cfg.family)
    if cls is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet; the "
            "port covers dense models (other families: ROADMAP.md)")
    model = cls(cfg, device)
    configure_numerics(model.device)
    return model


def family_spec(cfg: ModelConfig) -> KVSpec:
    """The family's declarative cache adapter (allocates nothing)."""
    return build_model(cfg, "cpu").kv_spec()
