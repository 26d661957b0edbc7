"""Family -> model-class registry of the port.  ``build_model(cfg)`` is
the single construction point and ``family_spec(cfg)`` the capability
query, as in the JAX package.  The dense, the MLA + MoE (``mla_moe``),
the MoE (``moe``), the RWKV6 (``rwkv6``) and the VLM (``vlm``)
families are ported; every other family (``encdec``,
``rglru_hybrid``) raises ``NotImplementedError`` by name (see
``ROADMAP.md``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import ModelBase
from repro_torch.models.common import configure_numerics
from repro_torch.models.dense import DenseModel
from repro_torch.models.kvspec import KVSpec
from repro_torch.models.mla import MLAModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.vlm import VLMModel

FAMILY_CLASSES = {"dense": DenseModel, "mla_moe": MLAModel,
                  "moe": MoEModel, "rwkv6": RWKV6Model, "vlm": VLMModel}


def build_model(cfg: ModelConfig, device="cuda") -> ModelBase:
    cls = FAMILY_CLASSES.get(cfg.family)
    if cls is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet; the "
            f"port covers {sorted(FAMILY_CLASSES)} (other families: "
            "ROADMAP.md)")
    model = cls(cfg, device)
    configure_numerics(model.device)
    return model


def family_spec(cfg: ModelConfig) -> KVSpec:
    """The family's declarative cache adapter (allocates nothing)."""
    return build_model(cfg, "cpu").kv_spec()
