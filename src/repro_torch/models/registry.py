"""Family -> model-class registry of the port.  ``build_model(cfg)`` is
the single construction point and ``family_spec(cfg)`` the capability
query, as in the JAX package.  Every family of the reference is
ported: dense, MLA + MoE (``mla_moe``), MoE (``moe``), RWKV6
(``rwkv6``), the VLM (``vlm``), the encoder-decoder (``encdec``) and
the RG-LRU hybrid (``rglru_hybrid``); the last three are not servable
(their KVSpecs say so) and run through ``prefill`` and
``decode_step``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import ModelBase
from repro_torch.models.common import configure_numerics
from repro_torch.models.dense import DenseModel
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.kvspec import KVSpec
from repro_torch.models.mla import MLAModel
from repro_torch.models.moe import MoEModel
from repro_torch.models.rglru import RGLRUModel
from repro_torch.models.rwkv6 import RWKV6Model
from repro_torch.models.vlm import VLMModel

FAMILY_CLASSES = {"dense": DenseModel, "mla_moe": MLAModel,
                  "moe": MoEModel, "rwkv6": RWKV6Model, "vlm": VLMModel,
                  "encdec": EncDecModel, "rglru_hybrid": RGLRUModel}


def build_model(cfg: ModelConfig, device="cuda") -> ModelBase:
    model = FAMILY_CLASSES[cfg.family](cfg, device)
    configure_numerics(model.device)
    return model


def family_spec(cfg: ModelConfig) -> KVSpec:
    """The family's declarative cache adapter (allocates nothing)."""
    return build_model(cfg, "cpu").kv_spec()
