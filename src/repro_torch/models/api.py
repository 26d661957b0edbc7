"""Model protocol of the port (mirror of the JAX package's models/api.py).

Every family implements:

  init(generator) -> params                  (dict of stacked-layer tensors)
  loss(params, batch) -> (scalar, metrics)   (next-token CE; remat inside)
  decode_step(params, tokens, cache, ...) -> DecodeOut
  prefill(params, batch) -> PrefillOut
  kv_spec() -> KVSpec                        (declarative cache adapter)
  _build_cache(batch, seq, dtype, layout) -> cache  (dict incl. 'pos')

Layer parameters are stacked on a leading axis exactly as in the JAX
package, so converted reference weights keep their layout; the layer
``scan`` of the reference becomes a Python loop over that axis.

A model is built for one ``device``.  Entry points default to the card:
building for ``"cuda"`` where no card is present raises, and the CPU
tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.kvspec import KVSpec, LAYOUT_WINDOW

Cache = Dict[str, Any]


def resolve_device(device) -> torch.device:
    """The torch device for ``device``; raises for a CUDA device when no
    card is present (no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


class DecodeOut(NamedTuple):
    logits: torch.Tensor           # (B, vocab) fp32
    cache: Cache


class PrefillOut(NamedTuple):
    logits: torch.Tensor           # (B, vocab) fp32, last position
    cache: Cache
    density: Any                   # (B, S) fp32, or None


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-mean CE in fp32.  logits (B,S,V), targets (B,S) int, mask
    (B,S) or None.  -> (loss, {"loss", "acc"})."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - ll
    mask = (torch.ones_like(nll) if mask is None
            else mask.to(torch.float32))
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    loss = torch.sum(nll * mask) / denom
    acc = torch.sum((torch.argmax(logits, dim=-1) == targets) * mask) / denom
    return loss, {"loss": loss, "acc": acc}


class ModelBase:
    """Common plumbing; families override the layer stack."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)

    def kv_spec(self) -> KVSpec:
        raise NotImplementedError

    def init_cache(self, batch: int, seq: int, dtype=torch.bfloat16,
                   layout: str = LAYOUT_WINDOW) -> Cache:
        """Allocate a decode cache.  ``layout`` must be declared in
        ``kv_spec().layouts``."""
        spec = self.kv_spec()
        if layout not in spec.layouts:
            raise ValueError(
                f"family {spec.family!r} does not support cache layout "
                f"{layout!r} (declared layouts: {spec.layouts})")
        if spec.clamp_to_max_seq:
            seq = min(seq, self.cfg.max_seq)
        return self._build_cache(batch, seq, dtype, layout)

    def _build_cache(self, batch: int, seq: int, dtype, layout: str
                     ) -> Cache:
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> Dict:
        raise NotImplementedError

    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Next-token CE of batch["tokens"] against batch["targets"]
        (optional batch["mask"]), differentiable in ``params``.  -> (loss,
        {"loss", "acc"})."""
        raise NotImplementedError
