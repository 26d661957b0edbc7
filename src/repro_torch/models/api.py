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
tests pass ``device="cpu"``.  A model built for ``"meta"`` allocates
nothing: ``init`` and ``init_cache`` give tensors with a shape and a
dtype only, the port's counterpart of ``jax.eval_shape``, and the
dry-run specs (``batch_specs``, ``cache_specs``, ``input_specs``) are
such tensors whatever device the model was built for.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.kvspec import KVSpec, LAYOUT_WINDOW

Cache = Dict[str, Any]
META = torch.device("meta")


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

    # -- dry-run specs ------------------------------------------------- #
    def batch_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Meta stand-ins for the data batch of ``shape``: int32 tokens
        and targets (global_batch, clamp_seq(seq_len))."""
        B, S = shape.global_batch, self.clamp_seq(shape.seq_len)
        tok = torch.empty((B, S), dtype=torch.int32, device=META)
        return {"tokens": tok, "targets": tok}

    def clamp_seq(self, seq: int) -> int:
        if self.kv_spec().clamp_to_max_seq:
            return min(seq, self.cfg.max_seq)
        return seq

    def decode_seq(self, shape: ShapeSpec) -> int:
        return self.clamp_seq(shape.seq_len)

    def cache_specs(self, shape: ShapeSpec, dtype=torch.bfloat16) -> Cache:
        """The decode cache of ``shape`` on the meta device (allocates
        nothing)."""
        meta = type(self)(self.cfg, META)
        return meta.init_cache(shape.global_batch, self.decode_seq(shape),
                               dtype)

    def input_specs(self, shape: ShapeSpec) -> Tuple[str, Dict[str, Any]]:
        """(entry point name, its keyword arguments as meta tensors) for
        the dry run."""
        if shape.kind == "train":
            return "train", dict(batch=self.batch_specs(shape))
        if shape.kind == "prefill":
            b = self.batch_specs(shape)
            b.pop("targets")
            return "prefill", dict(batch=b)
        # decode: one new token against a seq_len-deep cache
        return "decode", dict(
            tokens=torch.empty((shape.global_batch, 1), dtype=torch.int32,
                               device=META),
            cache=self.cache_specs(shape))

    # -- streaming (paper section 4: sliding window + attention sinks) - #
    def streaming_window(self, shape: ShapeSpec) -> Tuple[int, int]:
        """(window, n_sinks) for ``shape``; (0, 0) = full attention."""
        cfg = self.cfg
        if shape.name == "long_500k" and self.kv_spec().streaming_long:
            return 8192, cfg.n_sink_tokens
        if cfg.sliding_window:
            return cfg.sliding_window, cfg.n_sink_tokens
        return 0, 0
