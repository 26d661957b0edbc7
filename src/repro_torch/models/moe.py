"""MoE decoder-only transformer (llama4-maverick family).

Mirror of the JAX package's models/moe.py: the dense attention stack
(GQA + RoPE) with every FFN replaced by a routed MoE (top-1 over 128
experts for llama4) plus one always-on shared expert (``moe_layer.py``).
Every other entry is ``DenseModel``'s: window and mixed caches,
``prefill``, ``decode_step`` (batched too), ``recompute``, ``loss``;
only ``kv_spec``, ``init`` and ``_ffn`` change.

The KVSpec is dense's with no restore recompute, no paged pool and no
pipelined restore: recompute replays expert routing, so restores are
all I/O, a chunk that cannot be read counts ``recover_failed`` and
raises, and the service serves on slot caches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.models.dense import DenseModel
from repro_torch.models.kvspec import KVSpec
from repro_torch.models.moe_layer import init_moe_params, moe_residual


class MoEModel(DenseModel):

    def kv_spec(self) -> KVSpec:
        # dense attention cache, but recompute replays expert routing:
        # too expensive for restore planning / paged recovery
        return dataclasses.replace(super().kv_spec(),
                                   recomputable=False, paged=False,
                                   pipelined_restore=False)

    def init(self, generator: torch.Generator) -> Dict:
        """The dense stack without its FFN, then the MoE leaves
        (``init_moe_params``, one expert at a time) from the same
        ``generator``."""
        cfg = self.cfg
        params = super().init(generator, ffn=False)
        params["layers"].update(init_moe_params(
            generator, cfg.d_model, cfg.moe, self.device,
            n_layers=cfg.n_layers))
        return params

    def _ffn(self, pl, x):
        return moe_residual(pl, x, self.cfg)
