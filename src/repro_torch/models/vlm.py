"""Llama-3.2-Vision style VLM: dense text backbone with tanh-gated
cross-attention layers every ``cross_attn_every`` layers.

Mirror of the JAX package's models/vlm.py: ``kv_spec``, ``init``,
``prefill`` (with ``patches``), ``decode_step`` and ``loss`` (one
checkpoint a block of self layers and its cross layer, as the
reference's).  The vision tower is a STUB: the batch provides
precomputed patch embeddings ``patches`` (B, n_image_tokens,
d_vision); the model owns only the projector and the cross-attention
layers.

Layer layout (100 layers, cross every 5th): 20 blocks of [4 self-attn
layers -> 1 gated cross-attn layer].  The self layers are the dense
layers (``DenseModel._layer_full`` in the prefill, so its causal
attention runs through ``attn_density`` on the card; the plain
``decode_attention`` over the window cache in decode).  A cross layer
attends, unmasked and in plain PyTorch as the reference computes it
(``gqa_attention``), over the image tokens' K/V ``xk`` / ``xv``, which
the prefill builds and the cache carries.

The KVSpec declares the family not servable: its prefill needs
patches, so there is no text-only extend and ``LLMService`` refuses
it (as the reference's executor does).  Its dry-run batch
(``batch_specs``) carries the patches beside the tokens.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common as C
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.api import META, DecodeOut, PrefillOut
from repro_torch.models.dense import DenseModel, blockwise_ce
from repro_torch.models.kvspec import KVSpec


class VLMModel(DenseModel):

    def kv_spec(self) -> KVSpec:
        cfg = self.cfg
        kv_dims = (cfg.n_kv_heads, cfg.head_dim)
        return KVSpec(
            family=cfg.family,
            # self-attn K/V is token-indexed and chunkable; the
            # cross-attn image blocks (xk/xv) are constant-size state —
            # derived from image embeddings, NOT recomputable from text
            seq_leaves=("k", "v"),
            leaf_dims={"k": kv_dims, "v": kv_dims},
            state_leaves=("xk", "xv"),
            servable=False,           # prefill needs patches: no text-only
            chunkable=True,           # recompute/extend path in the executor
            recomputable=False,
            batched_decode=False,
            quant_resident=False,
            paged=False,
            pipelined_restore=False,
            # image-conditioned chunks carry no cross-head redundancy
            # the Eq.-3 planner can exploit: floor at 8-bit
            tolerance_class="image",
            min_bits=8,
            int8_serving=True,
            streaming_long=True,
        )

    def _counts(self):
        """-> (self layers, cross layers, self layers a block)."""
        every = self.cfg.vision.cross_attn_every
        n_cross = self.cfg.n_layers // every
        return self.cfg.n_layers - n_cross, n_cross, every - 1

    def init(self, generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on the model's device), in
        the reference's layout: norms fp32 ones, the cross layers'
        tanh gates fp32 zeros (a fresh model's cross layers add
        nothing), every projection bf16 N(0, 0.02^2) drawn one layer at
        a time."""
        cfg, dev = self.cfg, self.device
        n_self, n_cross, _ = self._counts()
        d, H, KV, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, cfg.d_ff)
        attn = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                "wo": (H * hd, d)}
        ffn = {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}

        def ones(n, w):
            return torch.ones((n, w), dtype=torch.float32, device=dev)

        self_layers = {"ln_attn": ones(n_self, d), "ln_ffn": ones(n_self, d),
                       **C.init_stacked(generator, n_self, {**attn, **ffn},
                                        dev)}
        cross_layers = {
            "ln_attn": ones(n_cross, d), "ln_ffn": ones(n_cross, d),
            **C.init_stacked(generator, n_cross, attn, dev),
            "q_norm": ones(n_cross, hd), "k_norm": ones(n_cross, hd),
            "gate_attn": torch.zeros((n_cross,), dtype=torch.float32,
                                     device=dev),
            "gate_ffn": torch.zeros((n_cross,), dtype=torch.float32,
                                    device=dev),
            **C.init_stacked(generator, n_cross, ffn, dev)}
        return {
            "embed": C.init_linear(generator, (cfg.vocab, d), dev),
            "head": C.init_linear(generator, (d, cfg.vocab), dev),
            "ln_f": torch.ones((d,), dtype=torch.float32, device=dev),
            "projector": C.init_linear(generator,
                                       (cfg.vision.d_vision, d), dev),
            "self_layers": self_layers,
            "cross_layers": cross_layers,
        }

    # -- cross-attention layer ------------------------------------------ #
    def _cross_kv(self, pc, img):
        """img (B, I, d) projected patches -> K (rms-normed), V (B, I, KV,
        hd)."""
        cfg = self.cfg
        B, I, _ = img.shape
        k = (img @ pc["wk"]).reshape(B, I, cfg.n_kv_heads, cfg.head_dim)
        v = (img @ pc["wv"]).reshape(B, I, cfg.n_kv_heads, cfg.head_dim)
        return C.rms_norm(k, pc["k_norm"], cfg.norm_eps), v

    def _cross_layer(self, pc, x, xk, xv):
        """x + tanh(gate_attn) * (unmasked attention of rms-normed
        queries over the image K/V) @ wo, then x + tanh(gate_ffn) *
        SwiGLU.  Over int8 ``xk`` / ``xv`` the attention's out is int8
        and the product with ``wo`` promotes it to bf16, as in the
        reference."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = C.rms_norm(x, pc["ln_attn"], cfg.norm_eps)
        q = (h @ pc["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        q = C.rms_norm(q, pc["q_norm"], cfg.norm_eps)
        mask = torch.ones((S, xk.shape[1]), dtype=torch.bool,
                          device=x.device)
        ao = C.gqa_attention(q, xk, xv, mask)
        x = x + torch.tanh(pc["gate_attn"]).to(x.dtype) * (
            ao.out.reshape(B, S, -1).to(pc["wo"].dtype) @ pc["wo"])
        h = C.rms_norm(x, pc["ln_ffn"], cfg.norm_eps)
        y = C.swiglu(h, pc["w_gate"], pc["w_up"], pc["w_down"])
        return x + torch.tanh(pc["gate_ffn"]).to(x.dtype) * y

    # -- stacked forward ------------------------------------------------ #
    def _train_block(self, pss, pc, x, img, positions, window, n_sinks):
        """One block of the training forward: its self layers (the
        dense training layer) and its gated cross layer."""
        for pl in pss:
            x = self._train_layer(pl, x, positions, window, n_sinks)
        return self._cross_layer(pc, x, *self._cross_kv(pc, img))

    def _forward_full(self, params, tokens, patches, *, window=0, n_sinks=0,
                      want_density=False, return_kv=False, train=False):
        """The blocks over tokens (B, S) and patches (B, I, d_vision).
        -> (x after the final norm, {"k", "v": (n_self, B, S, KV, hd),
        "xk", "xv": (n_cross, B, I, KV, hd), "density": (n_self, B, S)}
        as asked).  ``train``: the training forward, one checkpoint a
        block (no extras)."""
        n_self, n_cross, per = self._counts()
        x = params["embed"][tokens].to(torch.bfloat16)
        img = patches.to(torch.bfloat16) @ params["projector"]
        positions = torch.arange(tokens.shape[1], device=x.device)
        if train:
            ps = C.unstack(params["self_layers"])
            for c, pc in enumerate(C.unstack(params["cross_layers"])):
                x = C.checkpointed(self._train_block,
                                   ps[c * per:(c + 1) * per], pc, x, img,
                                   positions, window, n_sinks)
            return C.rms_norm(x, params["ln_f"], self.cfg.norm_eps), {}
        ys = {"k": [], "v": [], "xk": [], "xv": [], "density": []}
        for c in range(n_cross):
            for j in range(per):
                pl = C.layer_at(params["self_layers"], c * per + j)
                x, ex = self._layer_full(pl, x, positions, window, n_sinks,
                                         want_density, return_kv)
                for k, val in ex.items():
                    ys[k].append(val)
            pc = C.layer_at(params["cross_layers"], c)
            xk, xv = self._cross_kv(pc, img)
            x = self._cross_layer(pc, x, xk, xv)
            if return_kv:
                ys["xk"].append(xk)
                ys["xv"].append(xv)
        x = C.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x, {k: torch.stack(v) for k, v in ys.items() if v}

    # -- entry points --------------------------------------------------- #
    def loss(self, params, batch):
        """Next-token CE of batch["tokens"] given batch["patches"]
        (``blockwise_ce``).  -> (loss, {"loss", "acc"})."""
        x, _ = self._forward_full(params, batch["tokens"], batch["patches"],
                                  train=True)
        return blockwise_ce(x, self.head_weight(params), batch["targets"],
                            batch.get("mask"))

    def prefill(self, params, batch, want_density: bool = False,
                window: int = 0, n_sinks: int = 0) -> PrefillOut:
        """Full-sequence prefill of batch["tokens"] (B, S) with
        batch["patches"] (B, I, d_vision).  -> PrefillOut(logits (B, V)
        fp32, cache {"k", "v", "xk", "xv", "pos": S}, density (B, S)
        averaged over the self layers | None)."""
        tokens = batch["tokens"]
        x, ys = self._forward_full(params, tokens, batch["patches"],
                                   window=window, n_sinks=n_sinks,
                                   want_density=want_density,
                                   return_kv=True)
        logits = (x[:, -1] @ self.head_weight(params)).to(torch.float32)
        cache = {n: ys[n] for n in ("k", "v", "xk", "xv")}
        cache["pos"] = torch.tensor(tokens.shape[1], device=x.device)
        density = ys["density"].mean(dim=0) if want_density else None
        return PrefillOut(logits, cache, density)

    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token.  tokens (B, 1); cache window layout (``init_cache``
        with the prefill's ``xk`` / ``xv``) and a 0-d ``pos``.  The self
        layers write their K/V into ``cache`` in place and attend through
        ``decode_attention``; the cross layers attend over the carried
        image K/V.  Over the int8 cache (no scales) every step follows
        the reference's dtype flow: K/V written by ``C.to_int8``, p cast
        to int8, the int8 p.v product wrapped mod 256, the int8 out
        promoted to bf16 by ``wo``.  -> DecodeOut(logits (B, V) fp32,
        cache with pos + 1) [, a (B, 1) zero mass: the density is
        tracked at prefill granularity, as in the reference]."""
        cfg = self.cfg
        n_self, n_cross, per = self._counts()
        x = params["embed"][tokens].to(torch.bfloat16)           # (B, 1, d)
        pos = cache["pos"]
        positions = pos[None]
        for c in range(n_cross):
            for j in range(per):
                l = c * per + j
                pl = C.layer_at(params["self_layers"], l)
                h = C.rms_norm(x, pl["ln_attn"], cfg.norm_eps)
                q, k, v = self._qkv(pl, h)
                q, k = self._rope(q, k, positions)
                k_c = C.ring_update(cache["k"][l], k, pos)
                v_c = C.ring_update(cache["v"][l], v, pos)
                out = C.decode_attention(q, k_c, v_c, pos + 1,
                                         window=window, n_sinks=n_sinks)
                x = x + out.reshape(*x.shape[:2], -1).to(
                    pl["wo"].dtype) @ pl["wo"]
                x = self._ffn(pl, x)
            x = self._cross_layer(C.layer_at(params["cross_layers"], c), x,
                                  cache["xk"][c], cache["xv"][c])
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(torch.float32)
        out = DecodeOut(logits, {**cache, "pos": pos + 1})
        if want_density:
            return out, torch.zeros((tokens.shape[0], 1),
                                    dtype=torch.float32, device=x.device)
        return out

    def _build_cache(self, batch, seq, dtype, layout):
        cfg, dev = self.cfg, self.device
        n_self, n_cross, _ = self._counts()
        shape = (n_self, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        xshape = (n_cross, batch, cfg.vision.n_image_tokens, cfg.n_kv_heads,
                  cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "xk": torch.zeros(xshape, dtype=dtype, device=dev),
                "xv": torch.zeros(xshape, dtype=dtype, device=dev),
                "pos": torch.zeros((), dtype=torch.int64, device=dev)}

    def batch_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """The dense batch plus the patch embeddings (B, n_image_tokens,
        d_vision) bf16, on the meta device."""
        cfg = self.cfg
        specs = super().batch_specs(shape)
        specs["patches"] = torch.empty(
            (shape.global_batch, cfg.vision.n_image_tokens,
             cfg.vision.d_vision), dtype=torch.bfloat16, device=META)
        return specs
