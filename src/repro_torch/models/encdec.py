"""Whisper-style encoder-decoder (audio frontend STUBBED).

Mirror of the JAX package's models/encdec.py: ``kv_spec``, ``init``,
``encode``, ``prefill`` (with ``frames``), ``decode_step`` and ``loss``.
The conv/mel frontend is a stub: the batch provides precomputed frame
embeddings ``frames`` (B, n_frames, d_model).  The encoder adds
sinusoidal positions and runs pre-LN self-attention blocks; the decoder
adds learned positions (capped at cfg.max_seq = 448), and runs causal
self-attention, cross-attention over the encoder output and a GELU MLP.

Attention: the decoder's causal self-attention in the prefill goes
through ``common.prefill_attention`` (``attn_density``'s served form on
the card: S <= 448, so never the flash form), with the density; the
encoder's unmasked attention and the cross-attention stay in the plain
``gqa_attention``, as the reference computes them; decode attends
through the plain ``decode_attention`` for self and cross, as the
reference does in jnp.  ``loss`` attends the decoder's self-attention
by ``gqa_attention`` under the causal mask, as the reference's
training forward does: it launches no kernel.

The KVSpec declares the family not servable (its prefill needs audio
frames), so ``LLMService`` refuses it as the reference's executor does.
Its dry-run batch (``batch_specs``) is the frames and the tokens and
targets clamped to ``max_seq``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common as C
from repro_torch.configs.base import ShapeSpec
from repro_torch.models.api import META, DecodeOut, ModelBase, PrefillOut
from repro_torch.models.dense import blockwise_ce
from repro_torch.models.kvspec import KVSpec


class EncDecModel(ModelBase):

    def kv_spec(self) -> KVSpec:
        cfg = self.cfg
        kv_dims = (cfg.n_heads, cfg.head_dim)   # MHA, not GQA
        return KVSpec(
            family=cfg.family,
            # decoder self-attn K/V is token-indexed; cross K/V derives
            # from the encoder output (audio) — a constant-size block
            # that cannot be rebuilt from decoder text
            seq_leaves=("k", "v"),
            leaf_dims={"k": kv_dims, "v": kv_dims},
            state_leaves=("xk", "xv"),
            servable=False,           # prefill needs audio frames
            chunkable=True,
            recomputable=False,
            batched_decode=False,
            quant_resident=False,
            paged=False,
            pipelined_restore=False,
            tolerance_class="kv",
            min_bits=8,
            clamp_to_max_seq=True,    # learned decoder positions: 448 cap
        )

    def init(self, generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on the model's device) in
        the reference's layout: projections bf16 N(0, 0.02^2) drawn one
        layer at a time, biases fp32 zeros, norms fp32 ones / zeros."""
        cfg, dev = self.cfg, self.device
        d, ff, H, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
        Le, Ld = cfg.encoder.n_layers, cfg.n_layers

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def attn_block(L):
            return {**C.init_stacked(generator, L, {
                "wq": (d, H * hd), "wk": (d, H * hd), "wv": (d, H * hd),
                "wo": (H * hd, d)}, dev),
                "bq": zeros(L, H * hd), "bv": zeros(L, H * hd),
                "bo": zeros(L, d)}

        def mlp_block(L):
            return {**C.init_stacked(generator, L, {"w1": (d, ff),
                                                    "w2": (ff, d)}, dev),
                    "b1": zeros(L, ff), "b2": zeros(L, d)}

        def norms(L, n):
            out = {}
            for i in range(n):
                out[f"ln{i}"] = torch.ones((L, d), dtype=torch.float32,
                                           device=dev)
                out[f"ln{i}_b"] = zeros(L, d)
            return out

        ones = torch.ones((d,), dtype=torch.float32, device=dev)
        return {
            "embed": C.init_linear(generator, (cfg.vocab, d), dev),
            "pos_dec": C.init_linear(generator, (cfg.max_seq, d), dev),
            "ln_enc": ones, "ln_enc_b": zeros(d),
            "ln_dec": ones.clone(), "ln_dec_b": zeros(d),
            "enc": {"attn": attn_block(Le), "mlp": mlp_block(Le),
                    **norms(Le, 2)},
            "dec": {"self": attn_block(Ld), "cross": attn_block(Ld),
                    "mlp": mlp_block(Ld), **norms(Ld, 3)},
        }

    def head_weight(self, params):
        return params["embed"].T          # whisper ties output to embedding

    # -- attention helpers ---------------------------------------------- #
    def _proj_qkv(self, pa, hq, hkv):
        cfg = self.cfg
        B, Sq, _ = hq.shape
        Sk = hkv.shape[1]
        H, hd = cfg.n_heads, cfg.head_dim
        q = (hq @ pa["wq"] + pa["bq"].to(hq.dtype)).reshape(B, Sq, H, hd)
        k = (hkv @ pa["wk"]).reshape(B, Sk, H, hd)
        v = (hkv @ pa["wv"] + pa["bv"].to(hkv.dtype)).reshape(B, Sk, H, hd)
        return q, k, v

    def _attn_out(self, pa, x, out):
        B, S = x.shape[:2]
        return x + (out.reshape(B, S, -1) @ pa["wo"]
                    + pa["bo"].to(x.dtype))

    def _mlp(self, pm, lns, lnb, x):
        h = C.layer_norm(x, lns, lnb, self.cfg.norm_eps)
        h = C.gelu_tanh(h @ pm["w1"] + pm["b1"].to(x.dtype))
        return x + (h @ pm["w2"] + pm["b2"].to(x.dtype))

    # -- encoder -------------------------------------------------------- #
    def encode(self, params, frames):
        """frames (B, n_frames, d) -> the encoder output (B, n_frames, d)
        bf16."""
        cfg = self.cfg
        x = frames.to(torch.bfloat16)
        S = x.shape[1]
        x = x + C.sinusoidal_positions(S, cfg.d_model, x.device
                                       ).to(x.dtype)[None]
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device)
        for i in range(cfg.encoder.n_layers):
            pl = C.layer_at(params["enc"], i)
            h = C.layer_norm(x, pl["ln0"], pl["ln0_b"], cfg.norm_eps)
            q, k, v = self._proj_qkv(pl["attn"], h, h)
            x = self._attn_out(pl["attn"], x,
                               C.gqa_attention(q, k, v, mask).out)
            x = self._mlp(pl["mlp"], pl["ln1"], pl["ln1_b"], x)
        return C.layer_norm(x, params["ln_enc"], params["ln_enc_b"],
                            cfg.norm_eps)

    # -- decoder (full sequence) ---------------------------------------- #
    def _dec_layer(self, pl, x, enc_out, positions, want_density=False,
                   train=False):
        """One decoder layer: causal self-attention (the prefill's through
        ``C.prefill_attention`` with the density as asked; with
        ``train`` the reference's ``gqa_attention`` under the causal mask,
        no kernel), cross-attention over ``enc_out`` and the MLP.  -> (x,
        {"k", "v", "xk", "xv", "density"})."""
        cfg = self.cfg
        h = C.layer_norm(x, pl["ln0"], pl["ln0_b"], cfg.norm_eps)
        q, k, v = self._proj_qkv(pl["self"], h, h)
        if train:
            mask = C.causal_window_mask(positions, positions)
            ao = C.gqa_attention(q, k, v, mask)
        else:
            ao = C.prefill_attention(q, k, v, positions,
                                     want_density=want_density)
        x = self._attn_out(pl["self"], x, ao.out)
        h = C.layer_norm(x, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
        qx, kx, vx = self._proj_qkv(pl["cross"], h, enc_out)
        maskx = torch.ones((x.shape[1], enc_out.shape[1]), dtype=torch.bool,
                           device=x.device)
        x = self._attn_out(pl["cross"], x,
                           C.gqa_attention(qx, kx, vx, maskx).out)
        x = self._mlp(pl["mlp"], pl["ln2"], pl["ln2_b"], x)
        return x, {"k": k, "v": v, "xk": kx, "xv": vx,
                   "density": ao.key_density}

    def _train_dec_layer(self, pl, x, enc_out, positions):
        return self._dec_layer(pl, x, enc_out, positions, train=True)[0]

    def _decode_full(self, params, tokens, enc_out, want_density=False,
                     train=False):
        """-> (x after the final norm, {"k", "v", "xk", "xv": (L, B, ., H,
        hd), "density": (L, B, S) as asked}).  ``train``: the training
        forward, one checkpoint a layer (no extras)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = params["embed"][tokens].to(torch.bfloat16)
        x = x + params["pos_dec"][:S].to(x.dtype)[None]
        positions = torch.arange(S, device=x.device)
        ys = {"k": [], "v": [], "xk": [], "xv": [], "density": []}
        for pl in C.unstack(params["dec"]):
            if train:
                x = C.checkpointed(self._train_dec_layer, pl, x, enc_out,
                                   positions)
                continue
            x, ex = self._dec_layer(pl, x, enc_out, positions, want_density)
            for n in ("k", "v", "xk", "xv"):
                ys[n].append(ex[n])
            if want_density:
                ys["density"].append(ex["density"])
        x = C.layer_norm(x, params["ln_dec"], params["ln_dec_b"],
                         cfg.norm_eps)
        return x, {n: torch.stack(t) for n, t in ys.items() if t}

    # -- entry points --------------------------------------------------- #
    def loss(self, params, batch):
        """Next-token CE of batch["tokens"] given batch["frames"]: the
        encoder (not rematerialised, as in the reference), the decoder
        with one checkpoint a layer, ``blockwise_ce``.  -> (loss,
        {"loss", "acc"})."""
        enc_out = self.encode(params, batch["frames"])
        x, _ = self._decode_full(params, batch["tokens"], enc_out,
                                 train=True)
        return blockwise_ce(x, self.head_weight(params), batch["targets"],
                            batch.get("mask"))

    def prefill(self, params, batch, want_density: bool = False,
                window: int = 0, n_sinks: int = 0) -> PrefillOut:
        """Encode batch["frames"] (B, n_frames, d), then the full-sequence
        decoder over batch["tokens"] (B, S <= max_seq).  ``window`` and
        ``n_sinks`` are ignored, as in the reference.  -> PrefillOut(
        logits (B, V) fp32, cache {"k", "v", "xk", "xv", "pos": S},
        density (B, S) averaged over the decoder layers | None)."""
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x, ys = self._decode_full(params, tokens, enc_out, want_density)
        logits = (x[:, -1] @ self.head_weight(params)).to(torch.float32)
        cache = {n: ys[n] for n in ("k", "v", "xk", "xv")}
        cache["pos"] = torch.tensor(tokens.shape[1], device=x.device)
        density = ys["density"].mean(dim=0) if want_density else None
        return PrefillOut(logits, cache, density)

    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token.  tokens (B, 1); cache from ``init_cache`` with the
        prefill's K/V and ``xk`` / ``xv``, and a 0-d ``pos`` < max_seq.
        Each layer writes its K/V into ``cache`` in place, attends over
        them and then over the encoder's K/V through ``decode_attention``.
        -> DecodeOut(logits (B, V) fp32, cache with pos + 1)[, a (B, 1)
        zero mass, as in the reference]."""
        cfg = self.cfg
        B = tokens.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        pos = cache["pos"]
        x = params["embed"][tokens].to(torch.bfloat16)
        x = x + params["pos_dec"][pos].to(x.dtype)
        n_frames = torch.tensor(cache["xk"].shape[2], device=x.device)
        for i in range(cfg.n_layers):
            pl = C.layer_at(params["dec"], i)
            h = C.layer_norm(x, pl["ln0"], pl["ln0_b"], cfg.norm_eps)
            q, k, v = self._proj_qkv(pl["self"], h, h)
            k_c = C.ring_update(cache["k"][i], k, pos)
            v_c = C.ring_update(cache["v"][i], v, pos)
            x = self._attn_out(pl["self"], x,
                               C.decode_attention(q, k_c, v_c, pos + 1))
            h = C.layer_norm(x, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
            pc = pl["cross"]
            qx = (h @ pc["wq"] + pc["bq"].to(h.dtype)).reshape(B, 1, H, hd)
            x = self._attn_out(pc, x, C.decode_attention(
                qx, cache["xk"][i], cache["xv"][i], n_frames))
            x = self._mlp(pl["mlp"], pl["ln2"], pl["ln2_b"], x)
        x = C.layer_norm(x, params["ln_dec"], params["ln_dec_b"],
                         cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(torch.float32)
        out = DecodeOut(logits, {**cache, "pos": pos + 1})
        if want_density:
            return out, torch.zeros((B, 1), dtype=torch.float32,
                                    device=x.device)
        return out

    def _build_cache(self, batch, seq, dtype, layout):
        cfg, dev = self.cfg, self.device
        # init_cache has clamped seq to max_seq (clamp_to_max_seq)
        L, H, hd = cfg.n_layers, cfg.n_heads, cfg.head_dim
        F = cfg.encoder.n_frames
        return {"k": torch.zeros((L, batch, seq, H, hd), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((L, batch, seq, H, hd), dtype=dtype,
                                 device=dev),
                "xk": torch.zeros((L, batch, F, H, hd), dtype=dtype,
                                  device=dev),
                "xv": torch.zeros((L, batch, F, H, hd), dtype=dtype,
                                  device=dev),
                "pos": torch.zeros((), dtype=torch.int64, device=dev)}

    def batch_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """Frames (B, n_frames, d_model) bf16 and tokens / targets
        clamped to ``max_seq``, on the meta device."""
        cfg = self.cfg
        B, T = shape.global_batch, min(shape.seq_len, cfg.max_seq)
        tok = torch.empty((B, T), dtype=torch.int32, device=META)
        return {"frames": torch.empty((B, cfg.encoder.n_frames, cfg.d_model),
                                      dtype=torch.bfloat16, device=META),
                "tokens": tok, "targets": tok}
