"""RecurrentGemma (Griffin) — RG-LRU recurrent blocks + local MQA, 1:2.

Mirror of the JAX package's models/rglru.py for inference: ``kv_spec``,
``init``, ``prefill`` and ``decode_step``.  Block pattern (rec, rec,
attn) repeating; 26 layers = 8 triples + 2 trailing recurrent layers.
Every block is followed by a GeGLU MLP.

RG-LRU recurrence (per channel):
    r_t = sigmoid(blockdiag(x_t; W_a))          recurrence gate
    i_t = sigmoid(blockdiag(x_t; W_x))          input gate
    log a_t = -c * softplus(lambda) * r_t       c = 8.0
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The prefill evaluates the linear recurrence in fp32 as a log-depth
parallel scan over the reference's associative operator (Hillis-Steele
doubling, ceil(log2 S) steps: the reference's ``associative_scan`` is
jnp, not Pallas, so this stays plain PyTorch); decode is the one-step
form.  Both take an incoming state h0.  The reference's decode applies
the causal conv's taps in the opposite order to its prefill
(``_rec_block_step`` against ``_rec_block_full``); the port keeps both
as they are (``ROADMAP.md`` Queue 3).

Attention layers use a 2048-token local window with a single KV head
(MQA), and pick their branch by the reference's own rule
(``_attn_block``): up to PREFILL_FULL_MAX_S tokens ``attn_density``'s
served form under the window, above it the flash form with the window
(on the card both are the CUDA kernel); decode attends through the
plain ``decode_attention`` with the window over a non-ring cache.
``loss`` (one checkpoint a (rec, rec, attn) triple, the two trailing
recurrent layers not, as in the reference) attends by the reference's
training rule: ``flash_attention`` with the window above
PREFILL_FULL_MAX_S tokens, ``gqa_attention`` under the window mask up
to it.

The KVSpec declares the family not servable, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common as C
from repro_torch.models.api import DecodeOut, ModelBase, PrefillOut
from repro_torch.models.dense import blockwise_ce
from repro_torch.models.kvspec import KVSpec

RG_C = 8.0


def _block_counts(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(n_rec, n_attn, n_triples, n_trailing_rec)."""
    pat = cfg.rglru.block_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.n_layers)]
    n_rec = sum(1 for k in kinds if k == "rec")
    n_attn = len(kinds) - n_rec
    n_triples = cfg.n_layers // 3
    n_trail = cfg.n_layers - 3 * n_triples
    assert n_trail in (0, 2), "pattern assumes rec,rec,attn triples"
    return n_rec, n_attn, n_triples, n_trail


def block_diag_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                     ) -> torch.Tensor:
    """x (..., w_total) fp32; w (nb, blk, blk); b (nb, blk) fp32 -> fp32
    (w widened to fp32, as the reference's einsum promotes it)."""
    nb, blk, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, blk)
    y = torch.einsum("...nk,nkj->...nj", xs, w.to(x.dtype)) + b
    return y.reshape(x.shape)


def linear_scan(a: torch.Tensor, b: torch.Tensor, axis: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along
    ``axis``: the reference's ``associative_scan`` over the operator
    ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), as Hillis-Steele
    doubling (element t combines with t - d for d = 1, 2, 4, ...).
    -> (the running product of a, h)."""
    a = a.movedim(axis, 0)
    b = b.movedim(axis, 0)
    d, S = 1, a.shape[0]
    while d < S:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[:-d] * a[d:]])
        d *= 2
    return a.movedim(0, axis), b.movedim(0, axis)


class RGLRUModel(ModelBase):

    def kv_spec(self) -> KVSpec:
        cfg = self.cfg
        kv_dims = (cfg.n_kv_heads, cfg.head_dim)
        return KVSpec(
            family=cfg.family,
            # hybrid: local-MQA K/V is token-indexed (leading axis is
            # n_attn, not n_layers, but the codec only slices along
            # TOKEN_AXIS); conv/lru recurrence is constant-size state
            seq_leaves=("k", "v"),
            leaf_dims={"k": kv_dims, "v": kv_dims},
            state_leaves=("conv", "lru"),
            servable=False,           # no incremental append entry yet
            chunkable=True,
            recomputable=False,
            batched_decode=False,
            quant_resident=False,
            paged=False,
            pipelined_restore=False,
            pad_safe=False,           # pads fold into the recurrence
            tolerance_class="state",
            min_bits=16,
        )

    def init(self, generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on the model's device) in
        the reference's layout: projections and gate blocks bf16 N(0,
        0.02^2) (the conv taps N(0, 0.1^2)) drawn one layer at a time;
        norms fp32 ones, biases fp32 zeros, lambda fp32 0.7."""
        cfg, dev = self.cfg, self.device
        g = cfg.rglru
        d, w, ff = cfg.d_model, g.lru_width, cfg.d_ff
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        n_rec, n_attn, _, _ = _block_counts(cfg)
        nb = H                               # block-diag groups for gates
        blk = w // nb

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=dev)

        conv_k = torch.empty((n_rec, g.conv_width, w), dtype=torch.bfloat16,
                             device=dev)
        rec = {"ln": full((n_rec, d), 1.0),
               **C.init_stacked(generator, n_rec, {"w_x": (d, w),
                                                   "w_gate": (d, w)}, dev)}
        for i in range(n_rec):
            conv_k[i] = C.init_linear(generator, (g.conv_width, w), dev, 0.1)
        rec.update({"conv_k": conv_k, "conv_b": full((n_rec, w), 0.0)})
        rec.update(C.init_stacked(generator, n_rec,
                                  {"gate_a_w": (nb, blk, blk)}, dev))
        rec["gate_a_b"] = full((n_rec, nb, blk), 0.0)
        rec.update(C.init_stacked(generator, n_rec,
                                  {"gate_x_w": (nb, blk, blk)}, dev))
        rec["gate_x_b"] = full((n_rec, nb, blk), 0.0)
        rec["lam"] = full((n_rec, w), 0.7)
        rec.update(C.init_stacked(generator, n_rec, {"w_out": (w, d)}, dev))
        attn = {"ln": full((n_attn, d), 1.0),
                **C.init_stacked(generator, n_attn, {
                    "wq": (d, H * hd), "wk": (d, KV * hd),
                    "wv": (d, KV * hd), "wo": (H * hd, d)}, dev)}
        mlp = {"ln": full((cfg.n_layers, d), 1.0),
               **C.init_stacked(generator, cfg.n_layers, {
                   "w_gate": (d, ff), "w_up": (d, ff),
                   "w_down": (ff, d)}, dev)}
        return {"embed": C.init_linear(generator, (cfg.vocab, d), dev),
                "ln_f": full((d,), 1.0), "rec": rec, "attn": attn,
                "mlp": mlp}

    def head_weight(self, params):
        return params["embed"].T            # gemma ties embeddings

    # -- pieces --------------------------------------------------------- #
    def _embed(self, params, tokens):
        """Embeddings times sqrt(d), the scale rounded to bf16 first (the
        reference's ``jnp.sqrt(jnp.bfloat16(d))``)."""
        scale = float(torch.tensor(float(np.sqrt(np.float32(
            self.cfg.d_model))), dtype=torch.bfloat16))
        return params["embed"][tokens].to(torch.bfloat16) * scale

    def _mlp(self, pm, x):
        h = C.rms_norm(x, pm["ln"], self.cfg.norm_eps)
        h = C.gelu_tanh(h @ pm["w_gate"]) * (h @ pm["w_up"])
        return x + h @ pm["w_down"]

    def _rglru_gates(self, pr, xc):
        """xc: conv output (..., w) -> (log_a, gated input), fp32."""
        xf = xc.to(torch.float32)
        r = C.sigmoid(block_diag_apply(xf, pr["gate_a_w"], pr["gate_a_b"]))
        i = C.sigmoid(block_diag_apply(xf, pr["gate_x_w"], pr["gate_x_b"]))
        softplus = torch.logaddexp(pr["lam"], torch.zeros_like(pr["lam"]))
        log_a = -RG_C * softplus * r
        beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                          1e-6))
        return log_a, beta * (i * xf)

    def _rec_block_full(self, pr, x, conv_state, h0):
        """Full-sequence recurrent block.  x (B,S,d); conv_state
        (B,cw-1,w); h0 (B,w) fp32.  -> (x', new conv_state, new h)."""
        cw = self.cfg.rglru.conv_width
        h = C.rms_norm(x, pr["ln"], self.cfg.norm_eps)
        xb = h @ pr["w_x"]                                     # (B,S,w)
        gate = C.gelu_tanh(h @ pr["w_gate"])
        # causal depthwise conv over time, seeded with conv_state
        ext = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
        S = xb.shape[1]
        xc = sum(ext[:, i:i + S] * pr["conv_k"][cw - 1 - i].to(xb.dtype)
                 for i in range(cw))
        xc = xc + pr["conv_b"].to(xb.dtype)
        new_conv = ext[:, ext.shape[1] - (cw - 1):]
        log_a, b = self._rglru_gates(pr, xc)                   # fp32
        a_cum, h_seq = linear_scan(torch.exp(log_a), b)
        h_seq = h_seq + a_cum * h0[:, None, :]
        y = (h_seq.to(x.dtype) * gate) @ pr["w_out"]
        return x + y, new_conv, h_seq[:, -1]

    def _rec_block_step(self, pr, x, conv_state, h0):
        """One-token recurrent block.  x (B,1,d)."""
        cw = self.cfg.rglru.conv_width
        h = C.rms_norm(x, pr["ln"], self.cfg.norm_eps)
        xb = h @ pr["w_x"]                                     # (B,1,w)
        gate = C.gelu_tanh(h @ pr["w_gate"])
        ext = torch.cat([conv_state.to(xb.dtype), xb], dim=1)
        taps = [ext[:, -(i + 1)] * pr["conv_k"][cw - 1 - i].to(xb.dtype)
                for i in range(cw)]
        xc = (sum(taps) + pr["conv_b"].to(xb.dtype))[:, None]
        log_a, b = self._rglru_gates(pr, xc)
        new_h = torch.exp(log_a[:, 0]) * h0 + b[:, 0]
        y = (new_h[:, None].to(x.dtype) * gate) @ pr["w_out"]
        return x + y, ext[:, 1:], new_h

    def _qkv(self, pa, x, positions):
        cfg = self.cfg
        h = C.rms_norm(x, pa["ln"], cfg.norm_eps)
        B, S, _ = x.shape
        q = (h @ pa["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = (h @ pa["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ pa["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        cos, sin = C.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        return C.apply_rope(q, cos, sin), C.apply_rope(k, cos, sin), v

    def _attn_block(self, pa, x, positions, want_density, train=False):
        """Full-sequence local attention under the window: the served
        form up to PREFILL_FULL_MAX_S tokens (the reference's
        gqa_attention under causal_window_mask), the flash form above
        (its flash_attention / blocked_causal_attention); with ``train``
        the reference's ``gqa_attention`` and ``flash_attention``
        themselves.  -> (x', k, v, density | None)."""
        B, S, _ = x.shape
        q, k, v = self._qkv(pa, x, positions)
        w = self.cfg.rglru.window
        if train and S > C.PREFILL_FULL_MAX_S:
            ao = C.AttnOut(C.flash_attention(q, k, v, 0, 1024, w, 0), None)
        elif train:
            mask = C.causal_window_mask(positions, positions, w)
            ao = C.gqa_attention(q, k, v, mask)
        else:
            form = "served" if S <= C.PREFILL_FULL_MAX_S else "flash"
            ao = C.prefill_attention(q, k, v, positions, window=w,
                                     want_density=want_density, form=form)
        x = x + ao.out.reshape(B, S, -1) @ pa["wo"]
        return x, k, v, ao.key_density

    # -- stacked forward ------------------------------------------------ #
    def _forward_full(self, params, tokens, want_density=False,
                      return_cache=False, state=None):
        """The blocks over tokens (B, S), from ``state`` = (conv0 (n_rec,
        B, cw-1, w) bf16, lru0 (n_rec, B, w) fp32) or zeros.  -> {"x"
        after the final norm, "conv", "lru", and "k", "v" (n_attn, B, S,
        KV, hd) / "density" (B, S) averaged over the attention layers as
        asked}."""
        cfg = self.cfg
        g = cfg.rglru
        n_rec, n_attn, n_tri, n_trail = _block_counts(cfg)
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        if state is None:
            conv0 = torch.zeros((n_rec, B, g.conv_width - 1, g.lru_width),
                                dtype=torch.bfloat16, device=x.device)
            lru0 = torch.zeros((n_rec, B, g.lru_width), dtype=torch.float32,
                               device=x.device)
        else:
            conv0, lru0 = state
        rec_p, attn_p, mlp_p = params["rec"], params["attn"], params["mlp"]
        convs, lrus, ks, vs, dens = [], [], [], [], []

        def rec(i_rec, i_mlp, x):
            x, cv, lr = self._rec_block_full(C.layer_at(rec_p, i_rec), x,
                                             conv0[i_rec], lru0[i_rec])
            convs.append(cv)
            lrus.append(lr)
            return self._mlp(C.layer_at(mlp_p, i_mlp), x)

        for t in range(n_tri):
            for j in range(2):
                x = rec(2 * t + j, 3 * t + j, x)
            x, k, v, d = self._attn_block(C.layer_at(attn_p, t), x,
                                          positions, want_density)
            x = self._mlp(C.layer_at(mlp_p, 3 * t + 2), x)
            ks.append(k)
            vs.append(v)
            dens.append(d)
        for t in range(n_trail):
            x = rec(2 * n_tri + t, 3 * n_tri + t, x)
        out = {"x": C.rms_norm(x, params["ln_f"], cfg.norm_eps),
               "conv": torch.stack(convs), "lru": torch.stack(lrus)}
        if return_cache:
            out["k"], out["v"] = torch.stack(ks), torch.stack(vs)
        if want_density:
            out["density"] = torch.stack(dens).mean(dim=0)
        return out

    def _train_triple(self, prs, pa, pms, x, conv0, lru0, positions):
        """One (rec, rec, attn) triple of the training forward, each
        block followed by its MLP, from zero recurrent states."""
        for pr, pm in zip(prs, pms):
            x = self._mlp(pm, self._rec_block_full(pr, x, conv0, lru0)[0])
        x = self._attn_block(pa, x, positions, False, train=True)[0]
        return self._mlp(pms[2], x)

    # -- entry points --------------------------------------------------- #
    def loss(self, params, batch):
        """Next-token CE of batch["tokens"] (B, S) from zero states
        (``blockwise_ce``): one checkpoint a triple, the trailing
        recurrent layers outside any.  -> (loss, {"loss", "acc"})."""
        cfg, g = self.cfg, self.cfg.rglru
        _, _, n_tri, n_trail = _block_counts(cfg)
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(S, device=x.device)
        conv0 = torch.zeros((B, g.conv_width - 1, g.lru_width),
                            dtype=torch.bfloat16, device=x.device)
        lru0 = torch.zeros((B, g.lru_width), dtype=torch.float32,
                           device=x.device)
        rec, attn, mlp = (C.unstack(params[n]) for n in ("rec", "attn", "mlp"))
        for t in range(n_tri):
            x = C.checkpointed(self._train_triple, rec[2 * t:2 * t + 2],
                               attn[t], mlp[3 * t:3 * t + 3], x, conv0,
                               lru0, positions)
        for t in range(n_trail):
            x = self._rec_block_full(rec[2 * n_tri + t], x, conv0, lru0)[0]
            x = self._mlp(mlp[3 * n_tri + t], x)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return blockwise_ce(x, self.head_weight(params), batch["targets"],
                            batch.get("mask"))

    def prefill(self, params, batch, want_density: bool = False,
                window: int = 0, n_sinks: int = 0) -> PrefillOut:
        """Full-sequence prefill of batch["tokens"] (B, S).  ``window``
        and ``n_sinks`` are ignored: the attention layers take the
        config's window, as in the reference.  -> PrefillOut(logits (B,
        V) fp32, cache {"k", "v", "conv", "lru", "pos": S}, density (B,
        S) | None)."""
        tokens = batch["tokens"]
        out = self._forward_full(params, tokens, want_density=want_density,
                                 return_cache=True)
        logits = (out["x"][:, -1] @ self.head_weight(params)).to(
            torch.float32)
        cache = {n: out[n] for n in ("k", "v", "conv", "lru")}
        cache["pos"] = torch.tensor(tokens.shape[1], device=logits.device)
        return PrefillOut(logits, cache, out.get("density"))

    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token.  tokens (B, 1); cache from ``init_cache`` (or a
        prefill's state leaves with its K/V copied in) and a 0-d ``pos``.
        The attention layers write their K/V into ``cache`` in place and
        attend through ``decode_attention`` under the config's window;
        the recurrent layers return new conv / lru state.  -> DecodeOut(
        logits (B, V) fp32, cache with pos + 1)[, a (B, 1) zero mass:
        the density is tracked at prefill granularity, as in the
        reference]."""
        cfg = self.cfg
        n_rec, n_attn, n_tri, n_trail = _block_counts(cfg)
        x = self._embed(params, tokens)
        pos = cache["pos"]
        positions = pos[None]
        rec_p, attn_p, mlp_p = params["rec"], params["attn"], params["mlp"]
        cv, lr = cache["conv"], cache["lru"]
        convs, lrus = [], []

        def rec(i_rec, i_mlp, x):
            x, c2, l2 = self._rec_block_step(C.layer_at(rec_p, i_rec), x,
                                             cv[i_rec], lr[i_rec])
            convs.append(c2)
            lrus.append(l2)
            return self._mlp(C.layer_at(mlp_p, i_mlp), x)

        for t in range(n_tri):
            for j in range(2):
                x = rec(2 * t + j, 3 * t + j, x)
            pa = C.layer_at(attn_p, t)
            q, k, v = self._qkv(pa, x, positions)
            k_c = C.ring_update(cache["k"][t], k, pos)
            v_c = C.ring_update(cache["v"][t], v, pos)
            out = C.decode_attention(q, k_c, v_c, pos + 1,
                                     window=cfg.rglru.window)
            x = x + out.reshape(*x.shape[:2], -1) @ pa["wo"]
            x = self._mlp(C.layer_at(mlp_p, 3 * t + 2), x)
        for t in range(n_trail):
            x = rec(2 * n_tri + t, 3 * n_tri + t, x)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(torch.float32)
        out = DecodeOut(logits, {**cache, "conv": torch.stack(convs),
                                 "lru": torch.stack(lrus), "pos": pos + 1})
        if want_density:
            return out, torch.zeros((tokens.shape[0], 1),
                                    dtype=torch.float32, device=x.device)
        return out

    def _build_cache(self, batch, seq, dtype, layout):
        cfg, dev = self.cfg, self.device
        g = cfg.rglru
        n_rec, n_attn, _, _ = _block_counts(cfg)
        shape = (n_attn, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "conv": torch.zeros((n_rec, batch, g.conv_width - 1,
                                     g.lru_width), dtype=torch.bfloat16,
                                    device=dev),
                "lru": torch.zeros((n_rec, batch, g.lru_width),
                                   dtype=torch.float32, device=dev),
                "pos": torch.zeros((), dtype=torch.int64, device=dev)}
