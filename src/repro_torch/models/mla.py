"""DeepSeek-V2 style Multi-head Latent Attention + MoE (deepseek-v2-lite).

Mirror of the JAX package's models/mla.py: ``kv_spec``, ``init``, the
full-sequence ``prefill`` (``_layer_full`` under the dense ``prefill``;
its cache is {"ckv", "kpe", "pos"}) and ``loss`` (dense's, over MLA's
``_layer_full`` with the training attention rule), ``decode_step``
(window and mixed caches) and the interleaved-chunk ``recompute``
(paper Fig. 7; also the chunked prefill-append).  MLA caches one compressed latent per token — ``ckv``
(kv_lora_rank) plus a shared roped key ``kpe`` (qk_rope_head_dim) —
instead of per-head K/V.  Decode uses the **absorbed** form (q folded
through W_uk, attention runs against the rank-r latent directly, with
torch einsums as the reference computes it with ``jnp.einsum``);
``recompute`` up-projects the latent to per-head K (nope + rope) and V
and attends through ``C.extend_attention`` (``prefill``: through
``C.prefill_attention``): the ``attn_density`` CUDA kernel on the card,
at query/key head dim nope + rope and value head dim ``v_head_dim``.  The FFN is the MoE layer (``moe_layer.py``).

The mixed layout is the quant-resident working cache: bf16 ``ckv`` /
``kpe`` plus int8 ``ckv_q`` / ``kpe_q`` with one fp32 scale per (token,
layer) over the whole rank vector, selected per position by
``quant_mask``.  As in the port's dense family, entries write the new
latents IN PLACE into the cache tensors they are given, and the
reference's layer ``scan`` is a Python loop.

The family serves only on the slot engine: its ``KVSpec`` declares no
paged pool, no batched decode and no pipelined restore, and those
entries raise.  ``prefill`` is not on the serving path: the reference's
tests and callers use it, and so do the port's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import common as C
from repro_torch.models.api import DecodeOut
from repro_torch.models.dense import DenseModel, _layer
from repro_torch.models.kvspec import KVSpec, LAYOUT_MIXED, LAYOUT_WINDOW
from repro_torch.models.moe_layer import init_moe_params, moe_residual

# mixed-precision (quant-resident) latent leaves: int8 codes + per-
# (token, layer) scales over the whole rank vector, riding along the
# bf16 window exactly like dense's k_q/v_q tier
_LATENT_QUANT_LEAVES = ("ckv_q", "kpe_q", "ckv_scale", "kpe_scale")


def _latent_select(c: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                   qm0: torch.Tensor) -> torch.Tensor:
    """Per-position select between the bf16 window and the dequantized
    int8 resident segment.  c (B,S,r) bf16; q (B,S,r) int8; s (B,S)
    fp32; qm0 (B,S) bool.  Matches the residency dequantize path bit
    for bit at 8-bit (codes * scale in fp32, rounded once to c.dtype)."""
    deq = (q.to(torch.float32) * s[..., None]).to(c.dtype)
    return torch.where(qm0[..., None], deq, c)


class MLAModel(DenseModel):

    def kv_spec(self) -> KVSpec:
        cfg, m = self.cfg, self.cfg.mla
        return KVSpec(
            family=cfg.family,
            seq_leaves=("ckv", "kpe"),
            leaf_dims={"ckv": (m.kv_lora_rank,),
                       "kpe": (m.qk_rope_head_dim,)},
            servable=True,
            chunkable=True,
            recomputable=True,
            batched_decode=False,
            quant_resident=True,
            paged=False,
            pipelined_restore=False,
            layouts=(LAYOUT_WINDOW, LAYOUT_MIXED),
            # the rank-r latent carries no cross-head redundancy: the
            # Eq.-3 planner stops at 8-bit (where dense K/V may drop to
            # 4/2), so every swapped chunk is quant-resident eligible
            tolerance_class="latent",
            min_bits=8,
            streaming_long=True,
        )

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on the model's device),
        N(0, 0.02^2) in bf16 as the reference's ``init``, drawn one
        layer at a time."""
        cfg, dev = self.cfg, self.device
        m, moe = cfg.mla, cfg.moe
        d, H, L = cfg.d_model, cfg.n_heads, cfg.n_layers
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        shapes = {
            "wq": (d, H * qk_hd),
            "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "w_uk": (m.kv_lora_rank, H * m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
            "wo": (H * m.v_head_dim, d),
        }
        ones = {"ln_attn": d, "ln_ffn": d, "ln_kv": m.kv_lora_rank}
        layers = {n: torch.ones((L, w), dtype=torch.float32, device=dev)
                  for n, w in ones.items()}
        layers.update(C.init_stacked(generator, L, shapes, dev))
        layers.update(init_moe_params(generator, d, moe, dev, n_layers=L))
        return {
            "embed": C.init_linear(generator, (cfg.vocab, d), dev),
            "head": C.init_linear(generator, (d, cfg.vocab), dev),
            "ln_f": torch.ones((d,), dtype=torch.float32, device=dev),
            "layers": layers,
        }

    def _ffn(self, pl, x):
        return moe_residual(pl, x, self.cfg)

    # -- latent computation shared by decode / recompute ---------------- #
    def _latents(self, pl, h, positions):
        """h (B,S,d) -> (ckv (B,S,rank), kpe (B,S,rope)) roped."""
        m = self.cfg.mla
        kv = h @ pl["w_dkv"]
        ckv, kpe = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
        ckv = C.rms_norm(ckv, pl["ln_kv"], self.cfg.norm_eps)
        cos, sin = C.rope_angles(positions, m.qk_rope_head_dim,
                                 self.cfg.rope_theta)
        kpe = C.apply_rope(kpe[..., None, :], cos, sin)[..., 0, :]
        return ckv, kpe

    def _queries(self, pl, h, positions):
        """h (B,S,d) -> (q_nope (B,S,H,nope), q_pe (B,S,H,rope) roped)."""
        m, cfg = self.cfg.mla, self.cfg
        B, S, _ = h.shape
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        q = (h @ pl["wq"]).reshape(B, S, cfg.n_heads, qk_hd)
        q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
        cos, sin = C.rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
        return q_nope, C.apply_rope(q_pe, cos, sin)

    def _expand_kv(self, pl, ckv, kpe):
        """Latent -> per-head K (nope + rope) (B,S,H,nope+rope) and V
        (B,S,H,v).  ckv (B,S,rank); kpe (B,S,rope)."""
        m, H = self.cfg.mla, self.cfg.n_heads
        B, S, _ = ckv.shape
        k_nope = (ckv @ pl["w_uk"]).reshape(B, S, H, m.qk_nope_head_dim)
        v = (ckv @ pl["w_uv"]).reshape(B, S, H, m.v_head_dim)
        kpe_h = kpe[:, :, None, :].expand(B, S, H, m.qk_rope_head_dim)
        k = torch.cat([k_nope, kpe_h.to(k_nope.dtype)], dim=-1)
        return k, v

    # -- full-sequence layer (train / prefill) ------------------------- #
    def _layer_full(self, pl, x, positions, window, n_sinks, want_density,
                    return_kv, train=False):
        """One layer over the whole sequence: per-head K (nope + rope)
        and V up-projected from the latents, causal attention through
        ``C.prefill_attention`` at head dims nope + rope / v, or with
        ``train`` by the reference's training branches
        (``C.train_attention``, dense's rule).  -> (x, {"density", "ckv",
        "kpe"} as asked)."""
        h = C.rms_norm(x, pl["ln_attn"], self.cfg.norm_eps)
        q_nope, q_pe = self._queries(pl, h, positions)
        q = torch.cat([q_nope, q_pe], dim=-1)
        ckv, kpe = self._latents(pl, h, positions)
        k, v = self._expand_kv(pl, ckv, kpe)
        if train:
            ao = C.AttnOut(C.train_attention(q, k, v, positions, window,
                                             n_sinks), None)
        else:
            ao = C.prefill_attention(q, k, v, positions, window, n_sinks,
                                     want_density)
        x = x + ao.out.reshape(*x.shape[:2], -1) @ pl["wo"]
        x = self._ffn(pl, x)
        extras = {}
        if want_density:
            extras["density"] = ao.key_density
        if return_kv:
            extras["ckv"], extras["kpe"] = ckv, kpe
        return x, extras

    def _build_cache(self, batch, seq, dtype, layout):
        cfg, m, dev = self.cfg, self.cfg.mla, self.device
        L = cfg.n_layers
        cache = {
            "ckv": torch.zeros((L, batch, seq, m.kv_lora_rank), dtype=dtype,
                               device=dev),
            "kpe": torch.zeros((L, batch, seq, m.qk_rope_head_dim),
                               dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int64, device=dev),
        }
        if layout == LAYOUT_MIXED:
            # bf16 latent window + int8 quant-resident segments with
            # per-(token, layer) scales over the whole rank vector,
            # selected by quant_mask (leading axis of 1: axis 1 stays
            # the batch axis on every leaf)
            for n in ("ckv", "kpe"):
                cache[n + "_q"] = torch.zeros(cache[n].shape,
                                              dtype=torch.int8, device=dev)
                cache[n + "_scale"] = torch.zeros((L, batch, seq),
                                                  dtype=torch.float32,
                                                  device=dev)
            cache["quant_mask"] = torch.zeros((1, batch, seq),
                                              dtype=torch.bool, device=dev)
        return cache

    def _attended(self, cache, l: int, qm):
        """Layer l's latents as attention reads them: the mixed cache's
        select of the bf16 window and the int8 segments, else the bf16
        latents themselves."""
        ckv_c, kpe_c = cache["ckv"][l], cache["kpe"][l]
        if qm is None:
            return ckv_c, kpe_c
        return (_latent_select(ckv_c, cache["ckv_q"][l],
                               cache["ckv_scale"][l], qm[0]),
                _latent_select(kpe_c, cache["kpe_q"][l],
                               cache["kpe_scale"][l], qm[0]))

    @staticmethod
    def _carry(new_cache, cache, qm):
        """The mixed cache's int8 leaves ride along unwritten."""
        if qm is not None:
            for n in _LATENT_QUANT_LEAVES:
                new_cache[n] = cache[n]
            new_cache["quant_mask"] = qm
        return new_cache

    # -- absorbed decode ------------------------------------------------ #
    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token.  tokens (B, 1); cache window or mixed layout with a
        0-d ``pos``.  Writes the new latents into ``cache`` in place.
        Attention runs in the absorbed form: q_abs = q_nope W_uk (bf16),
        fp32 scores against the latent (ckv) and the shared roped key
        (kpe) times 1/sqrt(nope + rope), p rounded to bf16 before the
        latent context, then W_uv.  -> DecodeOut(logits (B, V) fp32,
        cache with pos + 1)[, per-key mass (B, S): the head-mean of the
        fp32 p, averaged over layers]."""
        cfg, m = self.cfg, self.cfg.mla
        H = cfg.n_heads
        x = params["embed"][tokens].to(torch.bfloat16)           # (B, 1, d)
        pos = cache["pos"]
        if pos.dim():
            raise ValueError("the MLA family decodes one position at a "
                             "time (its KVSpec declares no batched decode)")
        positions = pos[None]
        # 1 / sqrt(nope + rope) in fp32 arithmetic, as the reference
        qk_scale = float(np.float32(1.0) / np.sqrt(
            np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim)))
        S = cache["ckv"].shape[2]
        k_pos = torch.arange(S, device=x.device)
        qm = None
        if "ckv_q" in cache:
            # the new token lands in the bf16 window: clear its
            # quant-mask bit once (the mask is shared across layers)
            qm = cache["quant_mask"] & ~(k_pos == pos)[None, None]
        valid = k_pos < pos + 1
        if window:
            valid = valid & ((k_pos >= pos + 1 - window) | (k_pos < n_sinks))
        w_shape = (m.kv_lora_rank, H)
        masses = []
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            h = C.rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q_nope, q_pe = self._queries(pl, h, positions)      # (B,1,H,*)
            ckv_t, kpe_t = self._latents(pl, h, positions)
            C.ring_update(cache["ckv"][l], ckv_t, pos)
            C.ring_update(cache["kpe"][l], kpe_t, pos)
            ckv_att, kpe_att = self._attended(cache, l, qm)
            # absorb W_uk into q: q_abs (B,1,H,rank), rounded to bf16
            w_uk = pl["w_uk"].reshape(*w_shape, m.qk_nope_head_dim)
            q_abs = torch.einsum("bqhn,rhn->bqhr", q_nope, w_uk)
            f32 = torch.float32
            s = (torch.einsum("bqhr,bsr->bhqs", q_abs.to(f32),
                              ckv_att.to(f32))
                 + torch.einsum("bqhr,bsr->bhqs", q_pe.to(f32),
                                kpe_att.to(f32))) * qk_scale
            s = torch.where(valid, s, C.NEG_INF)
            p = torch.softmax(s, dim=-1)
            ctx = torch.einsum("bhqs,bsr->bqhr", p.to(ckv_att.dtype), ckv_att)
            w_uv = pl["w_uv"].reshape(*w_shape, m.v_head_dim)
            out = torch.einsum("bqhr,rhv->bqhv", ctx, w_uv)
            x = x + out.reshape(*x.shape[:2], -1) @ pl["wo"]
            x = self._ffn(pl, x)
            if want_density:
                # Eq.-1 key mass at the decoded position: head-mean of
                # the softmax row over the latent sequence
                masses.append(torch.mean(p[:, :, 0, :], dim=1))   # (B, S)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(torch.float32)
        new_cache = self._carry({"ckv": cache["ckv"], "kpe": cache["kpe"],
                                 "pos": pos + 1}, cache, qm)
        out = DecodeOut(logits, new_cache)
        if want_density:
            return out, torch.stack(masses).mean(dim=0)          # (B, S)
        return out

    # -- Fig. 7 recompute over latent chunks ---------------------------- #
    def recompute(self, params, miss_tokens: torch.Tensor,
                  miss_pos: torch.Tensor, cache, seq_len, window: int = 0,
                  n_sinks: int = 0, want_density: bool = False):
        """miss_tokens (B, M) original text of the missing slots;
        miss_pos (M,) absolute positions; cache: latents with holes
        there; seq_len: valid context tokens INCLUDING the missing ones.
        Recomputes the missing latents (global RoPE on kpe), writes them
        into ``cache`` in place, and attends each layer's queries over
        the up-projected K (nope + rope) and V of the whole cache
        through ``C.extend_attention`` (the ``attn_density`` kernel on
        the card).  In a mixed cache the recomputed positions leave the
        quant mask and resident int8 latents are read through
        ``_latent_select``.  Also the chunked prefill-append.  -> (cache,
        hidden (B, M, d), density (B, S) | None)."""
        cfg = self.cfg
        x = params["embed"][miss_tokens].to(torch.bfloat16)      # (B, M, d)
        qm = None
        if "ckv_q" in cache:
            # recomputed positions land in the bf16 window; resident
            # quant latents are read THROUGH during attention
            k_pos_all = torch.arange(cache["ckv"].shape[2], device=x.device)
            hit = (k_pos_all[None, :] == miss_pos[:, None]).any(dim=0)
            qm = cache["quant_mask"] & ~hit[None, None]
        dens = []
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            h = C.rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q_nope, q_pe = self._queries(pl, h, miss_pos)
            q = torch.cat([q_nope, q_pe], dim=-1)
            ckv_t, kpe_t = self._latents(pl, h, miss_pos)
            cache["ckv"][l][:, miss_pos] = ckv_t.to(cache["ckv"].dtype)
            cache["kpe"][l][:, miss_pos] = kpe_t.to(cache["kpe"].dtype)
            ckv_att, kpe_att = self._attended(cache, l, qm)
            k, v = self._expand_kv(pl, ckv_att.to(x.dtype),
                                   kpe_att.to(x.dtype))
            ao = C.extend_attention(q, k, v, miss_pos, seq_len, window,
                                    n_sinks, want_density)
            x = x + ao.out.reshape(*x.shape[:2], -1) @ pl["wo"]
            x = self._ffn(pl, x)
            if want_density:
                dens.append(ao.key_density)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        density = torch.stack(dens).mean(dim=0) if want_density else None
        if qm is not None:
            cache["quant_mask"] = qm
        return cache, x, density

    # -- entries this family's KVSpec does not declare ------------------ #
    def _undeclared(self, entry: str, capability: str):
        raise NotImplementedError(
            f"family {self.cfg.family!r} has no {entry}: its KVSpec "
            f"declares {capability}=False (it serves on the slot engine)")

    def recompute_pipelined(self, *a, **k):
        self._undeclared("recompute_pipelined", "pipelined_restore")

    def decode_paged(self, *a, **k):
        self._undeclared("decode_paged", "paged")

    def extend_paged(self, *a, **k):
        self._undeclared("extend_paged", "paged")
