"""RWKV-6 "Finch": attention-free, data-dependent per-channel decay.

Mirror of the JAX package's models/rwkv6.py for what serving runs.
Recurrence per head (state S: (hd_k, hd_v) fp32):
    o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
with w_t = exp(-exp(w0 + LoRA_w(x_t))) a data-dependent decay, and
token-shift "ddlerp" mixes (mu + LoRA) producing r,k,v,g,w inputs.

Prefill and ``recompute`` run the **chunked-parallel** form
(``_wkv_chunked``): within a chunk of ``chunk_len`` tokens the
contribution is a decay-weighted strict lower-triangular product plus
the diagonal ``u`` bonus; across chunks a Python loop carries the
state (the reference's ``lax.scan``).  The per-step log-decay is
clamped at LOG_DECAY_FLOOR = -5.0, so with chunk_len 16 the largest
exponent of the factorized intra-chunk decay is 80 < ln(fp32 max).
``decode_step`` runs the recurrence one token at a time.  The wkv
products stay fp32 torch products on both devices, as the reference
computes them with ``jnp.einsum`` outside any Pallas kernel (and
``configure_numerics`` keeps them out of TF32 on the card).

The context state is CONSTANT-size — ``wkv`` (L, B, H, hd, hd) fp32 and
the token-shift rows ``tm`` / ``cm`` (L, B, d) bf16 — so serving moves
it as one whole-state snapshot (``core.chunks.WholeStateCodec``), and
extends run at exact length: a pad token would fold into the carried
state.  Entries write the new state IN PLACE into the cache they are
given, as the port's other families do.  ``loss`` (training) starts
from a zero state, one checkpoint a layer, and writes nothing in place:
``_wkv_chunked`` carries its state by rebinding, so autograd sees every
chunk's state.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import common as C
from repro_torch.models.api import DecodeOut, ModelBase, PrefillOut
from repro_torch.models.dense import _layer, blockwise_ce
from repro_torch.models.kvspec import KVSpec

LOG_DECAY_FLOOR = -5.0
STATE_LEAVES = ("wkv", "tm", "cm")


class RWKV6Model(ModelBase):

    def kv_spec(self) -> KVSpec:
        return KVSpec(
            family=self.cfg.family,
            seq_leaves=(),
            state_leaves=STATE_LEAVES,
            servable=True,
            chunkable=False,          # constant-size state: one blob
            recomputable=True,        # state rebuilds from resident text
            batched_decode=False,
            quant_resident=False,
            paged=False,
            pipelined_restore=False,
            # a pad token folds into the carried recurrence — extends
            # must run at exact length, never bucket-padded
            pad_safe=False,
            tolerance_class="state",
            min_bits=16,              # fp16 snapshot only; never chunk-quant
            density=False,            # attention-free: no Eq.-1 statistic
        )

    def init(self, generator: torch.Generator) -> Dict:
        """Random weights from ``generator`` (on the model's device), in
        the reference's layout and dtypes: norms, mixes and the decay
        base fp32, every projection bf16."""
        cfg, dev = self.cfg, self.device
        r = cfg.rwkv
        d, ff, L, H, hd = (cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_heads,
                           r.head_dim)
        if H * hd != d:
            raise ValueError(f"{cfg.name}: {H} heads x {hd} != d {d}")

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)

        def lin(shape, scale=0.02):
            w = torch.empty((L, *shape), dtype=torch.bfloat16, device=dev)
            for l in range(L):
                w[l] = C.init_linear(generator, shape, dev, scale)
            return w

        layers = {
            "ln1": full((L, d), 1.0), "ln1_b": full((L, d), 0.0),
            "ln2": full((L, d), 1.0), "ln2_b": full((L, d), 0.0),
            # ddlerp token-shift mixes
            "mu_x": full((L, d), 0.5),
            "mix_w1": lin((d, 5 * r.mix_lora), 0.01),
            "mix_w2": lin((5, r.mix_lora, d), 0.01),
            "mu_rkvgw": full((L, 5, d), 0.5),
            # decay
            "w0": full((L, d), -0.6),          # exp(-exp(-0.6)) ~ .58
            "w_a": lin((d, r.decay_lora), 0.01),
            "w_b": lin((r.decay_lora, d), 0.01),
            "u": lin((H, hd), 0.3),
            # time-mix projections
            "wr": lin((d, d)), "wk": lin((d, d)), "wv": lin((d, d)),
            "wg": lin((d, d)), "wo": lin((d, d)),
            "lnx": full((L, d), 1.0), "lnx_b": full((L, d), 0.0),
            # channel-mix
            "mu_ck": full((L, d), 0.5), "mu_cr": full((L, d), 0.5),
            "wck": lin((d, ff)), "wcv": lin((ff, d)), "wcr": lin((d, d)),
        }
        return {
            "embed": C.init_linear(generator, (cfg.vocab, d), dev),
            "head": C.init_linear(generator, (d, cfg.vocab), dev),
            "ln_f": torch.ones((d,), dtype=torch.float32, device=dev),
            "ln_f_b": torch.zeros((d,), dtype=torch.float32, device=dev),
            "layers": layers,
        }

    def head_weight(self, params) -> torch.Tensor:
        return params["head"]

    # -- ddlerp token shift ---------------------------------------------- #
    def _ddlerp(self, pl, x, x_prev):
        """x, x_prev: (B,S,d) -> five mixed inputs (5,B,S,d)."""
        xx = x_prev - x
        x_x = x + xx * pl["mu_x"].to(x.dtype)
        lora = torch.tanh(x_x @ pl["mix_w1"])                    # (B,S,5*ml)
        B, S, _ = x.shape
        ml = pl["mix_w2"].shape[1]
        lora = lora.reshape(B, S, 5, ml).permute(2, 0, 1, 3)     # (5,B,S,ml)
        mix = torch.einsum("fbsm,fmd->fbsd", lora, pl["mix_w2"])
        mix = mix + pl["mu_rkvgw"].to(x.dtype)[:, None, None]
        return x[None] + xx[None] * mix                          # (5,B,S,d)

    def _time_mix_inputs(self, pl, x, x_prev):
        cfg = self.cfg
        H, hd = cfg.n_heads, cfg.rwkv.head_dim
        B, S, _ = x.shape
        f32 = torch.float32
        xr, xk, xv, xg, xw = self._ddlerp(pl, x, x_prev)
        r = (xr @ pl["wr"]).reshape(B, S, H, hd)
        k = (xk @ pl["wk"]).reshape(B, S, H, hd)
        v = (xv @ pl["wv"]).reshape(B, S, H, hd)
        g = xg @ pl["wg"]
        logw = pl["w0"].to(f32) + torch.tanh(
            xw.to(f32) @ pl["w_a"].to(f32)) @ pl["w_b"].to(f32)
        log_decay = torch.clamp_min(-torch.exp(logw), LOG_DECAY_FLOOR)
        return r, k, v, g, log_decay.reshape(B, S, H, hd)

    # -- chunked-parallel wkv --------------------------------------------- #
    def _wkv_chunked(self, r, k, v, log_decay, u, state0):
        """r/k/v/log_decay: (B,S,H,hd); u: (H,hd) fp32; state0:
        (B,H,hd,hd) fp32.  -> (out (B,S,H,hd) fp32, state (B,H,hd,hd))."""
        B, S, H, hd = r.shape
        c = min(self.cfg.rwkv.chunk_len, S)
        nc = (S + c - 1) // c
        pad = nc * c - S
        f32 = torch.float32
        r, k, v, ld = (a.to(f32) for a in (r, k, v, log_decay))
        if pad:
            # padded steps have k = v = 0 and log-decay 0 (decay 1.0):
            # the IDENTITY on the carried state
            r, k, v, ld = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                           for a in (r, k, v, ld))
        ii = torch.arange(c, device=r.device)
        lower = (ii[None, :] < ii[:, None])[None, None]          # j < i
        state = state0.to(f32)
        outs = []
        for n in range(nc):
            sl = slice(n * c, (n + 1) * c)
            rb, kb, vb, ldb = r[:, sl], k[:, sl], v[:, sl], ld[:, sl]
            L = torch.cumsum(ldb, dim=1)                         # inclusive
            L_prev = L - ldb                                     # exclusive
            L_last = L[:, -1:]                                   # (B,1,H,hd)
            r_in = rb * torch.exp(L_prev)                        # <= |r|
            k_out = kb * torch.exp(L_last - L)                   # <= |k|
            k_in = kb * torch.exp(-L)                            # c*5 < 88
            # inter-chunk: queries read the incoming state
            out = torch.einsum("bchk,bhkv->bchv", r_in, state)
            # intra-chunk strict-lower-triangular attention
            scores = torch.einsum("bihk,bjhk->bhij", r_in, k_in)
            scores = torch.where(lower, scores, 0.0)
            out = out + torch.einsum("bhij,bjhv->bihv", scores, vb)
            # diagonal bonus term
            diag = torch.einsum("bchk,hk,bchk->bch", rb, u, kb)
            outs.append(out + diag[..., None] * vb)
            # state update
            state = torch.exp(L_last[:, 0, :, :, None]) * state \
                + torch.einsum("bjhk,bjhv->bhkv", k_out, vb)
        out = torch.cat(outs, dim=1)
        return out[:, :S], state

    def _time_mix_full(self, pl, x, tm_prev, state0):
        """Full-sequence time-mix.  tm_prev: (B,d) last token before x.
        -> (x + out, the new token-shift row, the new wkv state)."""
        cfg = self.cfg
        B, S, d = x.shape
        xs = C.layer_norm(x, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
        x_prev = torch.cat([tm_prev[:, None].to(xs.dtype), xs[:, :-1]], dim=1)
        r, k, v, g, ld = self._time_mix_inputs(pl, xs, x_prev)
        out, state = self._wkv_chunked(r, k, v, ld,
                                       pl["u"].to(torch.float32), state0)
        out = C.group_norm_heads(out.reshape(B, S, d).to(x.dtype), pl["lnx"],
                                 pl["lnx_b"], cfg.n_heads)
        out = (out * C.silu(g)) @ pl["wo"]
        return x + out, xs[:, -1], state

    def _channel_mix_full(self, pl, x, cm_prev):
        cfg = self.cfg
        xs = C.layer_norm(x, pl["ln2"], pl["ln2_b"], cfg.norm_eps)
        x_prev = torch.cat([cm_prev[:, None].to(xs.dtype), xs[:, :-1]], dim=1)
        xx = x_prev - xs
        xk = xs + xx * pl["mu_ck"].to(xs.dtype)
        xr = xs + xx * pl["mu_cr"].to(xs.dtype)
        kk = torch.square(torch.relu(xk @ pl["wck"]))
        out = C.sigmoid(xr @ pl["wcr"]) * (kk @ pl["wcv"])
        return x + out, xs[:, -1]

    def _forward_full(self, params, tokens, cache):
        """The layer stack over ``tokens`` (B, S), continuing from (and
        writing, in place) the state leaves of ``cache``.  -> the final
        normed hidden states (B, S, d)."""
        cfg = self.cfg
        x = params["embed"][tokens].to(torch.bfloat16)
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            x, tm, wkv = self._time_mix_full(pl, x, cache["tm"][l],
                                             cache["wkv"][l])
            x, cm = self._channel_mix_full(pl, x, cache["cm"][l])
            cache["wkv"][l], cache["tm"][l], cache["cm"][l] = wkv, tm, cm
        return C.layer_norm(x, params["ln_f"], params["ln_f_b"], cfg.norm_eps)

    def _train_layer(self, pl, x, tm0, wkv0, cm0):
        x, _, _ = self._time_mix_full(pl, x, tm0, wkv0)
        return self._channel_mix_full(pl, x, cm0)[0]

    # -- entry points ------------------------------------------------------ #
    def loss(self, params, batch):
        """Next-token CE of batch["tokens"] (B, S) from a zero state
        (``blockwise_ce``), one checkpoint a layer.  -> (loss, {"loss",
        "acc"})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B = tokens.shape[0]
        x = params["embed"][tokens].to(torch.bfloat16)
        H, hd = cfg.n_heads, cfg.rwkv.head_dim
        wkv0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                           device=x.device)
        shift0 = torch.zeros((B, cfg.d_model), dtype=torch.bfloat16,
                             device=x.device)      # both token shifts
        for pl in C.unstack(params["layers"]):
            x = C.checkpointed(self._train_layer, pl, x, shift0, wkv0,
                               shift0)
        x = C.layer_norm(x, params["ln_f"], params["ln_f_b"], cfg.norm_eps)
        return blockwise_ce(x, self.head_weight(params), batch["targets"],
                            batch.get("mask"))

    def prefill(self, params, batch, want_density=False, window=0, n_sinks=0):
        """The prompt ``batch["tokens"]`` (B, S) from a zero state.
        -> PrefillOut(last-token logits (B, V) fp32, cache with pos = S,
        None: attention-free, no Eq.-1 density)."""
        tokens = batch["tokens"]
        cache = self._build_cache(tokens.shape[0], 0, None, None)
        x = self._forward_full(params, tokens, cache)
        logits = (x[:, -1] @ self.head_weight(params)).to(torch.float32)
        cache["pos"] = torch.tensor(tokens.shape[1], device=self.device)
        return PrefillOut(logits, cache, None)

    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token per row, the recurrence in its sequential form.
        tokens (B, 1).  Writes the new state into ``cache`` in place.
        -> DecodeOut(logits (B, V) fp32, cache with pos + 1)[, a (B, 1)
        zero mass: no Eq.-1 statistic, and the accumulator is
        length-tolerant]."""
        cfg = self.cfg
        H, d = cfg.n_heads, cfg.d_model
        f32 = torch.float32
        x = params["embed"][tokens].to(torch.bfloat16)           # (B,1,d)
        B = x.shape[0]
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            S0 = cache["wkv"][l]
            xs = C.layer_norm(x, pl["ln1"], pl["ln1_b"], cfg.norm_eps)
            x_prev = cache["tm"][l][:, None].to(xs.dtype)
            r, k, v, g, ld = self._time_mix_inputs(pl, xs, x_prev)
            rf, kf, vf = (a.to(f32)[:, 0] for a in (r, k, v))
            kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
            att = S0 + pl["u"].to(f32)[None, :, :, None] * kv
            out = torch.einsum("bhk,bhkv->bhv", rf, att).reshape(B, d)
            S1 = torch.exp(ld.to(f32))[:, 0, :, :, None] * S0 + kv
            out = C.group_norm_heads(out.to(x.dtype), pl["lnx"], pl["lnx_b"],
                                     H).reshape(B, 1, d)
            x = x + (out * C.silu(g)) @ pl["wo"]
            x, cm = self._channel_mix_full(pl, x, cache["cm"][l])
            cache["wkv"][l], cache["tm"][l], cache["cm"][l] = S1, xs[:, -1], cm
        x = C.layer_norm(x, params["ln_f"], params["ln_f_b"], cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(f32)
        cache["pos"] = cache["pos"] + 1
        out = DecodeOut(logits, cache)
        if want_density:
            return out, torch.zeros((B, 1), dtype=f32, device=x.device)
        return out

    def recompute(self, params, miss_tokens, miss_pos, cache, seq_len,
                  window: int = 0, n_sinks: int = 0,
                  want_density: bool = False):
        """Constant-state 'recompute': run the text through the
        recurrence continuing from the state carried in ``cache`` (a
        zero state rebuilds from scratch), in place.  ``miss_pos`` must
        be the contiguous append range — recurrent state has no random
        access, so there are no mid-sequence hole fills.  -> (cache,
        hidden (B, M, d), a zero density (B, M) | None)."""
        x = self._forward_full(params, miss_tokens, cache)
        density = (torch.zeros(miss_tokens.shape, dtype=torch.float32,
                               device=x.device) if want_density else None)
        return cache, x, density

    def _build_cache(self, batch, seq, dtype, layout):
        """Sequence-independent: the state is one constant-size blob."""
        cfg, dev = self.cfg, self.device
        L, H, hd, d = (cfg.n_layers, cfg.n_heads, cfg.rwkv.head_dim,
                       cfg.d_model)
        return {
            "wkv": torch.zeros((L, batch, H, hd, hd), dtype=torch.float32,
                               device=dev),
            "tm": torch.zeros((L, batch, d), dtype=torch.bfloat16,
                              device=dev),
            "cm": torch.zeros((L, batch, d), dtype=torch.bfloat16,
                              device=dev),
            "pos": torch.zeros((), dtype=torch.int64, device=dev),
        }
