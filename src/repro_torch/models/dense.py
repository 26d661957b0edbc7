"""Dense decoder-only transformer (llama family) — the serving entries.

Mirror of the JAX package's models/dense.py for what serving and
inference run: ``init``, ``head_weight``, the full-sequence ``prefill``
(``_layer_full`` / ``_stack_full``, attention through
``C.prefill_attention``: the ``attn_density`` kernel on the card),
``decode_step`` (window, mixed and all-int8 caches), the
interleaved-chunk ``recompute`` (paper Fig. 7; also the chunked
prefill-append), the layer-pipelined ``recompute_pipelined`` (paper
Fig. 8) and the paged-pool entries ``decode_paged`` / ``extend_paged``.
Layer parameters are stacked (L, ...) as in the reference; its
``lax.scan`` over layers is a Python loop here.  Training: ``loss``
(one ``torch.utils.checkpoint`` a layer; attention by the reference's
training branches, ``C.train_attention``) and ``blockwise_ce`` (the LM
head's CE in checkpointed blocks of 512 positions, so the (B, S, V)
logits are never all alive).

The mixed layout is the quant-resident working cache: bf16 ``k``/``v``
plus int8 ``k_q``/``v_q`` segments with per-(token, kv-head) scales,
selected per position by ``quant_mask``.  The all-int8 cache
(``init_cache(dtype=torch.int8)``) holds int8 ``k``/``v`` codes and
``k_scale``/``v_scale``: the reference's ``quantized`` decode branch.

Caches differ from the reference in one way: entries write new K/V
rows IN PLACE into the cache tensors they are given (the gathered page
view, or the arena on scatter-back) instead of returning new arrays.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels.paged import scatter_token
from repro_torch.kernels.ref import quantize_token_head_ref
from repro_torch.models import common as C
from repro_torch.models.api import DecodeOut, ModelBase, PrefillOut
from repro_torch.models.kvspec import KVSpec, LAYOUT_MIXED, LAYOUT_WINDOW


def _ce_block(xx, head, tt, mm):
    """One block of ``blockwise_ce``: (sum of masked nll, masked hits).
    The head product is rounded to bf16 before the fp32 cast, as in the
    reference."""
    logits = (xx @ head).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tt[..., None])[..., 0]
    return (torch.sum((logz - ll) * mm),
            torch.sum((torch.argmax(logits, dim=-1) == tt) * mm))


def blockwise_ce(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                 mask=None, block: int = 512):
    """Token-mean next-token CE of the final hidden x (B, S, d) under the
    head (d, V) against targets (B, S), mask (B, S) or None, in blocks
    of ``block`` positions, each checkpointed (its logits are recomputed
    in the backward), so the (B, S, V) logits are never all alive.  The
    reference pads the last block with masked rows; here it is shorter.
    -> (loss, {"loss", "acc"})."""
    B, S, _ = x.shape
    targets = targets.long()
    m = (torch.ones((B, S), dtype=torch.float32, device=x.device)
         if mask is None else mask.to(torch.float32))
    nll = acc = 0.0
    for lo in range(0, S, block):
        sl = slice(lo, lo + block)
        n_b, a_b = C.checkpointed(_ce_block, x[:, sl], head, targets[:, sl],
                                  m[:, sl])
        nll, acc = nll + n_b, acc + a_b
    cnt = torch.clamp_min(torch.sum(m), 1.0)
    loss = nll / cnt
    return loss, {"loss": loss, "acc": acc / cnt}


def _layer(params: Dict, l: int) -> Dict[str, torch.Tensor]:
    return {k: v[l] for k, v in params["layers"].items()}


# the mixed-precision (quant-resident) cache leaves that ride along the
# bf16 k/v through every entry point but are never written by them
_QUANT_LEAVES = ("k_q", "v_q", "k_scale", "v_scale")


def _quant_layer(cache, l: int):
    """Layer l's quant-segment leaves (k_q, v_q, k_scale, v_scale): the
    per-layer form of the reference's ``_quant_scan_xs``."""
    return tuple(cache[n][l] for n in _QUANT_LEAVES)


def _carry_quant_leaves(new_cache, cache, qm):
    """Decode/recompute never write the quant segments: alias them (and
    the updated quant mask) into the output cache."""
    for n in _QUANT_LEAVES:
        new_cache[n] = cache[n]
    new_cache["quant_mask"] = qm
    return new_cache


class DenseModel(ModelBase):

    def kv_spec(self) -> KVSpec:
        cfg = self.cfg
        kv_dims = (cfg.n_kv_heads, cfg.head_dim)
        return KVSpec(
            family=cfg.family,
            seq_leaves=("k", "v"),
            leaf_dims={"k": kv_dims, "v": kv_dims},
            servable=True,
            chunkable=True,
            recomputable=True,
            batched_decode=True,
            quant_resident=True,
            paged=True,
            pipelined_restore=True,
            layouts=(LAYOUT_WINDOW, LAYOUT_MIXED),
            tolerance_class="kv",
            min_bits=2,
            int8_serving=True,
            streaming_long=True,
        )

    # ------------------------------------------------------------------ #
    def init(self, generator: torch.Generator, ffn: bool = True) -> Dict:
        """Random weights from ``generator`` (which must live on the
        model's device), drawn one layer at a time so the fp32 draw of
        a full-width weight never sits beside the whole stack.
        ``ffn=False`` leaves out the dense FFN (``MoEModel`` installs
        its experts instead)."""
        cfg, dev = self.cfg, self.device
        H, KV, hd, d, ff = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            cfg.d_model, cfg.d_ff)
        L = cfg.n_layers
        shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                  "wo": (H * hd, d)}
        if ffn:
            shapes.update(w_gate=(d, ff), w_up=(d, ff), w_down=(ff, d))
        layers = {
            "ln_attn": torch.ones((L, d), dtype=torch.float32, device=dev),
            "ln_ffn": torch.ones((L, d), dtype=torch.float32, device=dev),
        }
        layers.update(C.init_stacked(generator, L, shapes, dev))
        if cfg.qkv_bias:
            for n, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
                layers[n] = torch.zeros((L, width), dtype=torch.float32,
                                        device=dev)
        if cfg.qk_norm:
            layers["q_norm"] = torch.ones((L, hd), dtype=torch.float32,
                                          device=dev)
            layers["k_norm"] = torch.ones((L, hd), dtype=torch.float32,
                                          device=dev)
        params = {
            "embed": C.init_linear(generator, (cfg.vocab, d), dev),
            "ln_f": torch.ones((d,), dtype=torch.float32, device=dev),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            params["head"] = C.init_linear(generator, (d, cfg.vocab), dev)
        return params

    def head_weight(self, params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # -- per-layer pieces ---------------------------------------------- #
    def _qkv(self, pl, h):
        cfg = self.cfg
        B, S, _ = h.shape
        q = h @ pl["wq"]
        k = h @ pl["wk"]
        v = h @ pl["wv"]
        if cfg.qkv_bias:
            q = q + pl["bq"].to(q.dtype)
            k = k + pl["bk"].to(k.dtype)
            v = v + pl["bv"].to(v.dtype)
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = C.rms_norm(q, pl["q_norm"], cfg.norm_eps)
            k = C.rms_norm(k, pl["k_norm"], cfg.norm_eps)
        return q, k, v

    def _rope(self, q, k, positions):
        cfg = self.cfg
        cos, sin = C.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        return C.apply_rope(q, cos, sin), C.apply_rope(k, cos, sin)

    def _ffn(self, pl, x):
        h = C.rms_norm(x, pl["ln_ffn"], self.cfg.norm_eps)
        return x + C.swiglu(h, pl["w_gate"], pl["w_up"], pl["w_down"])

    # -- full-sequence layer (train / prefill) ------------------------- #
    def _layer_full(self, pl, x, positions, window, n_sinks, want_density,
                    return_kv, train=False):
        """One layer over the whole sequence x (B, S, d) at ``positions``
        (S,) = arange(S), causal attention through
        ``C.prefill_attention`` or, with ``train``, the reference's
        training branches (``C.train_attention``).  -> (x, {"density",
        "k", "v"} as asked)."""
        h = C.rms_norm(x, pl["ln_attn"], self.cfg.norm_eps)
        q, k, v = self._qkv(pl, h)
        q, k = self._rope(q, k, positions)
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
            extras["k"], extras["v"] = k, v
        return x, extras

    def _train_layer(self, pl, x, positions, window, n_sinks):
        return self._layer_full(pl, x, positions, window, n_sinks, False,
                                False, train=True)[0]

    def _stack_full(self, params, tokens, *, window=0, n_sinks=0,
                    want_density=False, return_kv=False, train=False):
        """Every layer over tokens (B, S), then the final norm.  -> (x
        (B, S, d), extras stacked over layers: density (L, B, S), k / v
        (L, B, S, KV, hd) as asked).  ``train``: the training forward,
        one checkpoint a layer (no extras)."""
        x = params["embed"][tokens].to(torch.bfloat16)
        positions = torch.arange(tokens.shape[1], device=x.device)
        if train:
            for pl in C.unstack(params["layers"]):
                x = C.checkpointed(self._train_layer, pl, x, positions,
                                   window, n_sinks)
            return C.rms_norm(x, params["ln_f"], self.cfg.norm_eps), {}
        extras = []
        for l in range(self.cfg.n_layers):
            x, ex = self._layer_full(_layer(params, l), x, positions,
                                     window, n_sinks, want_density,
                                     return_kv)
            extras.append(ex)
        x = C.rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        return x, {k: torch.stack([e[k] for e in extras])
                   for k in extras[0]}

    def loss(self, params, batch):
        """Next-token CE of batch["tokens"] (B, S) against
        batch["targets"] (optional batch["mask"]) through ``blockwise_ce``,
        one checkpoint a layer.  The reference nests its checkpoints two
        levels deep over groups of layers (``_inner_group``): a policy
        of what memory holds, not of what is computed, so one level
        gives the same numbers.  -> (loss, {"loss", "acc"})."""
        x, _ = self._stack_full(params, batch["tokens"], train=True)
        return blockwise_ce(x, self.head_weight(params), batch["targets"],
                            batch.get("mask"))

    def prefill(self, params, batch, want_density: bool = False,
                window: int = 0, n_sinks: int = 0) -> PrefillOut:
        """Full-sequence prefill of batch["tokens"] (B, S).
        -> PrefillOut(logits (B, V) fp32 at the last position, cache
        {each of the KVSpec's seq_leaves stacked over layers (dense:
        "k", "v" (L, B, S, KV, hd)), "pos": S}, density (B, S) averaged
        over layers | None)."""
        tokens = batch["tokens"]
        x, extras = self._stack_full(params, tokens, window=window,
                                     n_sinks=n_sinks,
                                     want_density=want_density,
                                     return_kv=True)
        logits = (x[:, -1] @ self.head_weight(params)).to(torch.float32)
        cache = {n: extras[n] for n in self.kv_spec().seq_leaves}
        cache["pos"] = torch.tensor(tokens.shape[1], device=x.device)
        density = extras["density"].mean(dim=0) if want_density else None
        return PrefillOut(logits, cache, density)

    def _build_cache(self, batch, seq, dtype, layout):
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev),
                 "pos": torch.zeros((), dtype=torch.int64, device=dev)}
        if dtype == torch.int8:
            # all-int8 cache: codes with per-(token, kv-head) scales
            for n in ("k_scale", "v_scale"):
                cache[n] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        elif layout == LAYOUT_MIXED:
            # bf16 recent window + int8 quant-resident segments with
            # per-(token, kv-head) scales, selected per position by
            # quant_mask; its leading axis of 1 keeps axis 1 the batch
            # axis of every leaf
            for n in ("k", "v"):
                cache[n + "_q"] = torch.zeros(shape, dtype=torch.int8,
                                              device=dev)
                cache[n + "_scale"] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=dev)
            cache["quant_mask"] = torch.zeros((1, batch, seq),
                                              dtype=torch.bool, device=dev)
        return cache

    # ------------------------------------------------------------------ #
    def decode_step(self, params, tokens, cache, window: int = 0,
                    n_sinks: int = 0, want_density: bool = False):
        """One token per row.  tokens (B, 1); cache window, mixed or
        all-int8 layout with a 0-d ``pos`` (every row at one position) or
        a (B,) ``pos`` (row b at its own position).  Writes the new K/V
        (in the all-int8 cache: their codes and scales) into ``cache`` in
        place.  -> DecodeOut(logits (B, V) fp32, cache with pos + 1)
        [, per-key mass (B, S) averaged over layers]."""
        cfg = self.cfg
        x = params["embed"][tokens].to(torch.bfloat16)           # (B, 1, d)
        pos = cache["pos"]
        positions = pos[None] if pos.dim() == 0 else pos[:, None]
        mixed = "k_q" in cache               # bf16 window + int8 segments
        quantized = "k_scale" in cache and not mixed   # all-int8 cache
        if mixed:
            # the new token lands in the bf16 window: clear its
            # quant-mask bit once (the mask is shared across layers),
            # per row for a (B,) pos
            s_pos = torch.arange(cache["k"].shape[2], device=x.device)
            idx = pos[None] if pos.dim() == 0 else pos
            qm = cache["quant_mask"] & ~(s_pos[None, :] == idx[:, None])[None]
        masses = []
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            h = C.rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q, k, v = self._qkv(pl, h)
            q, k = self._rope(q, k, positions)
            if quantized:
                # per-(token, kv-head) symmetric scales, as the reference
                # serves them (max|x| * fl32(1/127)); the attention
                # dequantizes inside the kernel
                kq, ks = quantize_token_head_ref(k)
                vq, vs = quantize_token_head_ref(v)
                k_c = C.ring_update(cache["k"][l], kq, pos)
                v_c = C.ring_update(cache["v"][l], vq, pos)
                ks_c = C.ring_update(cache["k_scale"][l], ks, pos)
                vs_c = C.ring_update(cache["v_scale"][l], vs, pos)
                out = C.decode_attention(q, k_c, v_c, pos + 1,
                                         k_scale=ks_c, v_scale=vs_c,
                                         window=window, n_sinks=n_sinks,
                                         want_density=want_density)
            else:
                k_c = C.ring_update(cache["k"][l], k, pos)
                v_c = C.ring_update(cache["v"][l], v, pos)
                if mixed:
                    out = C.mixed_decode_attention(
                        q, k_c, v_c, *_quant_layer(cache, l), qm[0],
                        pos + 1, window=window, n_sinks=n_sinks,
                        want_density=want_density)
                else:
                    out = C.decode_attention(q, k_c, v_c, pos + 1,
                                             window=window, n_sinks=n_sinks,
                                             want_density=want_density)
            if want_density:
                out, mass = out
                masses.append(mass)
            x = x + out.reshape(*x.shape[:2], -1) @ pl["wo"]
            x = self._ffn(pl, x)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = (x[:, 0] @ self.head_weight(params)).to(torch.float32)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
        if mixed:
            _carry_quant_leaves(new_cache, cache, qm)
        elif quantized:
            new_cache["k_scale"] = cache["k_scale"]
            new_cache["v_scale"] = cache["v_scale"]
        out = DecodeOut(logits, new_cache)
        if want_density:
            return out, torch.stack(masses).mean(dim=0)          # (B, S)
        return out

    # ------------------------------------------------------------------ #
    # Paper Fig. 7: recompute missing chunks at scattered positions.
    # ------------------------------------------------------------------ #
    def recompute(self, params, miss_tokens: torch.Tensor,
                  miss_pos: torch.Tensor, cache, seq_len, window: int = 0,
                  n_sinks: int = 0, want_density: bool = False):
        """miss_tokens (B, M) original text of the missing slots;
        miss_pos (M,) absolute positions; cache: KV with holes there;
        seq_len: valid context tokens INCLUDING the missing ones (an int
        or a 0-d integer tensor on the cache's device).  Recomputes the missing K/V (global RoPE, attending over resident
        + recomputed KV under the causal/window mask bounded by
        ``seq_len``, through ``C.extend_attention``: the
        ``attn_density`` kernel on the card) and writes them into
        ``cache`` in place.  In a mixed cache the recomputed positions
        leave the quant mask and resident quant segments are read
        through ``dequant_select``.  -> (cache, hidden (B, M, d),
        density (B, S) | None).

        The same entry is the chunked prefill-append: miss_pos =
        [S0, S0+T) against a cache holding the first S0 tokens.  Bucket
        padding repeats one pad position with token 0; those rows write
        identical K/V, and as queries they enter the density exactly as
        in the reference."""
        return self._recompute_layers(params, miss_tokens, miss_pos, cache,
                                      seq_len, window, n_sinks, want_density)

    def _recompute_layers(self, params, miss_tokens, miss_pos, cache,
                          seq_len, window, n_sinks, want_density,
                          io_pos=None, fetch=None, feed_status=None):
        """The layer loop of ``recompute`` and ``recompute_pipelined``.
        With ``fetch``, layer l first writes ``fetch(l)``'s rows at
        ``io_pos`` into its K/V; restored positions (recomputed and, with
        ``fetch``, read) leave the quant mask of a mixed cache, which is
        replaced only after the last layer — a loop that stops early
        leaves it as it was, and so does one whose ``feed_status`` (a
        device word the feed's gates set) is not 0 at its end, chosen on
        the device."""
        cfg = self.cfg
        x = params["embed"][miss_tokens].to(torch.bfloat16)      # (B, M, d)
        mixed = "k_q" in cache
        if mixed:
            k_pos_all = torch.arange(cache["k"].shape[2], device=x.device)
            # recomputed (and disk-restored) positions land in the bf16
            # window; surviving quant segments are read through
            hit = (k_pos_all[None, :] == miss_pos[:, None]).any(dim=0)
            if fetch is not None:
                hit = hit | (k_pos_all[None, :] == io_pos[:, None]).any(dim=0)
            qm = cache["quant_mask"] & ~hit[None, None]
        dens = []
        for l in range(cfg.n_layers):
            pl = _layer(params, l)
            k_c, v_c = cache["k"][l], cache["v"][l]
            if fetch is not None:
                io = fetch(l)
                k_c[:, io_pos] = torch.as_tensor(
                    io["k"], device=k_c.device)[None].to(k_c.dtype)
                v_c[:, io_pos] = torch.as_tensor(
                    io["v"], device=v_c.device)[None].to(v_c.dtype)
            h = C.rms_norm(x, pl["ln_attn"], cfg.norm_eps)
            q, k, v = self._qkv(pl, h)
            q, k = self._rope(q, k, miss_pos)
            k_c[:, miss_pos] = k.to(k_c.dtype)
            v_c[:, miss_pos] = v.to(v_c.dtype)
            if mixed:
                kq_c, vq_c, ks_c, vs_c = _quant_layer(cache, l)
                k_att = C.dequant_select(k_c, kq_c, ks_c, qm[0])
                v_att = C.dequant_select(v_c, vq_c, vs_c, qm[0])
            else:
                k_att, v_att = k_c, v_c
            ao = C.extend_attention(q, k_att.to(q.dtype), v_att.to(q.dtype),
                                    miss_pos, seq_len, window, n_sinks,
                                    want_density)
            x = x + ao.out.reshape(*x.shape[:2], -1) @ pl["wo"]
            x = self._ffn(pl, x)
            if want_density:
                dens.append(ao.key_density)
        x = C.rms_norm(x, params["ln_f"], cfg.norm_eps)
        density = torch.stack(dens).mean(dim=0) if want_density else None
        if mixed:
            if feed_status is not None:
                qm = torch.where(feed_status.reshape(()) == 0, qm,
                                 cache["quant_mask"])
            cache["quant_mask"] = qm
        return cache, x, density

    # ------------------------------------------------------------------ #
    # Paper Fig. 8: swapping-recompute PIPELINED restore.  Layer l takes
    # the disk chunks' K/V from ``fetch(l)`` (the I/O thread of
    # core/restore.py LayerFeed runs a layer ahead) while recomputing
    # the complementary chunk set.
    # ------------------------------------------------------------------ #
    def recompute_pipelined(self, params, miss_tokens: torch.Tensor,
                            miss_pos: torch.Tensor, io_pos: torch.Tensor,
                            cache, seq_len, fetch, window: int = 0,
                            n_sinks: int = 0, want_density: bool = False,
                            feed_status=None):
        """``recompute`` of ``miss_*`` whose layer l first writes the rows
        of the chunks arriving from disk: ``fetch(l) -> {leaf: (Mio, KV,
        hd) fp32}`` (numpy arrays or tensors) at ``io_pos`` (Mio,), cast
        to the cache dtype, in place.  The reference pulls the same rows
        through an ordered ``io_callback`` inside its layer scan; here
        the loop calls ``fetch`` directly: the executor's captured
        restore (``ModelExecutor.run_pipelined``) passes one that waits
        on the device (``kernels/feed_gate.py``) and copies the layer's
        page-locked rows in, with the gates' ``feed_status`` (1,) int32:
        a mixed cache's quant mask is replaced only where it is 0.
        -> (cache, hidden (B, M, d), density (B, S) | None)."""
        return self._recompute_layers(params, miss_tokens, miss_pos, cache,
                                      seq_len, window, n_sinks, want_density,
                                      io_pos=io_pos, fetch=fetch,
                                      feed_status=feed_status)

    # ------------------------------------------------------------------ #
    # Paged KV pool entries: decode/prefill over the page arenas.  Both
    # gather the rows' pages into the dense window layout, run the
    # decode_step / recompute body on that copy, and scatter only the
    # newly written tokens back into their bf16 tail pages (in place).
    # ------------------------------------------------------------------ #
    def decode_paged(self, params, tokens, arenas, pt16, pos,
                     window: int = 0, n_sinks: int = 0,
                     want_density: bool = False, pt8=None,
                     quant_chunks=None):
        """One [B, 1] decode round over the pool.  tokens (B, 1); pt16
        (B, C) page-table rows; pos (B,) per-row positions; in
        quant-resident mode pt8 (B, C) int8-arena rows and quant_chunks
        (B, C) bool (else both None).  No host sync: the executor
        captures it as a CUDA graph (``core/graphs.py``).
        -> (arenas, logits[, mass])."""
        cs = arenas["k16"].shape[2]
        cache = C.paged_cache_view(arenas, ("k", "v"), pt16, pt8,
                                   quant_chunks, pos)
        out = self.decode_step(params, tokens, cache, window, n_sinks,
                               want_density)
        mass = None
        if want_density:
            out, mass = out
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        for n in ("k", "v"):
            scatter_token(arenas[n + "16"], pt16[rows, pos // cs], pos % cs,
                          out.cache[n][:, rows, pos])
        if want_density:
            return arenas, out.logits, mass
        return arenas, out.logits

    def extend_paged(self, params, miss_tokens, miss_pos, arenas, pt16,
                     seq_len, window: int = 0, n_sinks: int = 0,
                     want_density: bool = False, pt8=None,
                     quant_chunks=None):
        """Chunked prefill-append over the pool (B = 1): the paged form of
        ``recompute``'s append mode.  miss_pos positions map to bf16
        pages already allocated in pt16 (padding positions map to the
        scratch page 0); pt8 / quant_chunks as in ``decode_paged``;
        seq_len an int or a 0-d int32 tensor on the arenas' device (the
        executor's captured graph stages each call's value there).
        -> (arenas, hidden (1, M, d), density)."""
        cs = arenas["k16"].shape[2]
        cache = C.paged_cache_view(arenas, ("k", "v"), pt16, pt8,
                                   quant_chunks,
                                   torch.zeros((), dtype=torch.int64,
                                               device=pt16.device))
        new_cache, x, density = self.recompute(
            params, miss_tokens, miss_pos, cache, seq_len, window,
            n_sinks, want_density)
        for n in ("k", "v"):
            scatter_token(arenas[n + "16"], pt16[0, miss_pos // cs],
                          miss_pos % cs, new_cache[n][:, 0, miss_pos])
        return arenas, x, density
