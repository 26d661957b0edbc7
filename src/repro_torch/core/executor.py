"""Model executor — the model entry points of the serving stack.

Mirror of the JAX package's core/executor.py for the paged engine:
the power-of-two token/batch buckets, ``paged_extend``/``paged_decode``
over the global page arenas, the page admit/read/zero helpers, and the
``fresh_cache``/``extend_nod`` pair that ``profile_pipeline`` times.

PyTorch runs eagerly, so the reference's process-wide ``_JIT_CACHE``
has no counterpart.  The buckets stay all the same: prefill positions
are padded to ``pad_slot``, those padded query rows attend every valid
key and enter the Eq.-1 density, and the density drives the Eq.-3 bit
plan — so the port pads exactly as the reference does.

The arenas are updated IN PLACE (each entry returns the same dict the
caller passed) instead of being rebuilt functionally as in JAX.

Not ported yet (ROADMAP.md): the slot engine with its layer-pipelined
restore (``paged_pool=False``), the quant-resident arenas, and the
whole-state codec of non-chunked policies.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core.chunks import ChunkCodec
from repro_torch.models.kvspec import LAYOUT_WINDOW


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


class ModelExecutor:
    """Model entry points + bucket/padding helpers (one model)."""

    def __init__(self, model, params, cfg, device):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        mc = model.cfg
        spec = model.kv_spec()
        self.spec = spec
        if not spec.servable:
            raise ValueError(
                f"family {spec.family!r} is not servable: its KVSpec "
                "declares no text-only prefill/extend entry")
        self.cs = cfg.chunk_tokens
        self.n_slots = math.ceil(cfg.max_ctx_len / self.cs) * self.cs
        self.chunked_cache = spec.chunkable
        self.codec = ChunkCodec(spec.seq_leaves, self.cs, self.device)
        self.recomputable = spec.recomputable
        self.quant_resident = bool(getattr(cfg, "quant_resident", False))
        self.decode_slots = max(1, int(getattr(cfg, "decode_batch", 1) or 1))
        self.can_batch_decode = spec.batched_decode
        self.tok_buckets = _pow2_buckets(self.cs, self.n_slots)
        self.batch_buckets = _pow2_buckets(1, self.decode_slots)
        self.s_work = self.n_slots + self.tok_buckets[-1]
        self.pad_slot = self.s_work - 1
        self.n_layers = mc.n_layers
        self.leaf_dims = dict(spec.leaf_dims)
        self.leaf_shapes = {
            n: (mc.n_layers, 1, self.s_work, *self.leaf_dims[n])
            for n in self.codec.leaves}
        self._zero_cache = None

        self.paged = (
            bool(getattr(cfg, "paged_pool", False))
            and bool(getattr(cfg, "chunked", False))
            and spec.paged
            and self.can_batch_decode
            and self.s_work % self.cs == 0)
        if not self.paged:
            raise NotImplementedError(
                "only the paged-pool engine is ported; the slot engine "
                "(paged_pool=False) is a later slice (ROADMAP.md)")
        self.pages_per_ctx = self.s_work // self.cs
        C = self.pages_per_ctx
        # +1 everywhere: page 0 is the reserved scratch page.  The bf16
        # arena must at least fit every decode slot's full page row or a
        # single round could not be satisfied.
        self.pool_pages16 = max(
            int(getattr(cfg, "pool_pages_16", 0) or 16 * C + 1),
            self.decode_slots * C + 1)
        self.pool_pages8 = 1
        self._cw = dict(window=cfg.window, n_sinks=cfg.n_sinks)

    @property
    def max_request_tokens(self) -> int:
        """Largest prompt+generation a single request may add: half the
        token window, so one call can never condense its own output."""
        return self.n_slots // 2

    # -- bucket / padding helpers ------------------------------------- #
    def bucket_len(self, n: int) -> int:
        return next(x for x in self.tok_buckets if x >= n)

    def bucket_pad(self, arr: np.ndarray, fill) -> np.ndarray:
        b = self.bucket_len(len(arr))
        if b == len(arr):
            return arr
        return np.concatenate([arr, np.full(b - len(arr), fill, arr.dtype)])

    def chunk_positions(self, idxs: Sequence[int]) -> np.ndarray:
        pos = []
        for i in idxs:
            pos.extend(range(i * self.cs, (i + 1) * self.cs))
        return np.asarray(pos, np.int32)

    def _t(self, a, dtype=torch.int64) -> torch.Tensor:
        """Host array -> index tensor on the device."""
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- slot-cache entries (profile_pipeline) ------------------------- #
    def fresh_cache(self, n_tokens: int):
        """A zero window cache (1, s_work) with ``pos = n_tokens``.  The
        zero cache is allocated once, at first use; callers write into
        a clone."""
        if self._zero_cache is None:
            self._zero_cache = self.model.init_cache(1, self.s_work,
                                                     layout=LAYOUT_WINDOW)
        cache = {k: v.clone() for k, v in self._zero_cache.items()}
        cache["pos"] = torch.tensor(n_tokens, dtype=torch.int64,
                                    device=self.device)
        return cache

    def extend_nod(self, toks_b: np.ndarray, pos_b: np.ndarray, cache,
                   seq_len: int):
        """``recompute`` without density over a window cache (in place):
        the recompute cost ``profile_pipeline`` fits."""
        return self.model.recompute(
            self.params, self._t(toks_b)[None], self._t(pos_b), cache,
            int(seq_len), want_density=False, **self._cw)

    def logits(self, hidden: torch.Tensor) -> np.ndarray:
        return (hidden @ self.model.head_weight(self.params)
                ).to(torch.float32).cpu().numpy()

    # -- paged KV pool ------------------------------------------------- #
    def init_arenas(self):
        """Fresh page arenas — one fixed buffer per leaf.  Page 0 is the
        reserved scratch page every unowned page-table entry points at;
        its contents are garbage after the first write and never
        attended (the causal/seq-len masks zero those positions)."""
        return {n + "16": torch.zeros(
            (self.n_layers, self.pool_pages16, self.cs, *self.leaf_dims[n]),
            dtype=torch.bfloat16, device=self.device)
            for n in self.codec.leaves}

    def admit16(self, arenas, page: int, blocks):
        """Chunk-file block layout (cs, L*prod(dims)) -> page layout
        (L, cs, *dims), written into ``arenas[<leaf>16][:, page]``."""
        cs, nl = self.cs, self.n_layers
        for n in self.codec.leaves:
            t = blocks[n].reshape(cs, nl, *self.leaf_dims[n]).movedim(0, 1)
            arenas[n + "16"][:, page] = t.to(arenas[n + "16"].dtype)
        return arenas

    def read16(self, arenas, page: int):
        """Page -> (cs, F) blocks (copies)."""
        return {n: arenas[n + "16"][:, page].movedim(0, 1).reshape(self.cs, -1)
                for n in self.codec.leaves}

    def zero16(self, arenas, page: int):
        """Fresh tail pages start as zeros: never-written positions
        (e.g. a call's final emitted token) are attended and encoded,
        and must be exactly zero as in the reference."""
        for n in self.codec.leaves:
            arenas[n + "16"][:, page].zero_()
        return arenas

    def paged_extend(self, arenas, prompt: np.ndarray, n0: int, pt16):
        """Append ``prompt`` at [n0, n0+M) for the single context whose
        page-table row is ``pt16[0]``.  Padded positions land on the
        scratch page 0.  -> (arenas, last-token logits, per-position
        density mass)."""
        M = len(prompt)
        pos = np.arange(n0, n0 + M, dtype=np.int32)
        pos_b = self.bucket_pad(pos, self.pad_slot)
        toks_b = self.bucket_pad(np.asarray(prompt, np.int32), 0)
        arenas, hidden, dens = self.model.extend_paged(
            self.params, self._t(toks_b)[None], self._t(pos_b), arenas,
            self._t(pt16), n0 + M, want_density=True, **self._cw)
        logits = self.logits(hidden[:, M - 1])[0]
        return arenas, logits, dens[0].cpu().numpy().astype(np.float64)

    def paged_decode(self, arenas, toks: Sequence[int], pos: Sequence[int],
                     pt16):
        """One decode round for n contexts over the pool: row i advances
        by ``toks[i]`` at its own position ``pos[i]``, batch-bucketed.
        Pad rows get the all-zero page-table row (scratch page) and are
        sliced off the outputs.  -> (arenas, logits [n, V],
        density-mass [n, S])."""
        n = len(toks)
        nb = next(b for b in self.batch_buckets if b >= n)
        toks_b = np.zeros((nb, 1), np.int32)
        toks_b[:n, 0] = toks
        pos_b = np.zeros(nb, np.int32)
        pos_b[:n] = pos
        pt16_b = np.zeros((nb, pt16.shape[1]), np.int32)
        pt16_b[:n] = pt16
        arenas, logits, mass = self.model.decode_paged(
            self.params, self._t(toks_b), arenas, self._t(pt16_b),
            self._t(pos_b), want_density=True, **self._cw)
        return (arenas, logits[:n].cpu().numpy(),
                mass[:n].cpu().numpy().astype(np.float64))
