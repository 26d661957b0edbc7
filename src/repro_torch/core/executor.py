"""Model executor — the model entry points of the serving stack.

Mirror of the JAX package's core/executor.py: the power-of-two
token/batch/I-O buckets, and two engines over the same model entries.

* **Slot caches** (``paged_pool=False``, every non-chunked policy and
  every family without a paged pool): ``decode_slots`` static slot
  caches and one scratch slot for the engine's transient caches
  (``init_slots``) — the window layout, or the mixed layout (bf16
  window + int8 segments) with ``quant_resident``, or a state family's
  constant-size state.  ``fresh_cache(n, slot=i)`` zeroes slot i's
  cache in place; ``extend`` / ``extend_nod`` / ``decode`` run the
  model's ``recompute`` and ``decode_step`` on it and copy the leaves
  the model returns anew (``pos``, ``quant_mask``) back into the
  slot's, so a slot keeps its addresses.  ``run_pipelined`` runs the
  paper's Fig.-8 restore (``DenseModel.recompute_pipelined``) into a
  slot in place: one replay whose layer l waits on the device
  (``kernels/feed_gate.py``) until the ``restore.LayerFeed``'s I/O
  thread has published layer l of the disk chunks in the executor's
  page-locked sink (``feed_sink``), then copies those rows in, while
  the thread reads layer l + 1.
* **The paged pool**: ``paged_extend`` / ``paged_decode`` over the
  global page arenas, and the page admit/read/zero helpers.

Both engines' entries run through ``core/graphs.py``, the counterpart
of the reference's jitted entries in its ``_JIT_CACHE``: on the card
every call is one replay of a CUDA graph captured for its bucket (or,
for a family that is not ``pad_safe``, its exact length) and its
buffers — the arenas, or one slot's cache — with the head product and
``seq_len`` on the device inside it; on the CPU the same body runs
eagerly on the same buffers.  A cache that is no slot's (``fresh_cache``
without a slot: a private clone, for tests and tools) runs the same
bodies eagerly, counted in ``eager_calls``.  The executor owns its
graphs (they bake in its params', arenas' and slots' addresses), so no
cache is shared across executors.  admit / read / zero and the codec's
scatters stay eager.

The pipelined restore needs no ``io_callback`` and no ``_ACTIVE_FEED``
global: the feed is an argument, and its rows reach the graph through
static host buffers and one flag word a layer.  Its graphs are keyed
by (``"pipelined"``, (token bucket, I/O chunk bucket), quant-resident,
slot).  The buckets stay all the same:
prefill positions are padded to ``pad_slot``, those padded query rows
attend every valid key and enter the Eq.-1 density, and the density
drives the Eq.-3 bit plan — so the port pads exactly as the reference
does.  A family that is not ``pad_safe`` (RWKV6: a pad
token would fold into the carried state) extends at exact length, and
a family whose cache is not chunkable takes ``WholeStateCodec``.

Caches and arenas are updated IN PLACE (each entry returns the same
dict the caller passed, its tensors written, ``pos`` included) instead
of being rebuilt functionally as in JAX.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.chunks import ChunkCodec, WholeStateCodec
from repro_torch.core.faults import SwapTimeoutError
from repro_torch.core.graphs import GraphCache, capturable
from repro_torch.core.restore import FeedSink, LayerFeed, publish_plain
from repro_torch.kernels import ops
from repro_torch.models.kvspec import LAYOUT_MIXED, LAYOUT_WINDOW

# The longest a pipelined restore's gate waits for its layer's rows
# where the service sets no ``swap_deadline_s``: far above a layer's
# read (milliseconds at full width), and it bounds how long the card
# can wait for a feed thread that never publishes.
PIPELINED_DEADLINE_S = 30.0
# the chunk counts ``ResidencyEngine.profile_pipeline`` times a
# recompute at (on the scratch slot, fed one pad I/O chunk)
PROFILE_CHUNKS = (1, 2, 4)


def _write_back(cache, new) -> None:
    """A model entry's resulting cache ``new`` into the slot cache
    ``cache``: the leaves it made anew (``pos``, ``quant_mask``) copied
    into the slot's own, so that the slot keeps its addresses (the
    entries wrote the others in place)."""
    for n, t in new.items():
        if t is not cache[n]:
            cache[n].copy_(t)


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
        if spec.chunkable:
            self.codec = ChunkCodec(spec.seq_leaves, self.cs, self.device)
        else:
            self.codec = WholeStateCodec(spec.state_leaves, self.cs)
        self.recomputable = spec.recomputable
        self.pad_safe = spec.pad_safe
        self.quant_resident = bool(getattr(cfg, "quant_resident", False))
        if self.quant_resident and not spec.quant_resident:
            raise ValueError(
                f"family {spec.family!r} does not support the quant-"
                "resident working cache (families opt in via "
                "KVSpec.quant_resident)")
        self.decode_slots = max(1, int(getattr(cfg, "decode_batch", 1) or 1))
        self.can_batch_decode = spec.batched_decode
        self.tok_buckets = _pow2_buckets(self.cs, self.n_slots)
        self.io_buckets = _pow2_buckets(1, max(self.n_slots // self.cs, 1))
        self.batch_buckets = _pow2_buckets(1, self.decode_slots)
        self.s_work = self.n_slots + self.tok_buckets[-1]
        self.pad_slot = self.s_work - 1
        self.n_layers = mc.n_layers
        self.leaf_dims = dict(spec.leaf_dims)
        self._zero_cache = None
        # slot -> static slot cache (init_slots)
        self._slots: Optional[Dict[int, dict]] = None
        # slot-engine entries run eagerly on a cache that is no slot's
        self.eager_calls = 0
        if spec.chunkable:
            self.leaf_shapes = {
                n: (mc.n_layers, 1, self.s_work, *self.leaf_dims[n])
                for n in self.codec.leaves}
        else:
            # a state cache is small and sequence-independent: its
            # shapes are those of the zero cache itself
            self.leaf_shapes = {n: tuple(self._zero()[n].shape)
                                for n in self.codec.leaves}
        self._pipelining = False
        # the pipelined restores' page-locked sink (_sink), the last
        # generation handed out, and a timed-out restore's feed that may
        # still write the sink
        self._sink_state = None
        self._gen = 0
        self._stale_feed: Optional[LayerFeed] = None
        # the last pipelined restore: its wall time, the time its gates
        # waited for the feed (the device's wait for I/O) and layer 0's
        # share of it
        self.last_pipelined = {"wall_s": 0.0, "feed_wait_s": 0.0,
                               "first_wait_s": 0.0}

        self.paged = (
            bool(getattr(cfg, "paged_pool", False))
            and bool(getattr(cfg, "chunked", False))
            and spec.paged
            and self.can_batch_decode
            and self.s_work % self.cs == 0)
        self.pages_per_ctx = self.s_work // self.cs
        if self.paged:
            C = self.pages_per_ctx
            # +1 everywhere: page 0 is the reserved scratch page.  The
            # bf16 arena must at least fit every decode slot's full page
            # row or a single round could not be satisfied.
            self.pool_pages16 = max(
                int(getattr(cfg, "pool_pages_16", 0) or 16 * C + 1),
                self.decode_slots * C + 1)
            self.pool_pages8 = (
                int(getattr(cfg, "pool_pages_8", 0) or 16 * C + 1)
                if self.quant_resident else 1)
        self._cw = dict(window=cfg.window, n_sinks=cfg.n_sinks)
        # both engines' graphs (core/graphs.py), this executor's own
        self.graphs = GraphCache(self.device)

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

    def sync(self) -> None:
        """Wait for the card (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- slot-cache entries -------------------------------------------- #
    def _zero(self):
        """The zero working cache (1, s_work), allocated at first use —
        the mixed layout under ``quant_resident``, else the window
        layout; a state family's constant-size state."""
        if self._zero_cache is None:
            self._zero_cache = self.model.init_cache(
                1, self.s_work,
                layout=LAYOUT_MIXED if self.quant_resident else LAYOUT_WINDOW)
        return self._zero_cache

    @property
    def scratch_slot(self) -> int:
        """The slot of the engine's transient caches (``profile_pipeline``
        and its payload probe, ``LLMService._condense``): the one after
        the decode slots."""
        return self.decode_slots

    def init_slots(self) -> Dict[int, dict]:
        """The static slot caches, made once: the decode slots 0 ..
        decode_slots - 1 and the scratch slot (a paged executor's
        contexts live in the pool: it makes the scratch slot only).  On
        the card every slot's graphs (``_slot_ahead``) are captured over
        them now, and each slot is zeroed after the warm-ups wrote into
        it.  -> {slot: cache}."""
        if self._slots is None:
            layout = LAYOUT_MIXED if self.quant_resident else LAYOUT_WINDOW
            ids = ([self.scratch_slot] if self.paged
                   else range(self.decode_slots + 1))
            slots = {i: self.model.init_cache(1, self.s_work, layout=layout)
                     for i in ids}
            if self.device.type == "cuda":
                for i, cache in slots.items():
                    for name, n in self._slot_ahead(i):
                        self.graphs.prepare(
                            cache, *self._slot_entry(name, n, i, cache))
                    for t in cache.values():
                        t.zero_()
            self._slots = slots
        return self._slots

    @property
    def slot_caches(self) -> Dict[int, dict]:
        """The static slot caches made so far, by slot."""
        return dict(self._slots or {})

    def _slot_ahead(self, slot: int) -> List[Tuple[str, object]]:
        """The entries captured ahead over a slot: ``decode`` (not on the
        scratch slot, which never decodes) and, where the family pads,
        ``extend`` at every token bucket, and ``extend_nod`` at every one
        where restores recompute (``recomputable`` chunked caches); where
        the policy and the family pipeline restores, ``pipelined`` at
        every (token bucket, I/O bucket) pair a restore can take
        (``_pipelined_pairs``), on the scratch slot at those that
        ``profile_pipeline`` times.  A family that is not ``pad_safe``
        extends at exact lengths: those graphs are captured at their
        first call."""
        out = [] if slot == self.scratch_slot else [("decode", 1)]
        if self.pad_safe:
            out += [("extend", b) for b in self.tok_buckets]
            if self.recomputable and self.chunked_cache:
                out += [("extend_nod", b) for b in self.tok_buckets]
        if self.pipelines:
            out += [("pipelined", p) for p in self._pipelined_pairs(slot)]
        return out

    @property
    def pipelines(self) -> bool:
        """Restores run the Fig.-8 pipelined restore: the policy's
        ``use_pipeline`` and the family's ``pipelined_restore``."""
        return bool(getattr(self.cfg, "use_pipeline", False)
                    and self.spec.pipelined_restore)

    def _pipelined_pairs(self, slot: int) -> List[Tuple[int, int]]:
        """The (token bucket, I/O chunk bucket) pairs of the pipelined
        restores a slot takes.  A decode slot: every pair whose fewest
        chunks fit the context (a token bucket b > 16 needs more than
        the bucket below it in chunks; an I/O bucket n > 1 more than the
        one below, 1 none: its pad chunk), which at ``max_ctx_len`` 256
        leaves out (256, 16) only: 24 pairs.  The scratch slot: the
        pairs ``profile_pipeline`` times, ``PROFILE_CHUNKS`` recomputed
        chunks fed one pad I/O chunk."""
        cs, n_chunks = self.cs, self.n_slots // self.cs
        if slot == self.scratch_slot:
            return sorted({(self.bucket_len(x * cs), 1)
                           for x in PROFILE_CHUNKS if x * cs <= self.n_slots})
        tb, ib = self.tok_buckets, self.io_buckets
        return [(t, n) for i, t in enumerate(tb) for j, n in enumerate(ib)
                if (tb[i - 1] // cs + 1 if i else 1)
                + (ib[j - 1] + 1 if j else 0) <= n_chunks]

    def slot_of(self, cache) -> Optional[int]:
        """The slot whose static cache ``cache`` is (the same dict), or
        None for a private cache."""
        for i, c in (self._slots or {}).items():
            if c is cache:
                return i
        return None

    def fresh_cache(self, n_tokens: int, slot: Optional[int] = None):
        """A zero working cache with ``pos = n_tokens``: slot ``slot``'s
        static cache zeroed in place (the slot engine's), or without a
        slot a private clone of the zero cache, whose entries run
        eagerly (``eager_calls``)."""
        if slot is None:
            cache = {k: v.clone() for k, v in self._zero().items()}
        else:
            cache = self.init_slots()[slot]
            for t in cache.values():
                t.zero_()
        return self.set_pos(cache, n_tokens)

    def set_pos(self, cache, n_tokens: int):
        """The reference's ``setpos``: the cache's decode position (a
        state family's recurrence ignores it), written into its ``pos``
        tensor in place."""
        cache["pos"].fill_(n_tokens)
        return cache

    def _slot_entry(self, name: str, n: int, slot: Optional[int], cache):
        """A slot entry at ``n`` tokens over ``cache`` (slot ``slot``):
        its cache key, its static inputs {name: (shape, dtype)} and the
        maker of its body.  ``extend`` and ``extend_nod`` take tokens,
        positions and ``seq_len``, ``extend`` also its last real row;
        ``decode`` one token at the cache's ``pos``; ``pipelined``, at
        ``n`` = (token bucket, I/O chunk bucket), tokens, their
        positions, the I/O rows' positions, ``seq_len``, the restore's
        generation and the gates' deadline."""
        i64 = torch.int64
        if name == "decode":
            spec = {"toks": ((1, 1), i64)}
            make = lambda: self._decode_body(cache, slot=True)   # noqa: E731
        elif name == "pipelined":
            m, nio = n
            spec = {"toks": ((1, m), i64), "miss": ((m,), i64),
                    "io_pos": ((nio * self.cs,), i64),
                    "seq_len": ((), torch.int32), "gen": ((), torch.int32),
                    "deadline_ns": ((), i64)}
            make = lambda: self._pipelined_body(cache, nio)      # noqa: E731
        else:
            spec = {"toks": ((1, n), i64), "pos": ((n,), i64),
                    "seq_len": ((), torch.int32)}
            if name == "extend":
                spec["last"] = ((1,), i64)
            make = lambda: self._extend_body(                    # noqa: E731
                cache, slot=True, density=name == "extend")
        return (name, n, self.quant_resident, slot), spec, make

    def _slot_call(self, cache, name: str, n: int, host, to_host=True):
        """Entry ``name`` at ``n`` tokens over ``cache``: a slot's graph
        (``core/graphs.py``: replayed on the card, its body run on the
        CPU), or on a private cache the same body run eagerly.  -> its
        outputs (on the host where ``to_host``)."""
        slot = self.slot_of(cache)
        key, spec, make = self._slot_entry(name, n, slot, cache)
        if slot is not None:
            return self.graphs.run(cache, key, spec, make, host,
                                   keep=tuple(cache.values()),
                                   to_host=to_host)
        self.eager_calls += 1
        inp = {k: torch.as_tensor(np.asarray(host[k])).to(
                   device=self.device, dtype=dt).reshape(shape)
               for k, (shape, dt) in spec.items()}
        outs = make()(inp)
        return [o.cpu().numpy() for o in outs] if to_host else list(outs)

    def extend_nod(self, toks_b: np.ndarray, pos_b: np.ndarray, cache,
                   seq_len: int):
        """The model's ``recompute`` of the tokens ``toks_b`` at positions
        ``pos_b`` (both bucket-padded by the caller, or at exact length)
        without density, in place: the second phase of a restore.  On a
        slot cache its graph at ``len(toks_b)`` tokens.  -> (cache,
        hidden (1, M, d) on the device, None)."""
        (hidden,) = self._slot_call(
            cache, "extend_nod", len(toks_b),
            {"toks": np.asarray(toks_b)[None], "pos": pos_b,
             "seq_len": np.int32(seq_len)}, to_host=False)
        return cache, hidden, None

    def exact_or_padded(self, pos: np.ndarray, toks: np.ndarray):
        """Positions and tokens of an extend: bucket-padded where the
        family is ``pad_safe``; at exact length where a pad token would
        fold into a carried recurrent state.  -> (pos_b, toks_b)."""
        toks = np.asarray(toks, np.int32)
        if not self.pad_safe:
            return pos, toks
        return self.bucket_pad(pos, self.pad_slot), self.bucket_pad(toks, 0)

    def extend(self, cache, prompt: np.ndarray, n0: int):
        """Append ``prompt`` at positions [n0, n0+M) of a slot cache, in
        its graph at the token bucket (a family that is not
        ``pad_safe``: at M) -> (cache with pos = n0 + M, last-token
        logits, per-position density mass)."""
        return self._extend(cache, prompt, n0)

    def recompute_whole(self, cache, toks: np.ndarray):
        """``lmk``'s whole recompute: the text ``toks`` at [0, n) into a
        slot cache through the extend entry, its logits unused.
        -> (cache with pos = n, per-position density mass)."""
        cache, _, dens = self._extend(cache, toks, 0)
        return cache, dens

    def _extend(self, cache, prompt: np.ndarray, n0: int):
        M = len(prompt)
        pos = np.arange(n0, n0 + M, dtype=np.int32)
        pos_b, toks_b = self.exact_or_padded(pos, prompt)
        logits, dens = self._slot_call(
            cache, "extend", len(toks_b),
            {"toks": toks_b[None], "pos": pos_b,
             "seq_len": np.int32(n0 + M), "last": np.int64([M - 1])})
        return cache, logits[0], dens[0].astype(np.float64)

    def decode(self, cache, tok: int):
        """One token on a slot cache at its ``pos``, in its graph ->
        (cache with pos + 1, logits, per-key mass)."""
        logits, mass = self._slot_call(cache, "decode", 1,
                                       {"toks": np.int64([[tok]])})
        return cache, logits[0], mass[0].astype(np.float64)

    def host_alloc(self, shape: Tuple[int, ...]) -> np.ndarray:
        """A zeroed fp32 host buffer for a sink-less ``LayerFeed`` to
        fill.  Plain memory: ``run_pipelined`` relays such a feed's rows
        into its page-locked sink, and a feed's thread makes no CUDA
        call (the card may be waiting for it)."""
        return np.zeros(shape, np.float32)

    def _sink(self):
        """The pipelined restores' static host side, made at first use:
        per leaf an (L, largest I/O bucket x cs, *dims) fp32 buffer and
        (L,) int32 flag words, page-locked on the card (the flags mapped
        for it: checked here, outside any capture), with the feed's
        ``publish`` and, on the card, page-locked buffers that take a
        restore's status and waits back without a sync of their own."""
        if self._sink_state is None:
            on_card = self.device.type == "cuda"
            L, rows = self.n_layers, self.io_buckets[-1] * self.cs
            bufs = {n: torch.zeros((L, rows, *self.leaf_dims[n]),
                                   dtype=torch.float32, pin_memory=on_card)
                    for n in self.codec.leaves}
            flags = torch.zeros((L,), dtype=torch.int32, pin_memory=on_card)
            readback = None
            if on_card:
                from repro_torch.kernels import feed_gate as kfg
                kfg.device_pointer(flags)
                publish = kfg.publisher(flags)
                readback = (torch.zeros((1,), dtype=torch.int32,
                                        pin_memory=True),
                            torch.zeros((L,), dtype=torch.int64,
                                        pin_memory=True))
            else:
                publish = publish_plain(flags.numpy())
            self._sink_state = {
                "bufs": bufs, "flags": flags, "publish": publish,
                "arrays": {n: t.numpy() for n, t in bufs.items()},
                "readback": readback}
        return self._sink_state

    @property
    def _deadline_s(self) -> float:
        return float(getattr(self.cfg, "swap_deadline_s", None)
                     or PIPELINED_DEADLINE_S)

    def feed_sink(self) -> FeedSink:
        """The sink of the next pipelined restore: the executor's static
        buffers and flags with a new generation (the warm-ups before a
        capture run at generation 0, which the flags hold as made).  A
        timed-out restore's feed that may still write the buffers is
        waited for first, up to the deadline (``SwapTimeoutError``)."""
        stale = self._stale_feed
        if stale is not None:
            if not stale.wait(self._deadline_s):
                raise SwapTimeoutError(
                    "a timed-out pipelined restore's feed still writes the "
                    f"executor's sink after {self._deadline_s}s")
            self._stale_feed = None
        st = self._sink()
        self._gen += 1
        return FeedSink(st["arrays"], st["flags"].numpy(), self._gen,
                        st["publish"])

    def layer_feed(self, paths: Sequence[str], pad_chunks: int = 0,
                   pool=None) -> LayerFeed:
        """A ``LayerFeed`` of the chunk files ``paths`` (+ ``pad_chunks``
        zero chunks) that writes into this executor's sink
        (``feed_sink``), for ``run_pipelined``."""
        return LayerFeed(paths, self.codec.leaves, self.n_layers, self.cs,
                         self.leaf_dims, pad_chunks=pad_chunks, pool=pool,
                         sink=self.feed_sink())

    def run_pipelined(self, feed, toks_b, miss_b, io_pos_b, cache,
                      n_total: int):
        """The Fig.-8 layer-pipelined restore into ``cache`` (in place):
        recompute ``toks_b`` at ``miss_b`` while ``feed`` streams the
        disk chunks' layers for ``io_pos_b``.  On a slot's cache it is
        one replay of the slot's graph at (token bucket, I/O bucket);
        each layer's gate waits on the device for the feed's rows in the
        executor's sink (a feed made by ``layer_feed``; another feed is
        relayed into the sink, ``LayerFeed.attach``), so the host waits
        only once, in the sync after the replay, which releases the GIL
        for the feed's thread.  On the CPU, or on a private cache, the
        same body runs eagerly (``eager_calls`` for the latter).  Not
        re-entrant.  A feed that failed (status 1) is closed and raises
        ``RuntimeError("LayerFeed I/O failed")`` from its error; one that
        published nothing within the deadline (``swap_deadline_s``, else
        ``PIPELINED_DEADLINE_S``, a layer; status 2) is cancelled and
        raises ``SwapTimeoutError``.  Either way every layer ran with the
        rows the sink held, so the caller rewrites every position the
        restore touched, and a mixed cache's quant mask is left as it
        was.  Any other failure closes the feed (its I/O error
        swallowed) and propagates.  Records the wall time, the gates'
        summed wait and layer 0's in ``last_pipelined``.  -> (cache, hidden (1, M, d)
        of the recomputed rows)."""
        if self._pipelining:
            raise RuntimeError("re-entrant pipelined restore")
        self._pipelining = True
        try:
            st = self._sink()
            if feed.sink is None:
                feed.attach(self.feed_sink())
            elif feed.sink.bufs is not st["arrays"]:
                raise ValueError("run_pipelined: the feed writes into "
                                 "another executor's sink")
            host = {"toks": np.asarray(toks_b)[None], "miss": miss_b,
                    "io_pos": io_pos_b, "seq_len": np.int32(n_total),
                    "gen": np.int32(feed.sink.gen),
                    "deadline_ns": np.int64(self._deadline_s * 1e9)}
            n = (len(toks_b), len(io_pos_b) // self.cs)
            t0 = time.perf_counter()
            hidden, status, wait = self._slot_call(
                cache, "pipelined", n, host, to_host=False)
            if st["readback"] is not None:    # no sync of their own
                st["readback"][0].copy_(status, non_blocking=True)
                st["readback"][1].copy_(wait, non_blocking=True)
                status, wait = st["readback"]
            self.sync()
            wall = time.perf_counter() - t0
            code, waited, first = (int(status[0]), int(wait.sum()),
                                   int(wait[0]))
        except BaseException:
            feed.close(raise_errors=False)
            raise
        finally:
            self._pipelining = False
        if code == 2:
            feed.cancel()
            self._stale_feed = feed
            raise SwapTimeoutError(
                f"pipelined restore: a layer's rows were not published "
                f"within {self._deadline_s}s")
        if code:
            feed.close(raise_errors=False)
            raise RuntimeError("LayerFeed I/O failed") from feed.error
        self.last_pipelined = {"wall_s": wall, "feed_wait_s": waited * 1e-9,
                               "first_wait_s": first * 1e-9}
        return cache, hidden

    def _pipelined_body(self, cache, nio: int):
        """The pipelined restore's body over the slot cache ``cache`` at
        ``nio`` I/O chunks: the model's ``recompute_pipelined`` whose
        ``fetch(l)`` is layer l's gate (``ops.feed_gate``: on the card a
        kernel that waits for the feed, on the CPU the plain gate),
        then the copies of the sink's layer-l rows to the device,
        without blocking; its new leaves written back.  -> (hidden (1,
        M, d), status (1,) int32, wait_ns (L,) int64)."""
        model, params, cw = self.model, self.params, self._cw
        dev, L, rows = self.device, self.n_layers, nio * self.cs
        st = self._sink()
        bufs, flags = st["bufs"], st["flags"]

        def body(inp):
            status = torch.zeros((1,), dtype=torch.int32, device=dev)
            wait = torch.zeros((L,), dtype=torch.int64, device=dev)

            def fetch(layer):
                ops.feed_gate(flags, layer, inp["gen"], inp["deadline_ns"],
                              status, wait)
                return {n: b[layer, :rows].to(dev, non_blocking=True)
                        for n, b in bufs.items()}
            new, hidden, _ = model.recompute_pipelined(
                params, inp["toks"], inp["miss"], inp["io_pos"],
                dict(cache), inp["seq_len"], fetch, want_density=False,
                feed_status=status, **cw)
            _write_back(cache, new)
            return hidden, status, wait
        return capturable(body)

    def logits(self, hidden: torch.Tensor) -> np.ndarray:
        return (hidden @ self.model.head_weight(self.params)
                ).to(torch.float32).cpu().numpy()

    # -- paged KV pool ------------------------------------------------- #
    def init_arenas(self):
        """Fresh page arenas — one fixed buffer per leaf.  Page 0 is the
        reserved scratch page every unowned page-table entry points at;
        its contents are garbage after the first write and never
        attended (the causal/seq-len masks zero those positions).  The
        graphs captured over earlier arenas are dropped; on the card
        every bucket of both paged entries is captured over the new ones
        (``core/graphs.py``)."""
        self.graphs.drop()
        arenas = {}
        L, cs, dev = self.n_layers, self.cs, self.device
        for n in self.codec.leaves:
            dims = self.leaf_dims[n]
            arenas[n + "16"] = torch.zeros((L, self.pool_pages16, cs, *dims),
                                           dtype=torch.bfloat16, device=dev)
            if self.quant_resident:
                arenas[n + "8"] = torch.zeros(
                    (L, self.pool_pages8, cs, *dims), dtype=torch.int8,
                    device=dev)
                arenas[n + "8s"] = torch.zeros(
                    (L, self.pool_pages8, cs, *dims[:-1]),
                    dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            for name, buckets in (("extend", self.tok_buckets),
                                  ("decode", self.batch_buckets)):
                for b in buckets:
                    self.graphs.prepare(arenas, *self._paged_entry(
                        name, b, self.quant_resident, arenas))
        return arenas

    def admit16(self, arenas, page: int, blocks):
        """Chunk-file block layout (cs, L*prod(dims)) -> page layout
        (L, cs, *dims), written into ``arenas[<leaf>16][:, page]``."""
        cs, nl = self.cs, self.n_layers
        for n in self.codec.leaves:
            t = blocks[n].reshape(cs, nl, *self.leaf_dims[n]).movedim(0, 1)
            arenas[n + "16"][:, page] = t.to(arenas[n + "16"].dtype)
        return arenas

    def admit8(self, arenas, page: int, codes, scales):
        """Decode-grid payload (codes (cs, F) int8, scales (cs, F // hd)
        fp32 host arrays) -> QUANT page ``arenas[<leaf>8|8s][:, page]``."""
        cs, nl, dev = self.cs, self.n_layers, self.device
        for n in self.codec.leaves:
            dims = self.leaf_dims[n]
            c = torch.from_numpy(codes[n]).to(dev).reshape(cs, nl, *dims)
            arenas[n + "8"][:, page] = c.movedim(0, 1)
            sc = torch.from_numpy(scales[n]).to(dev).reshape(cs, nl,
                                                             *dims[:-1])
            arenas[n + "8s"][:, page] = sc.movedim(0, 1)
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

    def _paged_entry(self, name: str, bucket: int, quant: bool, arenas):
        """A paged entry at a bucket: its cache key, its static inputs
        {name: (shape, dtype)} and the maker of its body.  Both entries
        take tokens, positions, page-table rows (rows, C) and, under
        quant_resident, the int8 rows and the quant mask; the extend (one
        row of ``bucket`` tokens) also seq_len and its last real row."""
        rows, n_tok = (1, bucket) if name == "extend" else (bucket, 1)
        C, i64 = self.pages_per_ctx, torch.int64
        spec = {"toks": ((rows, n_tok), i64), "pos": ((bucket,), i64),
                "pt16": ((rows, C), i64)}
        if quant:
            spec["pt8"] = ((rows, C), i64)
            spec["qmask"] = ((rows, C), torch.bool)
        if name == "extend":
            spec["seq_len"] = ((), torch.int32)
            spec["last"] = ((1,), i64)
            make = lambda: self._extend_body(arenas)     # noqa: E731
        else:
            make = lambda: self._decode_body(arenas)     # noqa: E731
        return (name, bucket, quant), spec, make

    def _extend_body(self, bufs, slot: bool = False, density: bool = True):
        """An extend's body over the static inputs: ``paged_extend``'s
        (the model's ``extend_paged`` over the arenas ``bufs``), or with
        ``slot`` the slot engine's (the model's ``recompute`` over the
        slot cache ``bufs``, its new leaves written back, ``pos`` set to
        ``seq_len``), then the head product of the last real row (a
        device index: it moves within the bucket).  -> (logits (1, V)
        fp32, density (1, S)); a slot's ``extend_nod`` (no ``density``)
        -> (hidden (1, M, d),)."""
        model, params, cw = self.model, self.params, self._cw
        head = model.head_weight(params)

        def body(inp):
            if slot:
                new, hidden, dens = model.recompute(
                    params, inp["toks"], inp["pos"], dict(bufs),
                    inp["seq_len"], want_density=density, **cw)
                _write_back(bufs, new)
                if not density:
                    return (hidden,)
                bufs["pos"].copy_(inp["seq_len"])
            else:
                _, hidden, dens = model.extend_paged(
                    params, inp["toks"], inp["pos"], bufs, inp["pt16"],
                    inp["seq_len"], want_density=True, pt8=inp.get("pt8"),
                    quant_chunks=inp.get("qmask"), **cw)
            last = hidden.index_select(1, inp["last"])[:, 0]
            return (last @ head).to(torch.float32), dens
        return capturable(body)

    def _decode_body(self, bufs, slot: bool = False):
        """A decode's body over the static inputs: ``paged_decode``'s
        (the model's ``decode_paged`` over the arenas ``bufs``), or with
        ``slot`` the slot engine's (the model's ``decode_step`` at the
        slot cache's ``pos``, its new leaves written back); the head
        product included.  -> (logits (nb, V) fp32, mass (nb, S))."""
        model, params, cw = self.model, self.params, self._cw

        def body(inp):
            if slot:
                out, mass = model.decode_step(
                    params, inp["toks"], dict(bufs), want_density=True,
                    **cw)
                _write_back(bufs, out.cache)
                return out.logits, mass
            _, logits, mass = model.decode_paged(
                params, inp["toks"], bufs, inp["pt16"], inp["pos"],
                want_density=True, pt8=inp.get("pt8"),
                quant_chunks=inp.get("qmask"), **cw)
            return logits, mass
        return capturable(body)

    def paged_extend(self, arenas, prompt: np.ndarray, n0: int, pt16,
                     pt8=None, qmask=None):
        """Append ``prompt`` at [n0, n0+M) for the single context whose
        page-table row is ``pt16[0]`` (and ``pt8[0]`` / ``qmask[0]``
        under quant_resident), in the token bucket's graph.  Padded
        positions land on the scratch page 0.  -> (arenas, last-token
        logits, per-position density mass)."""
        M = len(prompt)
        pos = np.arange(n0, n0 + M, dtype=np.int32)
        pos_b = self.bucket_pad(pos, self.pad_slot)
        toks_b = self.bucket_pad(np.asarray(prompt, np.int32), 0)
        quant = pt8 is not None
        host = {"toks": toks_b[None], "pos": pos_b, "pt16": pt16,
                "seq_len": np.int32(n0 + M), "last": np.int64([M - 1])}
        if quant:
            host.update(pt8=pt8, qmask=qmask)
        logits, dens = self.graphs.run(
            arenas, *self._paged_entry("extend", len(toks_b), quant, arenas),
            host)
        return arenas, logits[0], dens[0].astype(np.float64)

    def paged_decode(self, arenas, toks: Sequence[int], pos: Sequence[int],
                     pt16, pt8=None, qmask=None):
        """One decode round for n contexts over the pool, in the batch
        bucket's graph: row i advances by ``toks[i]`` at its own position
        ``pos[i]``.  Pad rows get the all-zero page-table row (scratch
        page) and are sliced off the outputs.  -> (arenas, logits [n, V],
        density-mass [n, S])."""
        n = len(toks)
        nb = next(b for b in self.batch_buckets if b >= n)
        toks_b = np.zeros((nb, 1), np.int32)
        toks_b[:n, 0] = toks
        pos_b = np.zeros(nb, np.int32)
        pos_b[:n] = pos
        C = pt16.shape[1]
        pt16_b = np.zeros((nb, C), np.int32)
        pt16_b[:n] = pt16
        quant = pt8 is not None
        host = {"toks": toks_b, "pos": pos_b, "pt16": pt16_b}
        if quant:
            host["pt8"] = np.zeros((nb, C), np.int32)
            host["pt8"][:n] = pt8
            host["qmask"] = np.zeros((nb, C), bool)
            host["qmask"][:n] = qmask
        logits, mass = self.graphs.run(
            arenas, *self._paged_entry("decode", nb, quant, arenas), host)
        return arenas, logits[:n], mass[:n].astype(np.float64)
