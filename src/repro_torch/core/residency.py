"""Residency engine — switch-in/switch-out of context state (paper §3).

Mirror of the JAX package's core/residency.py for the paged pool:
decides where every chunk lives (bf16 pool page / compressed DRAM
payload / disk) and moves it.  Switch-in is a page-table read plus
first-admission page faults and the disk restore of missing chunks
(the timed QoS path).  Switch-out runs the tolerance-aware compression
(Eq. 1-3) through the chunk codec kernels and the ahead-of-time
swap-out (§3.4).  Eviction implements the Reclaim primitive over the
LCTRU order.

The chunk codec runs here: ``_encode_blocks`` quantizes at every
switch-out of a compressed chunk, ``_payload_blocks`` dequantizes at
every admission of one.  The page arenas are updated in place.

Not ported yet (ROADMAP.md): the slot engine's assembly and its
layer-pipelined restore, the quant-resident tier, and whole-state
restore for non-chunked policies.
"""
from __future__ import annotations

import errno
import math
import os
import time
from collections import OrderedDict
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.markers import requires_serialized
from repro_torch.analysis.runtime import witness_lock
from repro_torch.core import compression as comp
from repro_torch.core.chunks import (ChunkMeta, CompressedChunk,
                                     QuantResidentChunk, block_shapes)
from repro_torch.core.context_store import Context, ContextStore
from repro_torch.core.executor import ModelExecutor
from repro_torch.core.faults import (FAULTS, ChunkCorruptError, DiskFullError,
                                     SwapTimeoutError, with_retries)
from repro_torch.core.lifecycle import LCTRUQueue, MemoryManager
from repro_torch.core.pagepool import BF16, PagePool
from repro_torch.core.pipeline import PipelineProfile, fit_linear
from repro_torch.core.restore import read_chunk_file, write_chunk_file
from repro_torch.core.swap import AsyncSwapper, DiskStore


class SlotAllocator:
    """The working-set "lock" generalized to B decode slots (copy of the
    reference).  A slot is HELD while a generation is resident on it;
    switching out PARKS it; acquiring with none free reclaims the
    least-recently-parked idle slot."""

    def __init__(self, n_slots: int):
        self.n_slots = max(1, int(n_slots))
        self._free = list(range(self.n_slots - 1, -1, -1))
        self.held: Dict[int, int] = {}                   # cid -> slot
        self.idle: "OrderedDict[int, int]" = OrderedDict()  # cid -> slot, LRU

    def acquire(self, cid: int,
                on_evict: Optional[Callable[[int], None]] = None) -> int:
        if cid in self.held:
            raise RuntimeError(f"ctx {cid} already holds a slot")
        if cid in self.idle:
            slot = self.idle.pop(cid)
        elif self._free:
            slot = self._free.pop()
        elif self.idle:
            victim, slot = self.idle.popitem(last=False)
            if on_evict is not None:
                on_evict(victim)
        else:
            raise RuntimeError(
                f"all {self.n_slots} decode slots are held by in-flight "
                "generations; suspend one before switching another in")
        self.held[cid] = slot
        return slot

    def park(self, cid: int):
        self.idle[cid] = self.held.pop(cid)

    def release(self, cid: int):
        slot = self.held.pop(cid, None)
        if slot is None:
            slot = self.idle.pop(cid, None)
        if slot is not None:
            self._free.append(slot)


class ResidencyEngine:
    """Paged switch-in + chunk admission + compress/AoT swap-out."""

    def __init__(self, exe: ModelExecutor, ctxs: ContextStore,
                 store: DiskStore, swapper: AsyncSwapper,
                 queue: LCTRUQueue, mem: MemoryManager, cfg):
        self.exe = exe
        self.ctxs = ctxs
        self.store = store
        self.swapper = swapper
        self.queue = queue
        self.mem = mem
        self.cfg = cfg
        self.slots = SlotAllocator(exe.decode_slots)
        # pages SURVIVE switch-out: the next switch-in is a table read
        self.pool = PagePool(exe, ctxs)
        self.profile = PipelineProfile()
        self.profiled = False
        self.epoch = 0                      # bumped on any eviction
        # contexts that may hold dirty (unflushed) chunks (§3.4 hook)
        self._dirty_cids: set = set()
        # -- fault tolerance (DESIGN.md §6) ---------------------------- #
        # recovery ladder: retry (AsyncSwapper) -> recompute (here) ->
        # degrade (ENOSPC) -> fail.  Flags and counters written from the
        # dispatcher and the swapper's IO threads go through _flags_lock.
        self._flags_lock = witness_lock("residency.flags")
        self.aot_enabled = True
        self.degraded = False
        self.degraded_entries = 0
        self.degraded_exits = 0
        self._degrade_ticks = 0
        self.chunks_recovered_recompute = 0
        self.chunks_corrupt_detected = 0
        self.io_errors_detected = 0
        self.evict_dropped = 0
        self.recover_failed = 0
        swapper.on_job_error = self._on_io_error

    # ------------------------------------------------------------------ #
    # failure detection + degraded mode (DESIGN.md §6)
    # ------------------------------------------------------------------ #
    @property
    def _deadline(self) -> Optional[float]:
        return getattr(self.cfg, "swap_deadline_s", None)

    def _fut_result(self, fut: Future):
        try:
            return fut.result(self._deadline)
        except _FutTimeout:
            raise SwapTimeoutError(
                f"swap read exceeded {self._deadline}s") from None

    def _note_read_failure(self, err: BaseException):
        with self._flags_lock:
            if isinstance(err, ChunkCorruptError):
                self.chunks_corrupt_detected += 1
            else:
                self.io_errors_detected += 1

    def _on_io_error(self, key, err: BaseException):
        if isinstance(err, OSError) and err.errno == errno.ENOSPC:
            self._enter_degraded()

    def _enter_degraded(self):
        with self._flags_lock:
            if not self.degraded:
                self.degraded = True
                self.aot_enabled = False
                self.degraded_entries += 1
                self._degrade_ticks = 0

    @requires_serialized
    def degraded_tick(self):
        """Every 4th switch-out while degraded, probe the disk; success
        re-enables AoT and flushes what accumulated dirty."""
        with self._flags_lock:
            if not self.degraded:
                return
            self._degrade_ticks += 1
            if self._degrade_ticks % 4:
                return
        probe = (-3, "probe")
        try:
            self.store.write(probe, b"ok")
            self.store.delete(probe)
        except OSError:
            return
        with self._flags_lock:
            self.degraded = False
            self.aot_enabled = True
            self.degraded_exits += 1
        if self.cfg.use_disk and self.cfg.chunked:
            for cid in sorted(self._dirty_cids):
                ctx = self.ctxs.contexts.get(cid)
                if ctx is not None:
                    self.flush_dirty(ctx)

    def fault_stats(self) -> Dict[str, Any]:
        c = FAULTS.counters()
        return {
            "degraded_mode": int(self.degraded),
            "degraded_entries": self.degraded_entries,
            "degraded_exits": self.degraded_exits,
            "chunks_recovered_recompute": self.chunks_recovered_recompute,
            "chunks_corrupt_detected": self.chunks_corrupt_detected,
            "io_errors_detected": self.io_errors_detected,
            "evict_dropped": self.evict_dropped,
            "recover_failed": self.recover_failed,
            "io_retries": self.swapper.io_retries,
            "io_recovered": self.swapper.io_recovered,
            "io_failed_jobs": self.swapper.io_failed,
            "tmp_files_swept": self.store.tmp_swept,
            "delete_errors": self.store.delete_errors,
            "faults_injected_total": c["injected_total"],
            "faults_injected": c["injected"],
        }

    # ------------------------------------------------------------------ #
    # switch-in: a page-table read plus first-admission faults
    # ------------------------------------------------------------------ #
    @requires_serialized
    def switch_in(self, ctx: Context) -> Tuple[None, float]:
        """Pool-mode switch-in.  Chunks whose pages survive cost nothing
        (their table entries are read at decode time); in-memory chunks
        without pages are admitted once (the page fault: payload ->
        dequantize -> page); missing chunks are restored from disk
        first (the timed QoS path).  -> (None, seconds)."""
        exe, pool = self.exe, self.pool
        pool.table(ctx.cid)
        pool.touch(ctx.cid)
        if ctx.n_tokens == 0:
            return None, 0.0

        # ---- untimed: resident chunks (table read / first admission) -- #
        admitted = 0
        for i, m in sorted(ctx.chunks.items()):
            if m.in_memory:
                if pool.kind(ctx.cid, i) == 0:
                    self._admit_chunk(ctx, i)
                    admitted += 1
                else:
                    pool.pt_switch_ins += 1
                self.queue.touch((ctx.cid, i), m.bits)
                m.last_access = time.time()
        pool.admit_switch_ins += admitted

        # ---- timed: reclaim + disk restore of missing chunks ---------- #
        t0 = time.perf_counter()
        missing = sorted(i for i, m in ctx.chunks.items() if not m.in_memory)
        if missing:
            need = sum(ctx.chunks[i].nbytes for i in missing)
            self.mem.reclaim(need, self.evict, locked={ctx.cid})
            # I/O-first restore; after a storage fault the recovery
            # ladder recomputes the chunk from its tokens in ascending
            # order (each recompute attends the already-restored prefix)
            futs = {i: self._read_chunk_async((ctx.cid, i))
                    for i in missing if ctx.chunks[i].on_disk}
            for i in missing:
                cc = None
                if i in futs:
                    try:
                        cc = self._fut_result(futs[i])
                    except SwapTimeoutError:
                        raise
                    except (ChunkCorruptError, OSError) as err:
                        self._note_read_failure(err)
                if cc is not None:
                    self._mark_loaded(ctx, i, payload=cc)
                    # a surviving page (evicted-while-busy chunk) already
                    # holds exactly this payload's values — skip the admit
                    if pool.kind(ctx.cid, i) == 0:
                        self._admit_chunk(ctx, i)
                else:
                    self._recover_chunk_paged(ctx, i)
        if (admitted or missing) and exe.device.type == "cuda":
            torch.cuda.synchronize(exe.device)
        return None, time.perf_counter() - t0

    def _admit_chunk(self, ctx: Context, i: int):
        """Page-fault one in-memory chunk into a bf16 page: bf16-raw
        payloads convert, packed payloads dequantize (the chunk codec's
        dequantize kernel on the card)."""
        blocks = self._payload_blocks(ctx.payload[i])
        page = self.pool.alloc16(ctx.cid, i)
        self.pool.arenas = self.exe.admit16(self.pool.arenas, page, blocks)
        self.pool.page_faults += 1

    def ensure_extend_range(self, ctx: Context, c_lo: int, c_hi: int):
        """Give chunks [c_lo, c_hi] writable bf16 pages ahead of a paged
        prefill-append: fresh tail chunks get zeroed pages; a chunk with
        a payload but no page is admitted from it."""
        pool = self.pool
        for ci in range(c_lo, c_hi + 1):
            k = pool.kind(ctx.cid, ci)
            if k == BF16:
                continue
            if ci in ctx.payload:
                blocks = self._payload_blocks(ctx.payload[ci])
                pool.free_chunk(ctx.cid, ci)
                page = pool.alloc16(ctx.cid, ci)
                pool.arenas = self.exe.admit16(pool.arenas, page, blocks)
                pool.page_faults += 1
            else:
                self._alloc_fresh16(ctx.cid, ci)

    def ensure_tail(self, ctx: Context, ci: int):
        """Give the decode tail chunk a writable bf16 page."""
        if self.pool.kind(ctx.cid, ci) == 0:
            self._alloc_fresh16(ctx.cid, ci)

    def _alloc_fresh16(self, cid: int, ci: int):
        """Allocate AND zero a fresh bf16 page: recycled pages hold their
        previous owner's data, and never-written positions must be
        exactly zero (some are attended and encoded)."""
        page = self.pool.alloc16(cid, ci)
        self.pool.arenas = self.exe.zero16(self.pool.arenas, page)

    # -- recompute-based recovery (ladder step 2, DESIGN.md §6) -------- #
    @staticmethod
    def _hole_segments(ctx: Context, lo: int, hi: int
                       ) -> List[Tuple[int, int]]:
        """Token ranges of [lo, hi) between KV holes (each call's final
        emitted token was never fed through the model)."""
        segs, a = [], lo
        for h in sorted(x for x in ctx.kv_holes if lo <= x < hi):
            if h > a:
                segs.append((a, h))
            a = h + 1
        if hi > a:
            segs.append((a, hi))
        return segs

    def _recompute_blocks_paged(self, ctx: Context, i: int):
        """Recompute chunk ``i``'s KV into a fresh zeroed bf16 page from
        the context's tokens and read it back as (cs, F) blocks.  The
        prefix chunks must be resident (callers go in ascending order)."""
        exe, pool = self.exe, self.pool
        m = ctx.chunks[i]
        cs = exe.cs
        lo = i * cs
        covered = m.n_covered or min(ctx.n_tokens - lo, cs)
        if pool.kind(ctx.cid, i) != 0:
            pool.free_chunk(ctx.cid, i)
        self._alloc_fresh16(ctx.cid, i)
        pt16, _, _ = pool.rows([ctx.cid])
        for a, b in self._hole_segments(ctx, lo, lo + covered):
            toks = np.asarray(ctx.tokens[a:b], np.int32)
            pool.arenas, _, _ = exe.paged_extend(pool.arenas, toks, a, pt16)
        page = int(pool._tables[ctx.cid]["p16"][i])
        return exe.read16(pool.arenas, page)

    @requires_serialized
    def _recover_chunk_paged(self, ctx: Context, i: int):
        """The disk copy is missing/corrupt/unreadable after retries:
        recompute the chunk from tokens, re-encode it at its assigned
        level, re-admit FROM THE PAYLOAD, and rewrite it unless
        degraded."""
        if not self.exe.recomputable:
            with self._flags_lock:
                self.recover_failed += 1
            raise ChunkCorruptError(
                f"ctx {ctx.cid} chunk {i}: disk copy unreadable and "
                f"family {self.exe.model.cfg.family!r} cannot recompute")
        m = ctx.chunks[i]
        if self.pool.kind(ctx.cid, i) == BF16:
            # the page survived the eviction (busy context): it holds
            # the authoritative values — rebuild the payload from it
            page = int(self.pool._tables[ctx.cid]["p16"][i])
            blocks = self.exe.read16(self.pool.arenas, page)
        else:
            blocks = self._recompute_blocks_paged(ctx, i)
        cc = self._encode_blocks(blocks, m.bits)
        ctx.payload[i] = cc
        ctx.qmemo.pop(i, None)
        m.quant = False
        m.nbytes = cc.nbytes
        m.in_memory = True
        self.pool.free_chunk(ctx.cid, i)
        if (self.cfg.use_disk and self.aot_enabled
                and self._write_chunk_async(ctx.cid, i, cc)):
            m.dirty, m.on_disk = False, True
        else:
            m.dirty, m.on_disk = True, False
            self._dirty_cids.add(ctx.cid)
        self.mem.register((ctx.cid, i), m.nbytes, m.bits)
        self._admit_chunk(ctx, i)
        with self._flags_lock:
            self.chunks_recovered_recompute += 1

    def _read_chunk_async(self, key):
        """Read a chunk file on the I/O pool, ORDERED AFTER any in-flight
        same-key AoT write (``flush_dirty`` marks ``on_disk`` at submit
        time, so a direct read would race the writer's ``os.replace``)."""
        return self.swapper.submit(key, read_chunk_file,
                                   self.store._path(key))

    def _read_chunk(self, key):
        """Synchronous chunk-file read behind any in-flight same-key
        write, with the worker retry budget for transient IO errors."""
        self.swapper.wait(key, timeout=self._deadline)

        def _on_retry(_k, _e):
            self.swapper.note_retry()

        return with_retries(lambda: read_chunk_file(self.store._path(key)),
                            attempts=self.swapper.retries,
                            base_s=self.swapper.retry_base_s,
                            on_retry=_on_retry)

    @requires_serialized
    def _mark_loaded(self, ctx, i: int, payload):
        if payload is None:
            payload = self._read_chunk((ctx.cid, i))
        ctx.payload[i] = payload
        ctx.qmemo.pop(i, None)
        m = ctx.chunks[i]
        m.in_memory, m.dirty = True, False
        m.quant = isinstance(payload, QuantResidentChunk)
        self.mem.register((ctx.cid, i), m.nbytes, m.bits)

    # -- payload codecs ------------------------------------------------- #
    def _payload_blocks(self, cc) -> Dict[str, torch.Tensor]:
        """Payload -> (T, F) bf16 blocks on the device."""
        if isinstance(cc, QuantResidentChunk):
            raise NotImplementedError(
                "decode-grid payloads (quant-resident tier) are not ported "
                "(ROADMAP.md)")
        if cc.bits == 16:
            dev = self.exe.device
            return {k: torch.from_numpy(p).to(dev).to(torch.bfloat16)
                    for k, (p, _) in cc.data.items()}
        return self.exe.codec.decompress(cc)

    def _encode_blocks(self, blocks, bits: int) -> CompressedChunk:
        """(T, F) blocks -> storage payload at ``bits``.  16-bit payloads
        are fp16 numpy converted bf16 -> fp32 -> fp16, byte-identical to
        the reference's."""
        if bits == 16:
            return CompressedChunk(
                bits=16, n_tokens=int(next(iter(blocks.values())).shape[0]),
                data={k: (v.to(torch.float32).cpu().numpy()
                          .astype(np.float16), np.zeros(0, np.float32))
                      for k, v in blocks.items()},
                shapes=block_shapes(blocks))
        return self.exe.codec.compress_blocks(blocks, bits)

    def _make_payload(self, cache, i: int, bits: int) -> CompressedChunk:
        """Encode chunk i from a window cache (``profile_pipeline``)."""
        cs = self.exe.cs
        return self._encode_blocks(
            self.exe.codec.extract(cache, i * cs, (i + 1) * cs), bits)

    def _make_payload_paged(self, ctx: Context, i: int, bits: int):
        """Encode chunk i from the pool.  A bf16 page is read back; an
        unadmitted chunk re-encodes from its existing payload (or its
        disk copy, or — never written at all — the zero block)."""
        exe, pool = self.exe, self.pool
        if pool.kind(ctx.cid, i) == BF16:
            page = int(pool._tables[ctx.cid]["p16"][i])
            blocks = exe.read16(pool.arenas, page)
        else:
            cc = ctx.payload.get(i)
            if cc is not None:
                blocks = self._payload_blocks(cc)
            elif ctx.chunks[i].on_disk:
                # evicted out from under a busy context by another
                # context's reclaim — eviction wrote it to disk first
                blocks = self._payload_blocks(
                    self._read_chunk((ctx.cid, i)))
            else:
                # never written: its only tokens are emitted-but-never-
                # decoded, and the reference encodes the zero cache here
                blocks = {n: torch.zeros(
                    (exe.cs, int(np.prod(
                        [s for a, s in enumerate(exe.leaf_shapes[n])
                         if a != 2]))), dtype=torch.bfloat16,
                    device=exe.device)
                    for n in exe.codec.leaves}
        return self._encode_blocks(blocks, bits)

    # ------------------------------------------------------------------ #
    # compress + AoT swap-out (Reclaim is then free)
    # ------------------------------------------------------------------ #
    @requires_serialized
    def compress_and_swap_out(self, ctx: Context, cache=None):
        cfg = self.cfg
        cs = self.exe.cs
        n_chunks = math.ceil(ctx.n_tokens / cs)
        if cfg.compression == "tolerance":
            D = comp.chunk_density(ctx.density_sum, ctx.density_cnt,
                                   ctx.n_tokens, cs)
            bits = comp.plan_buckets(D, cfg.ratio_global, cfg.levels)
        elif cfg.compression == "static8":
            D = np.zeros(n_chunks)
            bits = np.full(n_chunks, 8, np.int64)
        else:
            D = np.zeros(n_chunks)
            bits = np.full(n_chunks, 16, np.int64)
        # the family's Eq.-3 floor (KVSpec.min_bits)
        bits = np.maximum(bits, self.exe.spec.min_bits)

        for i in range(n_chunks):
            m = ctx.chunks.get(i)
            if m is None:
                m = ChunkMeta(idx=i)
                ctx.chunks[i] = m
            want = int(bits[i])
            m.density = float(D[i])
            covered = min(ctx.n_tokens - i * cs, cs)
            if (m.dirty or want != m.bits or i not in ctx.payload
                    or covered != m.n_covered or m.quant):
                try:
                    cc = self._make_payload_paged(ctx, i, want)
                except (ChunkCorruptError, OSError) as err:
                    # the encode needed an unreadable disk copy: leave the
                    # chunk MISSING; the next switch-in recovers it with
                    # the prefix resident (recovery ladder §6)
                    self._note_read_failure(err)
                    m.bits, m.n_covered = want, covered
                    m.density = float(D[i])
                    m.quant = False
                    m.dirty, m.in_memory, m.on_disk = False, False, False
                    ctx.payload.pop(i, None)
                    ctx.qmemo.pop(i, None)
                    self.pool.free_chunk(ctx.cid, i)
                    self.mem.unregister((ctx.cid, i))
                    continue
                # drop-on-encode: the page now disagrees with the
                # canonical payload (re-encoding is lossy), so free it
                self.pool.free_chunk(ctx.cid, i)
                ctx.payload[i] = cc
                ctx.qmemo.pop(i, None)
                m.bits, m.nbytes, m.n_covered = want, cc.nbytes, covered
                m.quant = False
                m.dirty, m.in_memory, m.on_disk = True, True, False
                self._dirty_cids.add(ctx.cid)
                # AoT re-admit: pay the page write NOW, at switch-out, so
                # the next switch-in is a pure page-table read of exactly
                # the payload-roundtrip values.  Best-effort: an
                # exhausted pool leaves the chunk for a later fault.
                try:
                    self._admit_chunk(ctx, i)
                except RuntimeError:
                    pass
            self.mem.register((ctx.cid, i), m.nbytes, m.bits)
            m.last_access = time.time()

        if cfg.use_aot and cfg.use_disk:
            self.flush_dirty(ctx)
        self.degraded_tick()

    @requires_serialized
    def flush_dirty(self, ctx: Context) -> int:
        """AoT swap-out (§3.4): asynchronously write every dirty chunk so
        a later Reclaim is free.  Returns chunks submitted.  Disabled
        while degraded."""
        if not self.aot_enabled:
            return 0
        n = 0
        for i, m in ctx.chunks.items():
            if m.dirty and i in ctx.payload:
                if not self._write_chunk_async(ctx.cid, i, ctx.payload[i]):
                    break               # disk full: stop, chunks stay dirty
                m.dirty, m.on_disk = False, True
                n += 1
        if not any(m.dirty for m in ctx.chunks.values()):
            self._dirty_cids.discard(ctx.cid)
        return n

    @requires_serialized
    def prepare_switch(self, predicted_cid: int) -> int:
        """Next-context prediction hint (§3.4): protect the predicted
        context's resident chunks in the LCTRU order and flush dirty
        chunks of every OTHER context ahead of time."""
        pred = self.ctxs.contexts.get(predicted_cid)
        if pred is not None:
            for i, m in pred.chunks.items():
                if m.in_memory:
                    self.queue.touch((pred.cid, i), m.bits)
        if not (self.cfg.use_disk and self.cfg.chunked):
            return 0
        flushed = 0
        for cid in sorted(self._dirty_cids):
            if cid == predicted_cid:
                continue
            ctx = self.ctxs.contexts.get(cid)
            if ctx is None:                     # deleted since marked
                self._dirty_cids.discard(cid)
                continue
            flushed += self.flush_dirty(ctx)
        return flushed

    def _write_chunk_async(self, cid: int, idx: int,
                           cc: CompressedChunk) -> bool:
        """Submit an AoT chunk write; False when the disk is full (the
        chunk must stay dirty).  ENOSPC surfaces here, on the submitting
        thread, so degraded-mode entry is deterministic."""
        key = (cid, idx)
        if FAULTS.disk_full:
            self.swapper.note_io_failure()
            self._on_io_error(key, DiskFullError(
                f"disk full (write {key})"))
            return False
        path = self.store._path(key)

        def work():
            n = write_chunk_file(path, cc, self.exe.n_layers)
            self.store.set_bytes(key, n)
        self.swapper.submit(key, work)
        return True

    # ------------------------------------------------------------------ #
    # eviction (Reclaim primitive)
    # ------------------------------------------------------------------ #
    @requires_serialized
    def evict(self, key):
        cid, idx = key
        self.epoch += 1
        ctx = self.ctxs.contexts.get(cid)
        if ctx is None:
            return
        m = ctx.chunks.get(idx)
        if m is None:
            return
        if m.dirty:                         # no-AoT policies pay here (sync)
            ok = False
            if not self.degraded:           # degraded: every write fails
                try:
                    n = with_retries(
                        lambda: write_chunk_file(self.store._path(key),
                                                 ctx.payload[idx],
                                                 self.exe.n_layers),
                        attempts=self.swapper.retries,
                        base_s=self.swapper.retry_base_s)
                    self.store.set_bytes(key, n)
                    ok = True
                except OSError as err:
                    if getattr(err, "errno", None) == errno.ENOSPC:
                        self._enter_degraded()
            if not ok:
                # the chunk stays recomputable from tokens: drop the
                # payload and let the next switch-in recompute
                self.evict_dropped += 1
                m.dirty, m.on_disk, m.in_memory = False, False, False
                ctx.payload.pop(idx, None)
                ctx.qmemo.pop(idx, None)
                if not ctx.busy:
                    self.pool.free_chunk(cid, idx)
                return
            m.dirty = False
        m.on_disk, m.in_memory = True, False
        ctx.payload.pop(idx, None)
        ctx.qmemo.pop(idx, None)
        # a busy context's pages are its authoritative state: its own
        # swap-out re-encodes and drops them
        if not ctx.busy:
            self.pool.free_chunk(cid, idx)

    # ------------------------------------------------------------------ #
    @requires_serialized
    def profile_pipeline(self, n_points: Tuple[int, ...] = (1, 2, 4)):
        """Paper §3.3.i: one-shot installation-time profiling of T_re
        (recompute of x chunks) and T_IO (chunk-file reads)."""
        exe = self.exe
        if not (exe.recomputable and exe.chunked_cache):
            return
        on_card = exe.device.type == "cuda"
        toks = np.ones(exe.n_slots, np.int32)
        xs, ts = [], []
        for x in n_points:
            M = x * exe.cs
            pos_b = exe.bucket_pad(np.arange(M, dtype=np.int32),
                                   exe.pad_slot)
            toks_b = exe.bucket_pad(toks[:M], 0)
            exe.extend_nod(toks_b, pos_b, exe.fresh_cache(0), M)   # warm-up
            cache = exe.fresh_cache(0)
            if on_card:
                torch.cuda.synchronize(exe.device)
            t0 = time.perf_counter()
            exe.extend_nod(toks_b, pos_b, cache, M)
            if on_card:
                torch.cuda.synchronize(exe.device)
            ts.append(time.perf_counter() - t0)
            xs.append(x)
        self.profile.re_base, self.profile.re_per_chunk = fit_linear(xs, ts)

        cc = self._make_payload(exe.fresh_cache(0), 0, 8)
        ios_x, ios_t = [], []
        for n in (1, 2, 4):
            paths = [self.store._path((-2, f"probe{j}")) for j in range(n)]
            for p in paths:
                write_chunk_file(p, cc, exe.n_layers)
            t0 = time.perf_counter()
            for p in paths:
                read_chunk_file(p)
            ios_t.append(time.perf_counter() - t0)
            ios_x.append(n * cc.nbytes)
            for p in paths:
                os.remove(p)
        self.profile.io_base, self.profile.io_per_byte = \
            fit_linear(ios_x, ios_t)
        self.profiled = True
