"""Residency engine — switch-in/switch-out of context state (paper §3).

Mirror of the JAX package's core/residency.py: decides where every
chunk lives (bf16 working cache or pool page / compressed DRAM payload
/ disk) and moves it.  Switch-in plans the I/O-vs-recompute split
(Eq. 4, ``_plan_restore``), runs the layer-pipelined restore (Fig. 8,
``_restore_pipelined``) and assembles resident chunks into a slot cache;
with the paged pool it is a page-table read plus first-admission page
faults and the disk restore of missing chunks.  Switch-out runs the
tolerance-aware compression (Eq. 1-3) through the chunk codec kernels
and the ahead-of-time swap-out (§3.4).  The whole-state policies
(``swap``, ``lmk``), and every policy over a constant-size recurrent
state (RWKV6: ``WholeStateCodec``), snapshot a context's whole state as
one blob (16-bit leaves as fp16, fp32 leaves exact) and restore it by a
read (``swap``) or by recomputing the whole text (``lmk``,
``_restore_whole_timed``).  Eviction implements the Reclaim primitive
over the LCTRU order; under a zoo's shared budget a key another member
owns goes to that member (``route_evict``).

The chunk codec runs here: ``_encode_blocks`` quantizes at every
switch-out of a compressed chunk, ``_payload_blocks`` dequantizes at
every admission or assembly of one.  With ``quant_resident`` an 8-bit
chunk is promoted to a decode-grid payload that is attended in place
(a QUANT page, or the int8 segments of a mixed slot cache); 4/2-bit
chunks are dequantized through the codec kernel and re-gridded to int8
(``qmemo``).  Caches and page arenas are updated in place: a restore
writes into the cache it is given.
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
from repro_torch.core.executor import PROFILE_CHUNKS, ModelExecutor
from repro_torch.core.faults import (FAULTS, ChunkCorruptError, DiskFullError,
                                     SwapTimeoutError, with_retries)
from repro_torch.core.lifecycle import LCTRUQueue, MemoryManager
from repro_torch.core.pagepool import BF16, QUANT, PagePool
from repro_torch.core.pipeline import PipelineProfile, fit_linear, plan_split
from repro_torch.core.restore import (read_chunk_file,
                                      verify_chunk_file, write_chunk_file)
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
    """Restore planning + chunk assembly + compress/AoT swap-out."""

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
        # paged KV pool (dense family, chunked policy, paged_pool=True):
        # pages SURVIVE switch-out, the next switch-in is a table read.
        # Without it each context is assembled into a slot cache.
        self.pool: Optional[PagePool] = (
            PagePool(exe, ctxs) if exe.paged else None)
        if self.pool is None:
            # the static slot caches (and, on the card, their graphs),
            # before any service thread starts
            exe.init_slots()
        self.profile = PipelineProfile()
        self.profiled = False
        self.epoch = 0                      # bumped on any eviction
        # several engines over one MemoryManager / LCTRUQueue (a zoo,
        # core/zoo.py): a reclaim started here may pick a key another
        # member owns; keys of contexts unknown here go to the owner
        # through this callable instead of being dropped
        self.route_evict: Optional[Callable[[Tuple[int, int]], None]] = None
        # contexts that may hold dirty (unflushed) chunks (§3.4 hook)
        self._dirty_cids: set = set()
        # A/B control for the quant-resident tier: with the flag set,
        # admission MATERIALIZES every payload into bf16 pages (the
        # full-dequant baseline) and pages die at switch-out.  Payload
        # creation is unaffected, so both legs decode from identical
        # quantized representations: the token-identity contract.
        self.force_dequant = False
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
    # switch-in: restore every chunk to memory (Load primitive)
    # ------------------------------------------------------------------ #
    @requires_serialized
    def switch_in(self, ctx: Context, slot: Optional[int] = None):
        """-> (cache, switch_seconds).  Missing-chunk restore (reclaim +
        I/O + recompute) is the timed QoS path; resident-chunk assembly
        into the slot cache is not (see LLMService.callLLM).  The cache
        is decode slot ``slot``'s static cache, zeroed first (the slot
        the service acquired; without one a private cache).  With the
        paged pool the cache is None (``_switch_in_paged``)."""
        exe = self.exe
        if self.pool is not None:
            return self._switch_in_paged(ctx)
        cache = exe.fresh_cache(ctx.n_tokens, slot)
        if ctx.n_tokens == 0:
            return cache, 0.0
        if not self.cfg.chunked or not exe.chunked_cache:
            # whole-state policies, and constant-size recurrent caches
            # under every policy: snapshot / restore
            return self._restore_whole_timed(ctx, cache)

        # ---- assembly of resident chunks (inference-side cost) -------- #
        # quant mode: compressed chunks go behind the fused decode kernel
        # (decode-grid codes scattered verbatim, packed 4/2-bit payloads
        # re-gridded to int8 once, in qmemo); bf16-raw chunks materialize
        # in the bf16 window
        quant_mode = exe.quant_resident and not self.force_dequant
        by_bits: Dict[int, List[int]] = {}
        q_idxs: List[int] = []
        for i, m in sorted(ctx.chunks.items()):
            if m.in_memory:
                if quant_mode and m.bits != 16:
                    q_idxs.append(i)
                else:
                    by_bits.setdefault(m.bits, []).append(i)
                self.queue.touch((ctx.cid, i), m.bits)
                m.last_access = time.time()
        if q_idxs:
            codec = exe.codec
            codes = {n: [] for n in codec.leaves}
            scales = {n: [] for n in codec.leaves}
            for i in q_idxs:
                cc = ctx.payload[i]
                if not isinstance(cc, QuantResidentChunk):
                    cc = ctx.qmemo.get(i)
                    if cc is None:      # re-grid once per (re-)encode
                        cc = codec.quantize_resident_blocks(
                            self._payload_blocks(ctx.payload[i]),
                            self._head_dims())
                        ctx.qmemo[i] = cc
                for n in codec.leaves:
                    codes[n].append(cc.data[n][0])
                    scales[n].append(cc.data[n][1])
            pos = exe.chunk_positions(q_idxs)
            pos_b = exe.bucket_pad(pos, exe.pad_slot)
            pad = len(pos_b) - len(pos)

            def assemble(parts):
                # host payloads: concatenate + pad on the host and ship
                # ONE array per leaf, ONE scatter for the quant tier
                out = np.concatenate(parts)
                if pad:
                    out = np.concatenate(
                        [out, np.zeros((pad,) + out.shape[1:], out.dtype)])
                return torch.from_numpy(out).to(exe.device)

            codec.scatter_quant(cache, exe._t(pos_b),
                                {n: assemble(codes[n]) for n in codec.leaves},
                                {n: assemble(scales[n])
                                 for n in codec.leaves})
        for bits, idxs in by_bits.items():
            # decode each payload once, not once per leaf
            chunk_blocks = [self._payload_blocks(ctx.payload[i])
                            for i in idxs]
            blocks = {n: torch.cat([cb[n] for cb in chunk_blocks])
                      for n in exe.codec.leaves}
            pos = exe.chunk_positions(idxs)
            pos_b = exe.bucket_pad(pos, exe.pad_slot)
            if len(pos_b) != len(pos):
                pad = len(pos_b) - len(pos)
                blocks = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                          for k, v in blocks.items()}
            exe.codec.scatter(cache, exe._t(pos_b), blocks)
        exe.sync()

        # ---- timed: reclaim + restore of missing chunks ---------------- #
        t0 = time.perf_counter()
        missing = sorted(i for i, m in ctx.chunks.items() if not m.in_memory)
        need = sum(ctx.chunks[i].nbytes for i in missing)
        self.mem.reclaim(need, self.evict, locked={ctx.cid})
        if missing:
            re_idx, io_idx = self._plan_restore(ctx, missing)
            cache = self._restore_chunks(ctx, cache, re_idx, io_idx)
            exe.sync()
        return cache, time.perf_counter() - t0

    # ------------------------------------------------------------------ #
    # paged switch-in: a page-table read plus first-admission faults
    # ------------------------------------------------------------------ #
    @requires_serialized
    def _switch_in_paged(self, ctx: Context) -> Tuple[None, float]:
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
        quant_mode = exe.quant_resident and not self.force_dequant

        # ---- untimed: resident chunks (table read / first admission) -- #
        admitted = 0
        for i, m in sorted(ctx.chunks.items()):
            if m.in_memory:
                if pool.kind(ctx.cid, i) == 0:
                    self._admit_chunk(ctx, i, quant_mode)
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
                        self._admit_chunk(ctx, i, quant_mode)
                else:
                    self._recover_chunk_paged(ctx, i, quant_mode)
        if admitted or missing:
            exe.sync()
        return None, time.perf_counter() - t0

    def _admit_chunk(self, ctx: Context, i: int, quant_mode: bool):
        """Page-fault one in-memory chunk into the pool.  In quant mode a
        full compressed chunk takes a QUANT page: its decode-grid payload,
        or the re-grid of a 4/2-bit payload (memoized in ``qmemo``).
        Everything else — bf16-raw, partial tail chunks, and every chunk
        outside quant mode — dequantizes into a BF16 page (the chunk
        codec's dequantize kernel on the card for packed payloads)."""
        exe, pool, codec = self.exe, self.pool, self.exe.codec
        m = ctx.chunks[i]
        cc = ctx.payload[i]
        if quant_mode and m.bits != 16 and m.n_covered == exe.cs:
            qc = cc
            if not isinstance(qc, QuantResidentChunk):
                qc = ctx.qmemo.get(i)
                if qc is None:
                    qc = codec.quantize_resident_blocks(
                        self._payload_blocks(cc), self._head_dims())
                    ctx.qmemo[i] = qc
            page = pool.alloc8(ctx.cid, i)
            pool.arenas = exe.admit8(
                pool.arenas, page,
                {n: qc.data[n][0] for n in codec.leaves},
                {n: qc.data[n][1] for n in codec.leaves})
        else:
            blocks = self._payload_blocks(cc)
            page = pool.alloc16(ctx.cid, i)
            pool.arenas = exe.admit16(pool.arenas, page, blocks)
        pool.page_faults += 1

    def _head_dims(self) -> Dict[str, int]:
        return {n: self.exe.leaf_dims[n][-1] for n in self.exe.codec.leaves}

    def ensure_extend_range(self, ctx: Context, c_lo: int, c_hi: int):
        """Give chunks [c_lo, c_hi] writable bf16 pages ahead of a paged
        prefill-append: fresh tail chunks get zeroed pages; a chunk with
        a payload but no page is admitted from it, and one admitted as a
        QUANT page is converted back to bf16 (append writes into it)."""
        pool = self.pool
        for ci in range(c_lo, c_hi + 1):
            k = pool.kind(ctx.cid, ci)
            if k == BF16:
                continue
            if k == QUANT or ci in ctx.payload:
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
        pt16, pt8, qmask = pool.rows([ctx.cid])
        for a, b in self._hole_segments(ctx, lo, lo + covered):
            toks = np.asarray(ctx.tokens[a:b], np.int32)
            pool.arenas, _, _ = exe.paged_extend(pool.arenas, toks, a,
                                                 pt16, pt8, qmask)
        page = int(pool._tables[ctx.cid]["p16"][i])
        return exe.read16(pool.arenas, page)

    @requires_serialized
    def _recover_chunk_paged(self, ctx: Context, i: int, quant_mode: bool):
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
        want_quant = self.exe.quant_resident and m.bits == 8
        cc = self._encode_blocks(blocks, m.bits, quant=want_quant)
        ctx.payload[i] = cc
        ctx.qmemo.pop(i, None)
        m.quant = want_quant
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
        self._admit_chunk(ctx, i, quant_mode)
        with self._flags_lock:
            self.chunks_recovered_recompute += 1

    def _plan_restore(self, ctx, missing: List[int]
                      ) -> Tuple[List[int], List[int]]:
        """Eq.-4 split of the missing chunks into (recompute, I/O) from
        the §3.3.i profile; unprofiled, the heaviest half recomputes."""
        if not (self.cfg.use_pipeline and self.exe.recomputable):
            return [], missing
        plan_in = [(i, ctx.chunks[i].nbytes, True) for i in missing]
        if self.profiled:
            re_idx, io_idx, _ = plan_split(plan_in, self.profile, True)
        else:
            order = sorted(missing, key=lambda i: -ctx.chunks[i].nbytes)
            re_idx = order[:len(order) // 2]
            io_idx = [i for i in missing if i not in set(re_idx)]
        return sorted(re_idx), sorted(io_idx)

    @requires_serialized
    def _restore_chunks(self, ctx: Context, cache, re_idx: List[int],
                        io_idx: List[int]):
        """Fig. 8 restore into the slot cache (in place).  A recompute
        set runs the layer-pipelined restore; otherwise (and as its
        fallback) async whole-chunk reads, then a second-phase recompute.

        Chunks whose disk copy is missing/corrupt/unreadable after
        retries are DEMOTED to the recompute set (recovery ladder,
        DESIGN.md §6).  A pipelined restore that fails mid-feed has
        already written layers before the failing one; the fallback
        rewrites every position it touched (the I/O chunks by whole-file
        inserts, the recompute set in the second phase, each layer's
        rows before that layer attends) and the loop leaves the quant
        mask untouched, so the fallback restores what it would have from
        an untouched cache."""
        exe = self.exe
        quant_mode = exe.quant_resident and not self.force_dequant
        recovered: List[int] = []            # unreadable -> recomputed
        pending_io = list(io_idx)
        did_recompute = False
        if re_idx and exe.spec.pipelined_restore:
            # pre-validate the feed's files: a corrupt header would stop
            # the layer loop; route guaranteed-bad chunks to recompute
            ok_io: List[int] = []
            for i in pending_io:
                if not ctx.chunks[i].on_disk:    # degraded-mode drop
                    recovered.append(i)
                    continue
                try:
                    self.swapper.wait((ctx.cid, i), timeout=self._deadline)
                    verify_chunk_file(self.store._path((ctx.cid, i)))
                    ok_io.append(i)
                except SwapTimeoutError:
                    raise
                except (ChunkCorruptError, OSError) as err:
                    self._note_read_failure(err)
                    recovered.append(i)
            re_all = sorted(set(re_idx) | set(recovered))
            try:
                cache = self._restore_pipelined(ctx, cache, re_all, ok_io)
                for i in ok_io:
                    self._mark_loaded(ctx, i, payload=None)
                pending_io = []
                did_recompute = True
            except SwapTimeoutError:
                raise
            except Exception as err:
                # passed header validation but failed mid-feed (e.g. a
                # flipped byte inside a layer segment): fall back to
                # whole-file reads, which verify per-layer CRCs up front
                self._note_read_failure(err)
                pending_io = ok_io
        if pending_io:
            # async whole-chunk reads, insert as they land
            futs = {i: self._read_chunk_async((ctx.cid, i))
                    for i in pending_io if ctx.chunks[i].on_disk}
            for i in pending_io:
                cc = None
                if i in futs:
                    try:
                        cc = self._fut_result(futs[i])
                    except SwapTimeoutError:
                        raise
                    except (ChunkCorruptError, OSError) as err:
                        self._note_read_failure(err)
                if cc is None:
                    if i not in recovered:
                        recovered.append(i)
                    continue
                if quant_mode and isinstance(cc, QuantResidentChunk):
                    # decode-grid bytes go straight back behind the fused
                    # kernel: the read IS the restore
                    dev = exe.device
                    exe.codec.scatter_quant(
                        cache, exe._t(exe.chunk_positions([i])),
                        {n: torch.from_numpy(cc.data[n][0]).to(dev)
                         for n in exe.codec.leaves},
                        {n: torch.from_numpy(cc.data[n][1]).to(dev)
                         for n in exe.codec.leaves})
                else:
                    exe.codec.insert(cache, i * exe.cs,
                                     self._payload_blocks(cc))
                self._mark_loaded(ctx, i, payload=cc)

        re_all = sorted(set(re_idx) | set(recovered))
        if re_all and not did_recompute:
            if recovered and not exe.recomputable:
                with self._flags_lock:
                    self.recover_failed += 1
                raise ChunkCorruptError(
                    f"ctx {ctx.cid} chunks {recovered}: disk copies "
                    f"unreadable and family "
                    f"{exe.model.cfg.family!r} cannot recompute")
            # second phase (exact: the I/O chunks are now resident)
            miss_pos = self._feed_positions(ctx, re_all)
            miss_b = exe.bucket_pad(miss_pos, exe.pad_slot)
            toks_b = exe.bucket_pad(ctx.tokens[miss_pos], 0)
            exe.extend_nod(toks_b, miss_b, cache, ctx.n_tokens)

        # recomputed chunks: re-encode each payload at its assigned level
        rec = set(recovered)
        for i in re_all:
            m = ctx.chunks[i]
            want_quant = exe.quant_resident and m.bits == 8
            ctx.payload[i] = self._make_payload(cache, i, m.bits,
                                                quant=want_quant)
            ctx.qmemo.pop(i, None)
            m.quant = want_quant
            m.in_memory = True
            if i in rec:
                m.nbytes = ctx.payload[i].nbytes
                # rewrite the repaired chunk so the next restore is a
                # plain read again (unless writes are failing: leave it
                # dirty for the post-degraded flush)
                if (self.cfg.use_disk and self.aot_enabled
                        and self._write_chunk_async(ctx.cid, i,
                                                    ctx.payload[i])):
                    m.dirty, m.on_disk = False, True
                else:
                    m.dirty, m.on_disk = True, False
                    self._dirty_cids.add(ctx.cid)
                with self._flags_lock:
                    self.chunks_recovered_recompute += 1
            else:
                m.dirty = False               # already on disk
            self.mem.register((ctx.cid, i), m.nbytes, m.bits)
        return cache

    def _restore_pipelined(self, ctx: Context, cache, re_idx: List[int],
                           io_idx: List[int]):
        """The Fig. 8 layer-pipelined restore over a validated I/O set:
        the feed's thread (on the swapper's pool) writes layer l + 1 of
        every I/O chunk into the executor's page-locked sink
        (``exe.layer_feed``) while the card recomputes ``re_idx`` at
        layer l, each layer's gate waiting on the device for its rows
        (``exe.run_pipelined``: one graph replay on a slot's cache)."""
        exe = self.exe
        nio_b = next(x for x in exe.io_buckets
                     if x >= max(len(io_idx), 1))
        pad_chunks = nio_b - len(io_idx)
        io_pos_b = np.concatenate(
            [exe.chunk_positions(io_idx),
             np.full(pad_chunks * exe.cs, exe.pad_slot, np.int32)])
        paths = [self.store._path((ctx.cid, i)) for i in io_idx]
        miss_pos = self._feed_positions(ctx, re_idx)
        miss_b = exe.bucket_pad(miss_pos, exe.pad_slot)
        toks_b = exe.bucket_pad(ctx.tokens[miss_pos], 0)
        feed = exe.layer_feed(paths, pad_chunks, pool=self.swapper.pool)
        out, _ = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, cache,
                                   ctx.n_tokens)  # closes feed on failure
        feed.close()
        return out

    def _feed_positions(self, ctx: Context, idxs: List[int]) -> np.ndarray:
        """Chunk positions to FEED through recompute: every position of
        the given chunks except KV holes (each call's final emitted
        token, never run through the model: its rows stay zero, as the
        canonical payload stores them)."""
        pos = self.exe.chunk_positions(idxs)
        if not ctx.kv_holes:
            return pos
        keep = np.asarray([p for p in pos if int(p) not in ctx.kv_holes],
                          np.int32)
        return keep if len(keep) else pos[:0]

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

    # -- whole-context policies (swap / lmk) ----------------------------- #
    @requires_serialized
    def _restore_whole_timed(self, ctx: Context, cache):
        """Whole-state switch-in into ``cache`` (in place): the resident
        snapshot, or its ``(cid, -1)`` file (``swap``), or — killed or
        unreadable — a recompute of the whole text (``lmk``), which also
        re-takes the snapshot.  -> (cache, switch_seconds)."""
        exe = self.exe
        t_switch = 0.0
        if ctx.whole is None and self.cfg.use_disk and \
                self.store.nbytes((ctx.cid, -1)):
            t0 = time.perf_counter()
            self.mem.reclaim(self.store.nbytes((ctx.cid, -1)) or 0,
                             self.evict, locked={ctx.cid})
            try:
                ctx.whole = self.swapper.read((ctx.cid, -1),
                                              timeout=self._deadline)
                t_switch = time.perf_counter() - t0
                ctx.whole_tokens = ctx.n_tokens
                self.mem.register((ctx.cid, -1),
                                  self._whole_bytes(ctx), 16)
                self.queue.touch((ctx.cid, -1), 16)
            except SwapTimeoutError:
                raise
            except (ChunkCorruptError, OSError) as err:
                # unreadable snapshot: drop the stale accounting entry and
                # fall through to the recompute from the resident text
                self._note_read_failure(err)
                self.store.drop_bytes((ctx.cid, -1))
                with self._flags_lock:
                    self.chunks_recovered_recompute += 1
        if ctx.whole is None:
            # LMK: killed — recompute the whole context from its text
            t0 = time.perf_counter()
            self.mem.reclaim(0, self.evict, locked={ctx.cid})
            cache, dens = exe.recompute_whole(cache,
                                              ctx.tokens[:ctx.n_tokens])
            t_switch = time.perf_counter() - t0
            self.ctxs.acc_density(ctx, dens, ctx.n_tokens)
            ctx.whole = self._extract_whole(cache, ctx.n_tokens)
            ctx.whole_tokens = ctx.n_tokens
            ctx.alive = True
            self.mem.register((ctx.cid, -1), self._whole_bytes(ctx), 16)
            return exe.set_pos(cache, ctx.n_tokens), t_switch
        dev = exe.device
        exe.codec.insert(cache, 0, {k: torch.from_numpy(v).to(dev)
                                    for k, v in ctx.whole.items()})
        self.queue.touch((ctx.cid, -1), 16)
        return exe.set_pos(cache, ctx.n_tokens), t_switch

    def _extract_whole(self, cache, n_tokens: int) -> Dict[str, np.ndarray]:
        """The whole-state snapshot as host arrays (copies): tokens [0,
        bucket_len(n)) of the K/V as (T, F) blocks, or a state family's
        whole leaves.  16-bit leaves go bf16 -> fp32 -> fp16 (the
        reference's bytes); fp32 leaves stay exact — RWKV6's wkv
        recurrence is fp32 by design, and halving it would perturb
        every continued decode."""
        hi = self.exe.bucket_len(max(n_tokens, 1))
        out = {}
        for k, v in self.exe.codec.extract(cache, 0, hi).items():
            dt = np.float32 if v.dtype == torch.float32 else np.float16
            out[k] = v.to(torch.float32).cpu().numpy().astype(dt, copy=True)
        return out

    def _whole_bytes(self, ctx) -> int:
        return sum(v.nbytes for v in (ctx.whole or {}).values())

    # -- payload codecs ------------------------------------------------- #
    def _payload_blocks(self, cc) -> Dict[str, torch.Tensor]:
        """Payload -> (T, F) bf16 blocks on the device."""
        if isinstance(cc, QuantResidentChunk):
            return self.exe.codec.dequantize_resident(cc)
        if cc.bits == 16:
            dev = self.exe.device
            return {k: torch.from_numpy(p).to(dev).to(torch.bfloat16)
                    for k, (p, _) in cc.data.items()}
        return self.exe.codec.decompress(cc)

    def _encode_blocks(self, blocks, bits: int, quant: bool = False):
        """(T, F) blocks -> payload: the decode-grid QuantResidentChunk
        when ``quant``, else the storage codec at ``bits``.  16-bit
        payloads are fp16 numpy converted bf16 -> fp32 -> fp16,
        byte-identical to the reference's."""
        if quant:
            return self.exe.codec.quantize_resident_blocks(
                blocks, self._head_dims())
        if bits == 16:
            return CompressedChunk(
                bits=16, n_tokens=int(next(iter(blocks.values())).shape[0]),
                data={k: (v.to(torch.float32).cpu().numpy()
                          .astype(np.float16), np.zeros(0, np.float32))
                      for k, v in blocks.items()},
                shapes=block_shapes(blocks))
        return self.exe.codec.compress_blocks(blocks, bits)

    def _make_payload(self, cache, i: int, bits: int, quant: bool = False):
        """Encode chunk i from a slot cache.  A mixed cache is read
        through ``extract_mixed``: its bf16 array is stale at
        quant-resident positions."""
        cs, codec = self.exe.cs, self.exe.codec
        lo, hi = i * cs, (i + 1) * cs
        blocks = (codec.extract_mixed(cache, lo, hi)
                  if self.exe.quant_resident else codec.extract(cache, lo, hi))
        return self._encode_blocks(blocks, bits, quant)

    def _make_payload_paged(self, ctx: Context, i: int, bits: int,
                            quant: bool = False):
        """Encode chunk i from the pool.  A bf16 page is read back; a
        QUANT page or an unadmitted chunk re-encodes from its existing
        payload (the page holds exactly the payload's codes), or its
        disk copy, or — never written at all — the zero block."""
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
        return self._encode_blocks(blocks, bits, quant)

    # ------------------------------------------------------------------ #
    # compress + AoT swap-out (Reclaim is then free)
    # ------------------------------------------------------------------ #
    @requires_serialized
    def compress_and_swap_out(self, ctx: Context, cache=None):
        """Switch-out: the whole-state snapshot (non-chunked policies
        and constant-size state), or the Eq.-3 bit plan and each changed
        chunk's payload — from the pool's pages, or from the slot
        ``cache`` — then the AoT swap-out of the dirty chunks."""
        cfg = self.cfg
        if not cfg.chunked or not self.exe.chunked_cache:
            ctx.whole = self._extract_whole(cache, ctx.n_tokens)
            ctx.whole_tokens = ctx.n_tokens
            self.mem.register((ctx.cid, -1), self._whole_bytes(ctx), 16)
            return
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
            # in quant mode an 8-bit chunk is PROMOTED to the decode grid
            # (admitted once into a QUANT page, attended in place); 4/2-
            # bit chunks keep the packed storage codec and are re-gridded
            # behind the kernel
            want_quant = self.exe.quant_resident and want == 8
            m.density = float(D[i])
            covered = min(ctx.n_tokens - i * cs, cs)
            if (m.dirty or want != m.bits or i not in ctx.payload
                    or covered != m.n_covered or m.quant != want_quant):
                if self.pool is not None:
                    try:
                        cc = self._make_payload_paged(ctx, i, want,
                                                      quant=want_quant)
                    except (ChunkCorruptError, OSError) as err:
                        # the encode needed an unreadable disk copy:
                        # leave the chunk MISSING; the next switch-in
                        # recovers it with the prefix resident (§6)
                        self._note_read_failure(err)
                        m.bits, m.n_covered = want, covered
                        m.density = float(D[i])
                        m.quant = want_quant
                        m.dirty, m.in_memory, m.on_disk = \
                            False, False, False
                        ctx.payload.pop(i, None)
                        ctx.qmemo.pop(i, None)
                        self.pool.free_chunk(ctx.cid, i)
                        self.mem.unregister((ctx.cid, i))
                        continue
                    # drop-on-encode: the page now disagrees with the
                    # canonical payload (re-encoding is lossy): free it
                    self.pool.free_chunk(ctx.cid, i)
                else:
                    cc = self._make_payload(cache, i, want, quant=want_quant)
                ctx.payload[i] = cc
                ctx.qmemo.pop(i, None)
                m.bits, m.nbytes, m.n_covered = want, cc.nbytes, covered
                m.quant = want_quant
                m.dirty, m.in_memory, m.on_disk = True, True, False
                self._dirty_cids.add(ctx.cid)
                # AoT re-admit: pay the page write NOW, at switch-out, so
                # the next switch-in is a pure page-table read of exactly
                # the payload-roundtrip values.  Best-effort: an
                # exhausted pool leaves the chunk for a later fault.
                if self.pool is not None and not self.force_dequant:
                    try:
                        self._admit_chunk(ctx, i, self.exe.quant_resident)
                    except RuntimeError:
                        pass
            # AoT re-grid: a packed 4/2-bit chunk gets its decode-grid
            # memo NOW, built from the packed payload (not the page), so
            # admission sees identical codes before and after an
            # eviction/restore round trip
            if (self.exe.quant_resident and not m.quant and m.bits != 16
                    and i not in ctx.qmemo and i in ctx.payload):
                ctx.qmemo[i] = self.exe.codec.quantize_resident_blocks(
                    self._payload_blocks(ctx.payload[i]), self._head_dims())
            self.mem.register((ctx.cid, i), m.nbytes, m.bits)
            m.last_access = time.time()

        # the force_dequant control: pages die with the residency, so
        # every switch-in pays the full (bf16) re-admission
        if self.pool is not None and self.force_dequant:
            self.pool.free_ctx(ctx.cid)

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
            if pred.whole is not None:
                self.queue.touch((pred.cid, -1), 16)
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
        if self.route_evict is not None and cid not in self.ctxs.contexts:
            # shared-budget reclaim picked another member's key: its
            # owning engine evicts it (and bumps ITS epoch)
            self.route_evict(key)
            return
        self.epoch += 1
        ctx = self.ctxs.contexts.get(cid)
        if ctx is None:
            return
        if idx == -1:
            if self.cfg.use_disk and ctx.whole is not None:
                try:                            # sync: the paper's
                    self.store.write((cid, -1), ctx.whole)  # reclaim cost
                except OSError as err:
                    # can't persist: degrade on ENOSPC and drop — an older
                    # on-disk copy covers fewer tokens, so its accounting
                    # entry goes too (the next restore recomputes, LMK)
                    if getattr(err, "errno", None) == errno.ENOSPC:
                        self._enter_degraded()
                    self.evict_dropped += 1
                    self.store.drop_bytes((cid, -1))
            ctx.whole = None
            ctx.alive = False
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
                if self.pool is not None and not ctx.busy:
                    self.pool.free_chunk(cid, idx)
                return
            m.dirty = False
        m.on_disk, m.in_memory = True, False
        ctx.payload.pop(idx, None)
        ctx.qmemo.pop(idx, None)
        # a busy context's pages are its authoritative state: its own
        # swap-out re-encodes and drops them
        if self.pool is not None and not ctx.busy:
            self.pool.free_chunk(cid, idx)

    # ------------------------------------------------------------------ #
    @requires_serialized
    def profile_pipeline(self, n_points: Tuple[int, ...] = PROFILE_CHUNKS):
        """Paper §3.3.i: one-shot installation-time profiling of T_re
        (recompute of x chunks into the scratch slot, as a restore runs
        it: ``_recompute_as_restored``) and T_IO (chunk-file reads)."""
        exe = self.exe
        if not (exe.recomputable and exe.chunked_cache):
            return
        on_card = exe.device.type == "cuda"
        scratch = exe.scratch_slot
        toks = np.ones(exe.n_slots, np.int32)
        xs, ts = [], []
        for x in n_points:
            M = x * exe.cs
            pos_b = exe.bucket_pad(np.arange(M, dtype=np.int32),
                                   exe.pad_slot)
            toks_b = exe.bucket_pad(toks[:M], 0)
            warm = exe.fresh_cache(0, scratch)
            self._recompute_as_restored(toks_b, pos_b, warm, M)   # warm-up
            cache = exe.fresh_cache(0, scratch)
            if on_card:
                torch.cuda.synchronize(exe.device)
            t0 = time.perf_counter()
            self._recompute_as_restored(toks_b, pos_b, cache, M)
            if on_card:
                torch.cuda.synchronize(exe.device)
            ts.append(time.perf_counter() - t0)
            xs.append(x)
        self.profile.re_base, self.profile.re_per_chunk = fit_linear(xs, ts)

        cc = self._make_payload(exe.fresh_cache(0, scratch), 0, 8)
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

    def _recompute_as_restored(self, toks_b, pos_b, cache, n: int):
        """Recompute ``toks_b`` at ``pos_b`` into ``cache`` on the path a
        restore's recompute set takes: the Fig.-8 restore
        (``run_pipelined``: on the scratch slot's cache, the graph
        captured for this token bucket; fed one pad I/O chunk, no file)
        where the policy and the family pipeline restores, else the
        ``extend_nod`` graph.  Timed by ``profile_pipeline``, so that the
        Eq.-4 split prices the recompute that will run."""
        exe = self.exe
        if not exe.pipelines:
            exe.extend_nod(toks_b, pos_b, cache, n)
            return
        feed = exe.layer_feed([], pad_chunks=1, pool=self.swapper.pool)
        exe.run_pipelined(feed, toks_b, pos_b,
                          np.full(exe.cs, exe.pad_slot, np.int32), cache, n)
        feed.close()
