"""Context store — per-app persistent context state (paper Fig. 4).

Layer 2 of the four-layer design (DESIGN.md §1): owns the ``Context``
records (resident text, chunk metadata, compressed payloads, attention
density accounting) and their lifecycle bookkeeping against the memory
manager and the disk store.  It never runs the model; condense hands
the surviving token tail back to the caller for re-encoding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.chunks import ChunkMeta, CompressedChunk, QuantResidentChunk
from repro_torch.core.lifecycle import MemoryManager
from repro_torch.core.swap import DiskStore
from repro_torch.analysis.markers import requires_serialized


@dataclass
class LLMCtxStub:
    """Table 1: the opaque handle apps hold."""
    ctx_id: int


@dataclass
class Context:
    cid: int
    tokens: np.ndarray                      # resident text (paper Fig. 4)
    n_tokens: int = 0
    chunks: Dict[int, ChunkMeta] = field(default_factory=dict)
    payload: Dict[int, CompressedChunk] = field(default_factory=dict)
    # decode-grid memo of packed 4/2-bit payloads (quant-resident tier):
    # the unpack+re-grid to int8 runs once per re-encode, not per
    # switch-in.  Charged at the PACKED payload size — the decodable
    # int8 form is bookkept as if unpacked on the fly (DESIGN.md §2) —
    # and dropped with the payload on evict/condense.
    qmemo: Dict[int, "QuantResidentChunk"] = field(default_factory=dict)
    whole: Optional[Dict[str, np.ndarray]] = None   # non-chunked policies
    whole_tokens: int = 0
    # positions whose KV was never computed: each call's final emitted
    # token is appended to the text but the decode budget ends before
    # its KV round, so the canonical payload stores ZERO rows there.
    # Recompute-based fault recovery (DESIGN.md §6) must zero these
    # rows to reproduce the payload bytes exactly.
    kv_holes: set = field(default_factory=set)
    alive: bool = True                      # lmk: killed => False
    density_sum: Optional[np.ndarray] = None
    density_cnt: Optional[np.ndarray] = None
    # resume bookkeeping: count of in-flight GenerationStates (begun but
    # not finished — includes slice-preempted, swapped-out generations).
    # A busy context cannot be deleted: a suspended stream will switch
    # its state back in to keep decoding.
    busy: int = 0


class ContextStore:
    """Registry of contexts + chunk/payload/density bookkeeping."""

    def __init__(self, mem: MemoryManager, store: DiskStore, s_work: int,
                 cid_alloc: Optional[Callable[[], int]] = None):
        self.mem = mem
        self.store = store
        self.s_work = s_work
        self.contexts: Dict[int, Context] = {}
        self._next_cid = 0
        # multi-executor zoo (DESIGN.md §4): stores sharing one DiskStore
        # must not collide on cid, so the ZooService injects one shared
        # allocator; standalone stores keep the private counter.
        self._cid_alloc = cid_alloc

    @requires_serialized
    def create(self) -> Context:
        if self._cid_alloc is not None:
            cid = self._cid_alloc()
        else:
            cid = self._next_cid
            self._next_cid += 1
        ctx = Context(
            cid=cid, tokens=np.zeros(self.s_work, np.int32),
            density_sum=np.zeros(self.s_work, np.float64),
            density_cnt=np.zeros(self.s_work, np.float64))
        self.contexts[cid] = ctx
        return ctx

    def get(self, cid: int) -> Context:
        return self.contexts[cid]

    @requires_serialized
    def delete(self, cid: int) -> Optional[Context]:
        """Drop a context and release every byte it holds (mem + disk).
        Refuses while a generation is in flight (possibly suspended) on
        it — resume would otherwise decode into freed state."""
        ctx = self.contexts.get(cid)
        if ctx is None:
            return None
        if ctx.busy:
            raise RuntimeError(
                f"ctx {cid} has {ctx.busy} in-flight generation(s); "
                "cancel the stream(s) before delLLMCtx")
        self.contexts.pop(cid)
        for idx in list(ctx.chunks):
            self.mem.unregister((ctx.cid, idx))
            self.store.delete((ctx.cid, idx))
        self.mem.unregister((ctx.cid, -1))
        self.store.delete((ctx.cid, -1))
        return ctx

    def acc_density(self, ctx: Context, mass: np.ndarray, n_visible: int):
        """Eq. 1 accumulation: attention mass per position + visit counts."""
        ctx.density_sum[:len(mass)] += mass
        ctx.density_cnt[:n_visible] += 1

    @requires_serialized
    def reset_for_condense(self, ctx: Context, keep: int, cs: int
                           ) -> np.ndarray:
        """Context overflow (paper §4 streaming): release all chunk state
        and return the most recent ``keep`` tokens (chunk-aligned) for the
        caller to re-encode at positions [0, keep)."""
        keep = max(cs, min((keep // cs) * cs, (ctx.n_tokens // cs) * cs))
        tail = ctx.tokens[ctx.n_tokens - keep:ctx.n_tokens].copy()
        for idx in list(ctx.chunks):
            self.mem.unregister((ctx.cid, idx))
            self.store.delete((ctx.cid, idx))
        self.mem.unregister((ctx.cid, -1))
        ctx.chunks.clear()
        ctx.payload.clear()
        ctx.qmemo.clear()
        ctx.kv_holes.clear()
        ctx.whole = None
        ctx.tokens[:] = 0
        ctx.n_tokens = 0
        ctx.density_sum[:] = 0
        ctx.density_cnt[:] = 0
        return tail
