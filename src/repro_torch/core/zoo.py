"""ZooService — heterogeneous model zoo under one router (DESIGN.md §4).

The port's copy of the JAX package's core/zoo.py: the same contract,
with every member's service on ``device`` (the card unless the caller
asks for the CPU).  One process, MANY model families: each family gets its own
``LLMService`` (executor + context store + residency engine, all
capability-driven by the family's ``KVSpec``), but every member shares
ONE substrate — a single ``DiskStore``/``AsyncSwapper`` swap tier, a
single ``LCTRUQueue`` eviction order, a single ``MemoryManager`` byte
budget, one context-id space, and one records stream.  The zoo exposes
the exact service surface ``ServiceRouter`` drives (``newLLMCtx`` /
``begin_call`` / ``decode_step_batch`` / ``finish_call`` / ...), so a
router scheduling a dense chat model, an MLA long-context model and a
constant-state RWKV agent is the SAME router that schedules one model —
it never learns which family a context belongs to.

Routing is by context ownership: ``newLLMCtx(family=...)`` binds the
new context to a member, and every later call on its stub dispatches to
that member.  A batched decode round groups states by owner and runs
one member-batched step per group (results scattered back in order).

Cross-family reclaim: the shared LCTRU queue means a reclaim started by
member A may pop a chunk key owned by member B.  A's ``evict`` does not
know the context, so it forwards the key through ``res.route_evict`` —
wired here to look up the owner and re-dispatch to ITS engine (which
bumps ITS epoch).  Keys of deleted contexts are dropped; the
``MemoryManager`` already unregistered their bytes.
"""
from __future__ import annotations

import tempfile
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.markers import requires_serialized
from repro_torch.core.context_store import LLMCtxStub
from repro_torch.core.lifecycle import LCTRUQueue, MemoryManager
from repro_torch.core.service import GenerationState, LLMSConfig, LLMService
from repro_torch.core.swap import AsyncSwapper, DiskStore
from repro_torch.models.api import resolve_device


class _ZooResView:
    """The router's ``svc.res`` probe surface: degraded iff ANY member's
    swap tier is degraded (the store is shared, so normally all agree)."""

    def __init__(self, zoo: "ZooService"):
        self._zoo = zoo

    @property
    def degraded(self) -> bool:
        return any(m.res.degraded for m in self._zoo.members.values())


class ZooService:
    """≥2 family services behind one router, one byte budget, one disk.

    ``members`` maps family name -> (model, params, LLMSConfig); the
    first entry is the default family for ``newLLMCtx`` calls that do
    not name one.  Per-member ``memory_budget``/``swap_dir``/
    ``record_limit`` fields are ignored — the zoo's single budget, swap
    root and records stream replace them.  Every member's model must
    live on ``device``.
    """

    def __init__(self, members: Mapping[str, Tuple[Any, Any, LLMSConfig]],
                 *, memory_budget: Optional[int] = None,
                 swap_dir: Optional[str] = None, device="cuda"):
        assert members, "a zoo needs at least one member family"
        self.device = resolve_device(device)     # before any thread starts
        cfgs = [cfg for _, _, cfg in members.values()]
        first = cfgs[0]
        root = swap_dir or tempfile.mkdtemp(prefix="llms_zoo_")
        self.store = DiskStore(root)
        self.swapper = AsyncSwapper(self.store, retries=first.io_retries,
                                    retry_base_s=first.io_retry_base_s)
        self.queue = LCTRUQueue(lru_only=not any(c.use_lctru for c in cfgs))
        budget = (first.memory_budget if memory_budget is None
                  else int(memory_budget))
        self.mem = MemoryManager(budget, self.queue)
        self.records: List[Dict[str, Any]] = []
        self._next_cid = 0
        self.members: Dict[str, LLMService] = {}
        for fam, (model, params, cfg) in members.items():
            svc = LLMService(model, params, cfg, device=self.device,
                             store=self.store,
                             swapper=self.swapper, queue=self.queue,
                             mem=self.mem, cid_alloc=self._alloc_cid,
                             records=self.records)
            svc.res.route_evict = self._route_evict
            self.members[fam] = svc
        self.default_family = next(iter(self.members))
        self._owner: Dict[int, LLMService] = {}     # cid -> member
        self._owner_fam: Dict[int, str] = {}        # cid -> family name
        self.res = _ZooResView(self)
        # the zoo-level batched round groups by member; continuous
        # mid-slice joins are a single-pool notion, so the router sees
        # a non-paged service even when a member pages internally
        self.paged = False
        self._deadline = first.swap_deadline_s
        self._closed = False

    # -- substrate ------------------------------------------------------ #
    def _alloc_cid(self) -> int:
        cid = self._next_cid
        self._next_cid += 1
        return cid

    def _route_evict(self, key: Tuple[int, int]):
        """Shared-budget reclaim popped a key the reclaiming member does
        not own: re-dispatch to the owner.  A key whose context is gone
        everywhere is dropped — ``MemoryManager.reclaim`` unregisters
        the bytes either way, and forwarding it again would recurse."""
        svc = self._owner.get(key[0])
        if svc is not None and key[0] in svc.ctxs.contexts:
            svc.res.evict(key)

    def _member_of(self, cid: int) -> LLMService:
        try:
            return self._owner[cid]
        except KeyError:
            raise KeyError(f"ctx {cid} is not owned by any zoo member "
                           f"(families: {tuple(self.members)})") from None

    # -- the ServiceRouter surface -------------------------------------- #
    @property
    def decode_batch(self) -> int:
        return max(m.decode_batch for m in self.members.values())

    @requires_serialized
    def newLLMCtx(self, system_prompt=None,
                  family: Optional[str] = None) -> LLMCtxStub:
        fam = family or self.default_family
        if fam not in self.members:
            raise ValueError(f"unknown family {fam!r} "
                             f"(zoo has: {tuple(self.members)})")
        svc = self.members[fam]
        stub = svc.newLLMCtx(system_prompt)
        self._owner[stub.ctx_id] = svc
        self._owner_fam[stub.ctx_id] = fam
        return stub

    @requires_serialized
    def delLLMCtx(self, stub: LLMCtxStub):
        svc = self._member_of(stub.ctx_id)
        svc.delLLMCtx(stub)             # raises on busy: ownership kept
        self._owner.pop(stub.ctx_id, None)
        self._owner_fam.pop(stub.ctx_id, None)

    def bindLLMService(self, app: Any = None) -> "ZooService":
        return self

    @requires_serialized
    def begin_call(self, stub: LLMCtxStub, request) -> GenerationState:
        return self._member_of(stub.ctx_id).begin_call(stub, request)

    @requires_serialized
    def decode_step(self, st: GenerationState) -> Optional[int]:
        return self.decode_step_batch([st])[0]

    @requires_serialized
    def decode_step_batch(self, sts: Sequence[GenerationState]
                          ) -> List[Optional[int]]:
        """One zoo decode round: group the states by owning member and
        run one member-batched step per family, scattering the emitted
        tokens back into input order."""
        out: List[Optional[int]] = [None] * len(sts)
        groups: Dict[int, Tuple[LLMService, List[int]]] = {}
        for i, st in enumerate(sts):
            svc = self._member_of(st.ctx.cid)
            groups.setdefault(id(svc), (svc, []))[1].append(i)
        for svc, idxs in groups.values():
            toks = svc.decode_step_batch([sts[i] for i in idxs])
            for i, tok in zip(idxs, toks):
                out[i] = tok
        return out

    @requires_serialized
    def suspend_call(self, st: GenerationState):
        self._member_of(st.ctx.cid).suspend_call(st)

    @requires_serialized
    def resume_call(self, st: GenerationState):
        self._member_of(st.ctx.cid).resume_call(st)

    @requires_serialized
    def finish_call(self, st: GenerationState) -> List[int]:
        return self._member_of(st.ctx.cid).finish_call(st)

    @requires_serialized
    def callLLM(self, stub: LLMCtxStub, new_prompt, max_new_tokens: int = 16,
                sampling=None):
        return self._member_of(stub.ctx_id).callLLM(
            stub, new_prompt, max_new_tokens=max_new_tokens,
            sampling=sampling)

    @requires_serialized
    def prepare_switch(self, predicted_cid: int) -> int:
        """§3.4 AoT hint across the zoo: the predicted context's owner
        protects it and flushes its other dirty contexts; every other
        member just flushes (cid -1 never matches a context)."""
        target = self._owner.get(predicted_cid)
        n = 0
        for svc in self.members.values():
            n += svc.prepare_switch(predicted_cid if svc is target else -1)
        return n

    @requires_serialized
    def profile_pipeline(self, n_points: Tuple[int, ...] = (1, 2, 4)):
        for svc in self.members.values():
            svc.profile_pipeline(n_points)

    def family_of(self, cid: int) -> str:
        return self._owner_fam[cid]

    # -- reporting ------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        """Router-compatible aggregate + a per-family breakdown.  The
        shared-substrate figures (mem_used, disk bytes, switch timings
        over the shared records) are zoo-level facts; capability
        counters sum across members."""
        sw = [r["switch_s"] for r in self.records]
        out: Dict[str, Any] = {
            "calls": len(sw),
            "total_calls": sum(m.total_calls for m in self.members.values()),
            "switch_mean_s": float(np.mean(sw)) if sw else 0.0,
            "switch_p99_s": float(np.percentile(sw, 99)) if sw else 0.0,
            "switch_total_s": sum(m._t_switch_sum
                                  for m in self.members.values()),
            "mem_used": self.mem.used,
            "disk_bytes": self.store.total_bytes,
            "decode_slots": self.decode_batch,
            "decode_ready_contexts": sum(m.decode_ready_contexts()
                                         for m in self.members.values()),
            "quant_resident_chunks": sum(
                1 for m in self.members.values()
                for ctx in m.contexts.values()
                for cm in ctx.chunks.values() if cm.in_memory and cm.quant),
            "paged_pool": False,
            "zoo_families": tuple(self.members),
        }
        # fault stats: engine-local detect/recover counters sum across
        # members; swapper/store/global-injection counters are SHARED
        # substrate — take them once (summing would multiply by the
        # member count)
        fault_sum = next(iter(self.members.values())).res.fault_stats()
        for k in ("degraded_entries", "degraded_exits",
                  "chunks_recovered_recompute", "chunks_corrupt_detected",
                  "io_errors_detected", "evict_dropped", "recover_failed"):
            fault_sum[k] = sum(m.res.fault_stats()[k]
                               for m in self.members.values())
        fault_sum["degraded_mode"] = int(self.res.degraded)
        out.update(fault_sum)
        out["families"] = {
            fam: {"contexts": len(m.contexts),
                  "total_calls": m.total_calls,
                  "resident_bytes": sum(
                      m.mem._sizes.get((cid, i), 0)
                      for cid, ctx in m.contexts.items()
                      for i in list(ctx.chunks) + [-1])}
            for fam, m in self.members.items()}
        return out

    def close(self):
        """Members first (they never touch the shared swapper), then the
        zoo drains + shuts the one swap tier.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for m in self.members.values():
            m.close()
        self.swapper.shutdown(timeout=self._deadline)

    def __enter__(self) -> "ZooService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
