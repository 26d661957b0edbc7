"""LLMService — the LLMaaS system service (paper Table 1, §3).

Mirror of the JAX package's core/service.py over the paged pool:
``executor.ModelExecutor`` (model entries + buckets),
``context_store.ContextStore`` (persistent contexts, Fig. 4) and
``residency.ResidencyEngine`` (switch-in/out, compression, AoT,
eviction).  The measured *context switching latency* (Fig. 9) is the
time of ``ResidencyEngine.switch_in``.

The request path is stepwise as in the reference: ``begin_call``
switches the context in and prefills the prompt, ``decode_step`` /
``decode_step_batch`` emit one token per resident generation,
``finish_call`` compresses/AoT-swaps the result out.  ``callLLM`` is
the Table-1 shim over that path.

The service runs on the card (``device="cuda"``) unless the caller
asks for the CPU.  ``quant_resident=True`` keeps 8-bit chunks in the
pool as int8 QUANT pages that decode attends in place (the
``decode_mqattn`` kernel on the card).  Refused at construction, each
with a pointer to ``ROADMAP.md``: ``paged_pool=False`` (the slot
engine), the non-chunked policies (``swap``, ``lmk``) and any family
but dense.
"""
from __future__ import annotations

import tempfile
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.markers import requires_serialized
from repro_torch.core import compression as comp
from repro_torch.core.context_store import Context, ContextStore, LLMCtxStub  # noqa: F401 (re-export)
from repro_torch.core.executor import ModelExecutor
from repro_torch.core.lifecycle import LCTRUQueue, MemoryManager
from repro_torch.core.requests import GenerationRequest, SamplingParams
from repro_torch.core.residency import ResidencyEngine
from repro_torch.core.swap import AsyncSwapper, DiskStore
from repro_torch.models.api import ModelBase, resolve_device
from repro_torch.models.common import configure_numerics

POLICIES = ("llms", "llms_nocomp", "llms_nopipe", "llms_nolife",
            "vllm_s", "vllm_sq", "swap", "lmk")

# policy -> (compression, use_pipeline, use_lctru, use_aot, chunked, use_disk)
_POLICY_FLAGS = {
    "llms":        ("tolerance", True, True, True, True, True),
    "llms_nocomp": ("none", True, True, True, True, True),
    "llms_nopipe": ("tolerance", False, True, True, True, True),
    "llms_nolife": ("tolerance", True, False, False, True, True),
    "vllm_s":      ("none", False, False, False, True, True),
    "vllm_sq":     ("static8", False, False, False, True, True),
    "swap":        ("none", False, False, False, False, True),
    "lmk":         ("none", False, False, False, False, False),
}


@dataclass
class LLMSConfig:
    policy: str = "llms"
    decode_batch: int = 1                  # decode slots (B)
    quant_resident: bool = False           # int8 QUANT pages attended in place
    paged_pool: bool = True                # only the paged engine is ported
    pool_pages_16: int = 0
    pool_pages_8: int = 0
    chunk_tokens: int = 16
    record_limit: Optional[int] = None
    levels: Tuple[Tuple[int, float], ...] = comp.DEFAULT_LEVELS
    ratio_global: float = 0.5
    memory_budget: int = 64 << 20
    max_ctx_len: int = 512
    max_contexts_per_app: int = 8          # K in the paper
    swap_dir: Optional[str] = None
    io_retries: int = 3
    io_retry_base_s: float = 0.002
    swap_deadline_s: Optional[float] = None
    window: int = 0
    n_sinks: int = 0
    compression: str = ""
    use_pipeline: bool = False
    use_lctru: bool = False
    use_aot: bool = False
    chunked: bool = False
    use_disk: bool = False

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.decode_batch < 1:
            raise ValueError(f"decode_batch must be >= 1, not "
                             f"{self.decode_batch}")
        (self.compression, self.use_pipeline, self.use_lctru, self.use_aot,
         self.chunked, self.use_disk) = _POLICY_FLAGS[self.policy]
        if self.quant_resident and not self.chunked:
            raise ValueError(
                f"quant_resident requires a chunked policy, not "
                f"{self.policy!r}")
        if not self.chunked:
            self.paged_pool = False     # pages ARE chunks


def _refuse_unported(model: ModelBase, cfg: LLMSConfig) -> None:
    """Configurations this slice of the port does not run: refused
    before anything is built, never quietly run as something else."""
    if not cfg.chunked:
        raise NotImplementedError(
            f"policy {cfg.policy!r} keeps whole-context state; the "
            "whole-state policies are not ported yet (ROADMAP.md)")
    if not cfg.paged_pool:
        raise NotImplementedError(
            "paged_pool=False runs the slot engine with the layer-"
            "pipelined restore, which is not ported yet (ROADMAP.md)")
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"family {model.cfg.family!r} is not ported yet (ROADMAP.md)")


@dataclass
class GenerationState:
    """One in-flight generation between ``begin_call`` and
    ``finish_call``; while ``suspended`` the pending sampled token and
    the request's RNG live here."""
    ctx: Context
    request: GenerationRequest
    sampler: Any
    prompt_len: int
    cache: Any = None
    slot: Optional[int] = None              # decode slot while resident
    next_tok: Optional[int] = None          # sampled, not yet emitted
    generated: List[int] = field(default_factory=list)
    t_switch: float = 0.0
    t_assemble: float = 0.0
    t_infer: float = 0.0
    t_swapout: float = 0.0
    n_preempts: int = 0
    suspended: bool = False
    done: bool = False

    @property
    def exhausted(self) -> bool:
        return self.next_tok is None


class LLMService:
    """One shared model + per-app persistent contexts (LLMaaS)."""

    def __init__(self, model: ModelBase, params, cfg: LLMSConfig, *,
                 device="cuda", store: Optional[DiskStore] = None):
        self.device = resolve_device(device)
        _refuse_unported(model, cfg)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, service on "
                             f"{self.device}")
        configure_numerics(self.device)
        self.model, self.params, self.cfg = model, params, cfg
        self.exe = ModelExecutor(model, params, cfg, self.device)
        if store is None:
            root = cfg.swap_dir or tempfile.mkdtemp(prefix="llms_swap_")
            store = DiskStore(root)
        self.store = store
        self.swapper = AsyncSwapper(self.store, retries=cfg.io_retries,
                                    retry_base_s=cfg.io_retry_base_s)
        self.queue = LCTRUQueue(lru_only=not cfg.use_lctru)
        self.mem = MemoryManager(cfg.memory_budget, self.queue)
        self.ctxs = ContextStore(self.mem, self.store, self.exe.s_work)
        self.res = ResidencyEngine(self.exe, self.ctxs, self.store,
                                   self.swapper, self.queue, self.mem, cfg)
        self.records: Any = (deque(maxlen=cfg.record_limit)
                             if cfg.record_limit else [])
        self.total_calls = 0
        self._t_switch_sum = 0.0
        # cid -> (None, epoch): parked contexts whose pages stay warm
        self._reuse: "OrderedDict[int, Tuple[Any, int]]" = OrderedDict()
        self.paged = True
        self._closed = False

    @property
    def decode_batch(self) -> int:
        return self.exe.decode_slots

    def _drop_reuse(self, cid: int):
        self._reuse.pop(cid, None)

    @property
    def contexts(self) -> Dict[int, Context]:
        return self.ctxs.contexts

    @property
    def n_slots(self) -> int:
        return self.exe.n_slots

    @requires_serialized
    def newLLMCtx(self, system_prompt: Optional[Sequence[int]] = None
                  ) -> LLMCtxStub:
        ctx = self.ctxs.create()
        stub = LLMCtxStub(ctx.cid)
        if system_prompt is not None and len(system_prompt):
            self.callLLM(stub, system_prompt, max_new_tokens=0)
        return stub

    @requires_serialized
    def delLLMCtx(self, stub: LLMCtxStub):
        self.ctxs.delete(stub.ctx_id)   # raises on busy: nothing changed
        self._drop_reuse(stub.ctx_id)
        self.res.slots.release(stub.ctx_id)
        self.res.pool.drop(stub.ctx_id)

    def bindLLMService(self, app: Any = None) -> "LLMService":
        return self

    # ------------------------------------------------------------------ #
    # stepwise request path: begin / decode / (suspend / resume) / finish
    # ------------------------------------------------------------------ #
    @requires_serialized
    def begin_call(self, stub: LLMCtxStub,
                   request: GenerationRequest) -> GenerationState:
        """Admit one request: condense on overflow, switch the context
        in (the measured QoS path), prefill the prompt, and sample the
        first token (emitted by the first ``decode_step``)."""
        ctx = self.ctxs.get(stub.ctx_id)
        if ctx.busy:
            raise RuntimeError(
                f"ctx {ctx.cid} has a suspended in-flight generation; "
                "await or cancel its stream before a new call")
        prompt = np.asarray(request.prompt, np.int32)
        total_new = len(prompt) + request.max_new_tokens
        if total_new > self.exe.max_request_tokens:
            raise ValueError(
                f"prompt + max_new_tokens = {total_new} exceeds half the "
                f"window ({self.exe.max_request_tokens})")
        if ctx.n_tokens + total_new > self.exe.n_slots:
            self._condense(ctx, keep=self.exe.n_slots // 2)

        st = GenerationState(ctx=ctx, request=request,
                             sampler=request.sampling.make_sampler(),
                             prompt_len=len(prompt))
        self._switch_in(st)
        try:
            t1 = time.perf_counter()
            n0 = ctx.n_tokens
            ctx.tokens[n0:n0 + len(prompt)] = prompt
            pool = self.res.pool
            cs = self.exe.cs
            self.res.ensure_extend_range(
                ctx, n0 // cs, (n0 + len(prompt) - 1) // cs)
            pt16, pt8, qmask = pool.rows([ctx.cid])
            pool.arenas, logits, dens = self.exe.paged_extend(
                pool.arenas, prompt, n0, pt16, pt8, qmask)
            self.ctxs.acc_density(ctx, dens, n0 + len(prompt))
            ctx.n_tokens += len(prompt)
            if request.max_new_tokens > 0:
                st.next_tok = st.sampler(logits)
            st.t_infer += time.perf_counter() - t1
            ctx.busy += 1
        except BaseException:       # failed prefill must not leak the slot
            self.res.slots.release(ctx.cid)
            st.slot = st.cache = None
            raise
        return st

    @requires_serialized
    def decode_step(self, st: GenerationState) -> Optional[int]:
        """Emit the pending token and (if budget remains) run one decode
        step to sample the next.  -> the emitted token or None."""
        return self.decode_step_batch([st])[0]

    @requires_serialized
    def decode_step_batch(self, sts: Sequence[GenerationState]
                          ) -> List[Optional[int]]:
        """One decode round over up to ``decode_batch`` resident
        generations.  -> emitted tokens parallel to ``sts``."""
        t1 = time.perf_counter()
        out: List[Optional[int]] = []
        live: List[GenerationState] = []
        fed: List[int] = []
        for st in sts:
            if st.done or st.next_tok is None:
                out.append(None)
                continue
            if st.suspended:
                raise RuntimeError("resume_call before decode_step")
            ctx = st.ctx
            tok = st.next_tok
            st.generated.append(tok)
            ctx.tokens[ctx.n_tokens] = tok
            ctx.n_tokens += 1
            out.append(tok)
            if len(st.generated) >= st.request.max_new_tokens:
                # the final emitted token is never fed: its KV row stays
                # zero, a hole recompute-based recovery must skip
                ctx.kv_holes.add(ctx.n_tokens - 1)
                st.next_tok = None
            else:
                live.append(st)
                fed.append(tok)
        if live:
            self._decode_round_paged(live, fed)
        n_stepped = sum(tok is not None for tok in out)
        if n_stepped:
            share = (time.perf_counter() - t1) / n_stepped
            for st, tok in zip(sts, out):
                if tok is not None:
                    st.t_infer += share
        return out

    def _decode_round_paged(self, live: List[GenerationState],
                            fed: List[int]):
        """One continuous-batching round over the pool: each live
        generation contributes its page-table row and its position."""
        pool = self.res.pool
        cs = self.exe.cs
        pos = []
        for st in live:
            p = st.ctx.n_tokens - 1         # the just-emitted token
            self.res.ensure_tail(st.ctx, p // cs)
            pool.touch(st.ctx.cid)
            pos.append(p)
        pt16, pt8, qmask = pool.rows([st.ctx.cid for st in live])
        pool.arenas, logits, mass = self.exe.paged_decode(
            pool.arenas, fed, pos, pt16, pt8, qmask)
        for i, st in enumerate(live):
            self.ctxs.acc_density(st.ctx, mass[i], st.ctx.n_tokens)
            st.next_tok = st.sampler(logits[i])

    @requires_serialized
    def suspend_call(self, st: GenerationState):
        """Preempt an in-flight generation: commit the partial result
        (compress + AoT swap-out) and park its decode slot."""
        if st.suspended or st.done:
            raise RuntimeError("generation is not running")
        t2 = time.perf_counter()
        self.res.compress_and_swap_out(st.ctx)
        self.mem.reclaim(0, self.res.evict, locked=set())
        st.t_swapout += time.perf_counter() - t2
        self._park(st)
        st.suspended = True
        st.n_preempts += 1

    @requires_serialized
    def _park(self, st: GenerationState):
        """Slot held -> idle; the pages stay in the pool, the entry marks
        the context warm until an eviction invalidates it (not under the
        force_dequant control, whose pages die at switch-out)."""
        if not self.res.force_dequant:
            self._reuse[st.ctx.cid] = (None, self.res.epoch)
            self._reuse.move_to_end(st.ctx.cid)
        self.res.slots.park(st.ctx.cid)
        st.cache = None
        st.slot = None

    @requires_serialized
    def resume_call(self, st: GenerationState):
        """Switch a suspended generation's context back in."""
        if not st.suspended or st.done:
            raise RuntimeError("generation is not suspended")
        st.suspended = False
        try:
            self._switch_in(st)
        except BaseException:
            st.suspended = True
            raise

    @requires_serialized
    def finish_call(self, st: GenerationState) -> List[int]:
        """Compress / AoT swap-out / reclaim (paper §3.2 + §3.4) and
        append the per-call timing record."""
        ctx = st.ctx
        try:
            if not st.suspended:
                t2 = time.perf_counter()
                self.res.compress_and_swap_out(ctx)
                self.mem.reclaim(0, self.res.evict, locked=set())
                st.t_swapout += time.perf_counter() - t2
                self._park(st)
        finally:
            if st.slot is not None:     # park failed: free the slot
                self.res.slots.release(ctx.cid)
                st.slot = None
            st.cache = None
            st.done = True
            ctx.busy -= 1
            self.total_calls += 1
            self._t_switch_sum += st.t_switch
            self.records.append({
                "ctx": ctx.cid, "switch_s": st.t_switch,
                "infer_s": st.t_infer + st.t_assemble,
                "assemble_s": st.t_assemble,
                "swapout_s": st.t_swapout,
                "new_tokens": st.prompt_len + len(st.generated),
                "n_preempts": st.n_preempts,
                "mem_used": self.mem.used,
            })
        return st.generated

    @requires_serialized
    def _switch_in(self, st: GenerationState):
        """Claim a decode slot and switch the context in: missing-state
        restore is timed (the QoS metric); resident admission is
        inference.  The paged engine never short-circuits: switch_in is
        where dropped pages are re-admitted."""
        ctx = st.ctx
        t0 = time.perf_counter()
        self._reuse.pop(ctx.cid, None)
        st.slot = self.res.slots.acquire(ctx.cid, self._drop_reuse)
        try:
            cache, t_sw = self.res.switch_in(ctx)
        except BaseException:
            self.res.slots.release(ctx.cid)
            st.slot = None
            raise
        st.cache = cache
        st.t_switch += t_sw
        st.t_assemble += time.perf_counter() - t0 - t_sw

    # ------------------------------------------------------------------ #
    # Table-1 compat shim: one blocking call over the stepwise path
    # ------------------------------------------------------------------ #
    @requires_serialized
    def callLLM(self, stub: LLMCtxStub, new_prompt: Sequence[int],
                max_new_tokens: int = 16,
                sampling: Optional[SamplingParams] = None
                ) -> Tuple[LLMCtxStub, List[int]]:
        request = GenerationRequest(prompt=new_prompt,
                                    max_new_tokens=max_new_tokens,
                                    sampling=sampling or SamplingParams())
        st = self.begin_call(stub, request)
        while self.decode_step(st) is not None:
            pass
        self.finish_call(st)
        return stub, st.generated

    @requires_serialized
    def prepare_switch(self, predicted_cid: int) -> int:
        return self.res.prepare_switch(predicted_cid)

    @requires_serialized
    def _condense(self, ctx: Context, keep: int):
        """Context overflow: re-encode the recent tail at [0, keep)."""
        tail = self.ctxs.reset_for_condense(ctx, keep, self.exe.cs)
        self._drop_reuse(ctx.cid)
        self.res.slots.release(ctx.cid)
        ctx.tokens[:len(tail)] = tail
        pool = self.res.pool
        pool.drop(ctx.cid)
        self.res.ensure_extend_range(ctx, 0, (len(tail) - 1) // self.exe.cs)
        pt16, pt8, qmask = pool.rows([ctx.cid])
        pool.arenas, _, dens = self.exe.paged_extend(
            pool.arenas, np.asarray(tail, np.int32), 0, pt16, pt8, qmask)
        self.ctxs.acc_density(ctx, dens, len(tail))
        ctx.n_tokens = len(tail)
        self.res.compress_and_swap_out(ctx)

    @requires_serialized
    def profile_pipeline(self, n_points: Tuple[int, ...] = (1, 2, 4)):
        self.res.profile_pipeline(n_points)

    def decode_ready_contexts(self) -> int:
        """Contexts whose next switch-in needs neither dequantization nor
        disk I/O: generations holding a slot, parked contexts whose state
        survived every eviction since (epoch match), and — with the
        quant-resident tier on — every context whose chunks are all in
        memory with their decode-grid codes ready (the payload itself,
        or the AoT re-grid memo of a packed chunk)."""
        ready = set(self.res.slots.held)
        for cid, (_, epoch) in self._reuse.items():
            if epoch == self.res.epoch:
                ready.add(cid)
        if self.exe.quant_resident and not self.res.force_dequant:
            for cid, ctx in self.contexts.items():
                if (ctx.n_tokens and ctx.chunks
                        and all(m.in_memory and m.bits != 16
                                and (m.quant or i in ctx.qmemo)
                                for i, m in ctx.chunks.items())):
                    ready.add(cid)
        return len(ready)

    def stats(self) -> Dict[str, float]:
        from repro_torch.core.restore import io_counters
        sw = [r["switch_s"] for r in self.records]
        n_quant = sum(1 for ctx in self.contexts.values()
                      for m in ctx.chunks.values()
                      if m.in_memory and m.quant)
        io = io_counters()
        out = {
            "calls": len(sw),
            "total_calls": self.total_calls,
            "switch_mean_s": float(np.mean(sw)) if sw else 0.0,
            "switch_p99_s": float(np.percentile(sw, 99)) if sw else 0.0,
            "switch_total_s": self._t_switch_sum,
            "mem_used": self.mem.used,
            "disk_bytes": self.store.total_bytes,
            "disk_bytes_read": io["read"],        # process-cumulative
            "disk_bytes_written": io["write"],
            "decode_slots": self.decode_batch,
            "slots_held": len(self.res.slots.held),
            "decode_ready_contexts": self.decode_ready_contexts(),
            "quant_resident_chunks": n_quant,
            "paged_pool": True,
            "device": str(self.device),
        }
        out.update(self.res.pool.stats())
        out.update(self.res.fault_stats())
        return out

    def close(self):
        """Idempotent; flushes pending AoT writes before shutdown."""
        if self._closed:
            return
        self._closed = True
        self.swapper.shutdown(timeout=self.cfg.swap_deadline_s)

    def __enter__(self) -> "LLMService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
