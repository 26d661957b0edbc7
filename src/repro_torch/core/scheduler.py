"""Multi-app scheduler front-end for the LLM service (paper §2-§3).

Layer 4 of the four-layer design (DESIGN.md §1, §4): the paper's LLMaaS
premise is ONE shared model serving MANY apps, so something above the
service must (a) admit requests from concurrent apps, (b) order them by
user-perceived urgency (foreground interactions ahead of background
agents), and (c) exploit the trace history to predict which context
comes next — the §3.4 ahead-of-time swap-out hint.

``ServiceRouter`` owns per-app sessions and an admission priority
queue.  Model execution is serialized under one lock (one dispatcher
at a time), but each dispatch round drives up to ``decode_batch``
generations at once through the service's batched decode path; with
``start=True`` a dispatcher thread drains the queue so app threads
only enqueue, with ``start=False`` the queue drains inline
(deterministic — used by the benchmarks and tests).

**Batched decode-slice dispatch.**  Each dispatch round forms a decode
BATCH of up to ``decode_batch`` compatible queued jobs (priority
order; two jobs on one context never share a batch; an ``exclusive``
request runs alone) and runs them in bounded slices of
``slice_steps=K`` decode rounds — one batched model step emits a token
for every live generation, so background apps make progress in the
same wall-clock steps the foreground pays for anyway.  Between slices
the dispatcher re-checks the admission queue: finished slots are
REFILLED from compatible queued jobs, and a waiting strictly-higher-
priority request PREEMPTS the lowest-priority slot — that one partial
generation is switched out through the ResidencyEngine
(``LLMService.suspend_call``), re-queued at its original admission
rank, and the newcomer takes its slot while the REST OF THE BATCH
KEEPS DECODING.  Foreground TTFT is therefore bounded by one slice
plus one context switch instead of somebody else's whole generation.
``slice_steps=0`` is the legacy whole-generation dispatch: the batch
formed at dispatch time runs to completion without re-checking the
queue.

**Continuous batching (paged pool).**  When the service decodes over
the paged KV pool (``svc.paged``), batch membership also changes
MID-slice: a generation that finishes frees its batch row that round
and a compatible queued job joins the next round — joining is one
prefill plus a fresh page-table row, and the survivors' caches are
untouched (no merge/split), so the engine never decodes below
capacity while work is queued.  Preemption still happens only at
slice boundaries (``_rebalance``).

``NextContextPredictor`` is a first-order transition table over the
observed context-switch history — the same process that generates the
synthetic traces (trace/synth.py markov pattern), so it is the right
minimal predictor.  After every call the router asks it for the likely
next context and passes the answer to ``ResidencyEngine.prepare_switch``
which protects that context's chunks and AoT-flushes everyone else's.
"""
from __future__ import annotations

import heapq
import math
import threading
import time
from collections import Counter, defaultdict, deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.analysis.markers import requires_lock, requires_serialized
from repro_torch.analysis.runtime import witness_condition, witness_rlock

from repro_torch.core.faults import SwapTimeoutError
from repro_torch.core.requests import (  # noqa: F401
    BACKGROUND, FOREGROUND, GenerationRequest, GenerationStream,
    SamplingParams)

_PRIO_NAMES = {FOREGROUND: "foreground", BACKGROUND: "background"}
_PRIO_BY_NAME = {"foreground": FOREGROUND, "fg": FOREGROUND,
                 "background": BACKGROUND, "bg": BACKGROUND}


def parse_priority(p) -> int:
    if isinstance(p, str):
        return _PRIO_BY_NAME[p.lower()]
    assert p in (FOREGROUND, BACKGROUND), p
    return int(p)


class NextContextPredictor:
    """First-order Markov predictor over the context-switch history."""

    def __init__(self):
        self.trans: Dict[int, Counter] = defaultdict(Counter)
        self.last: Optional[int] = None

    def observe(self, cid: int):
        if self.last is not None:
            self.trans[self.last][cid] += 1
        self.last = cid

    def predict(self, cid: Optional[int] = None) -> Optional[int]:
        """Most likely successor of ``cid`` (default: the latest ctx)."""
        cid = self.last if cid is None else cid
        counts = self.trans.get(cid)
        if not counts:
            return None
        return counts.most_common(1)[0][0]


class AppSession:
    """Per-app handle: all service access goes through the router."""

    def __init__(self, router: "ServiceRouter", name: str, priority: int,
                 family: Optional[str] = None):
        self.router = router
        self.name = name
        self.priority = priority
        # model family this app's contexts bind to (zoo routing); None
        # keeps the single-model service's default
        self.family = family

    def new_ctx(self, system_prompt=None):
        return self.router.new_ctx(self, system_prompt=system_prompt)

    def del_ctx(self, stub):
        return self.router.del_ctx(self, stub)

    def submit(self, stub, prompt, max_new_tokens: int = 16) -> Future:
        """Legacy whole-result admission: -> Future[(stub, tokens)]."""
        return self.router.submit(self, stub, prompt, max_new_tokens)

    def submit_request(self, stub,
                       request: GenerationRequest) -> GenerationStream:
        return self.router.submit_request(self, stub, request)

    def stream(self, stub, prompt, max_new_tokens: int = 16,
               sampling: Optional[SamplingParams] = None,
               priority: Optional[Union[int, str]] = None,
               deadline: Optional[float] = None) -> GenerationStream:
        """Streaming admission: tokens observable as they decode."""
        req = GenerationRequest(prompt=prompt, max_new_tokens=max_new_tokens,
                                sampling=sampling or SamplingParams(),
                                priority=priority, deadline=deadline)
        return self.router.submit_request(self, stub, req)

    def call(self, stub, prompt, max_new_tokens: int = 16):
        """Synchronous convenience: admit + wait for completion."""
        fut = self.submit(stub, prompt, max_new_tokens)
        if not self.router.started:
            self.router.drain()
        return fut.result()


class ServiceRouter:
    """Admission queue + per-app sessions + decode-slice dispatch +
    next-context prediction."""

    def __init__(self, svc, predict: bool = True, start: bool = False,
                 slice_steps: int = 0,
                 clock: Optional[Callable[[], float]] = None,
                 record_limit: Optional[int] = None):
        self.svc = svc
        self.slice_steps = int(slice_steps)
        self.decode_batch = max(1, int(getattr(svc, "decode_batch", 1)))
        # ``clock`` replaces wall time for ALL QoS timestamps (enqueue,
        # start, stream token times): the loadgen virtual-clock driver
        # injects a simulation clock so scheduling metrics are
        # deterministic in the scenario seed.  None = wall clock.
        self._now: Callable[[], float] = clock or time.perf_counter
        # ``record_limit`` bounds the retained per-call dict records
        # (scale harness: 10^5+ calls would otherwise grow without
        # bound); aggregate stats stay exact via the streaming
        # accumulators below.  None keeps full retention.
        self.call_records: Any = (deque(maxlen=record_limit)
                                  if record_limit else [])
        self.predictor = NextContextPredictor() if predict else None
        self.sessions: Dict[str, AppSession] = {}
        self.prefetch_hints = 0
        self.aot_flushes = 0
        self.preemptions = 0
        self.preemptions_by_prio: Counter = Counter()
        self.watchdog_preempts = 0          # hung swaps turned preemptions
        self.bg_shed = 0                    # degraded-mode bg deferrals
        self.decode_rounds = 0              # batched decode rounds run
        self.decoded_tokens = 0             # tokens emitted across rounds
        self.joins_mid_slice = 0            # continuous-batching joins
        # loadgen hooks (None = zero overhead): called inline from the
        # dispatch path, single-threaded under _svc_lock.
        #   on_begin(job, resumed)  after begin_call/resume_call succeeds
        #   on_round(live_jobs)     after each batched decode round,
        #                           BEFORE tokens are pushed to streams
        #   on_preempt(job)         after a slot is preempted
        #   on_complete(job, cancelled)  after finish_call + records
        self.on_begin: Optional[Callable[[dict, bool], None]] = None
        self.on_round: Optional[Callable[[List[dict]], None]] = None
        self.on_preempt: Optional[Callable[[dict], None]] = None
        self.on_complete: Optional[Callable[[dict, bool], None]] = None
        # streaming per-priority accumulators (bounded-record safe):
        # wait = enqueue->begin admission wait, lat = wait + service.
        self._acc: Dict[int, Dict[str, List[float]]] = defaultdict(
            lambda: {"wait": [], "serv": [], "ttft": [], "tbt": []})
        self._acc_preempts: Counter = Counter()     # completed-call sums
        self._acc_cancelled: Counter = Counter()
        # queue-depth samples, one per decode round, deterministically
        # decimated (stride doubles once the buffer fills) so percentile
        # estimates stay bounded at any scale.
        self._qd_samples: List[int] = []
        self._qd_stride = 1
        self._qd_n = 0
        self._qd_max = 0
        self._qd_sum = 0
        self._pred_next: Optional[int] = None
        self._pred_hits = 0
        self._pred_total = 0

        self._cv = witness_condition("scheduler.cv")
        # (prio, deadline|inf, seq, job): priority, then EDF, then FIFO.
        # Preempted jobs are re-pushed under their ORIGINAL key, so a
        # resumed stream runs ahead of later same-priority arrivals.
        self._queue: List[Tuple[int, float, int, dict]] = []
        self._seq = 0
        self._inflight = 0
        self._stop = False
        # serializes ALL service access (the engine's concurrency
        # model: one dispatcher at a time — analysis COARSE_LOCKS)
        self._svc_lock = witness_rlock("scheduler.svc")
        self.started = start
        self._worker = None
        if start:
            self._worker = threading.Thread(
                target=self._loop, name="llms-router", daemon=True)
            self._worker.start()

    # -- app/session management ---------------------------------------- #
    def register_app(self, name: str, priority="foreground",
                     family: Optional[str] = None) -> AppSession:
        sess = AppSession(self, name, parse_priority(priority),
                          family=family)
        self.sessions[name] = sess
        return sess

    def new_ctx(self, session: AppSession, system_prompt=None):
        """Create a context; a system prompt is encoded THROUGH the
        router's dispatch path (inline, ahead of the queue) so
        ``call_records`` and the §3.4 predictor observe it."""
        with self._svc_lock:
            kw = ({"family": session.family}
                  if getattr(session, "family", None) else {})
            stub = self.svc.newLLMCtx(**kw)
        if system_prompt is not None and len(system_prompt):
            req = GenerationRequest(prompt=list(system_prompt),
                                    max_new_tokens=0)
            job = self._make_job(
                session, stub, req,
                GenerationStream(stub.ctx_id, req, clock=self._now), None)
            self._run_job(job)
            err = job["stream"].error
            if err is not None:
                raise err
        return stub

    def del_ctx(self, session: AppSession, stub):
        with self._svc_lock:
            return self.svc.delLLMCtx(stub)

    # -- admission ------------------------------------------------------ #
    def submit(self, session: AppSession, stub, prompt,
               max_new_tokens: int = 16) -> Future:
        """Legacy Future-based admission (compat shim over the stream
        protocol): the Future resolves to (stub, tokens) and supports
        ``cancel()`` while the job is still queued."""
        request = GenerationRequest(prompt=prompt,
                                    max_new_tokens=max_new_tokens)
        fut: Future = Future()
        self._admit(session, stub, request,
                    GenerationStream(stub.ctx_id, request, clock=self._now),
                    fut)
        return fut

    def submit_request(self, session: AppSession, stub,
                       request: GenerationRequest) -> GenerationStream:
        stream = GenerationStream(stub.ctx_id, request, clock=self._now)
        self._admit(session, stub, request, stream, None)
        return stream

    def _make_job(self, session, stub, request, stream, future) -> dict:
        prio = (session.priority if request.priority is None
                else parse_priority(request.priority))
        dl = math.inf if request.deadline is None else float(request.deadline)
        return {"session": session, "stub": stub, "request": request,
                "stream": stream, "future": future, "state": None,
                "prio": prio, "deadline": dl, "seq": -1,
                "t_enqueue": self._now(), "t_start": None}

    def _admit(self, session, stub, request, stream, future):
        job = self._make_job(session, stub, request, stream, future)
        with self._cv:
            if self._stop:
                raise RuntimeError("router is shut down")
            job["seq"] = self._seq
            self._seq += 1
            heapq.heappush(self._queue,
                           (job["prio"], job["deadline"], job["seq"], job))
            self._cv.notify()

    def _requeue(self, job):
        with self._cv:
            heapq.heappush(self._queue,
                           (job["prio"], job["deadline"], job["seq"], job))
            self._cv.notify()

    def _preemptable_head(self, prio: int, active_cids) -> Optional[dict]:
        """The queue-head job, iff it strictly outranks ``prio`` and
        could actually take the freed slot: not on an active context
        (preempting for it would leave a suspended generation the
        newcomer cannot legally overlap — begin_call refuses — and
        finishing first hands it a warm cache anyway), not a fresh call
        on a context with an earlier generation preempted in the queue
        (same overlap rule: ``_pop_locked`` would refuse to seat it, so
        the eviction would be wasted), and not exclusive (an exclusive
        head waits for the engine to drain; evicting one slot of many
        cannot seat it)."""
        with self._cv:
            head = self._queue[0][3] if self._queue else None
            blocked = (head is not None and head["state"] is None
                       and any(k[3]["state"] is not None
                               and k[3]["stub"].ctx_id
                               == head["stub"].ctx_id
                               for k in self._queue))
        if (head is None or head["prio"] >= prio
                or head["stub"].ctx_id in active_cids
                or blocked
                or getattr(head["request"], "exclusive", False)):
            return None
        return head

    def _higher_priority_waiting(self, prio: int, cid: int) -> bool:
        """B=1 compat form of the preemption predicate."""
        return self._preemptable_head(prio, {cid}) is not None

    # -- dispatch -------------------------------------------------------- #
    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop and not self._queue:
                    return
                jobs = self._pop_locked(self.decode_batch, set())
                self._inflight += 1
            try:
                if jobs:
                    self._run_batch(jobs)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    @requires_lock("_cv")
    def _pop_locked(self, limit: int, active_cids: set) -> List[dict]:
        """Pop up to ``limit`` batch-compatible jobs in priority order
        (caller holds ``_cv``).  A job is skipped — left queued, order
        preserved — when its context is already decoding in this batch
        (two generations may never overlap one context), when it is a
        FRESH call on a context whose earlier generation sits preempted
        in the queue (``begin_call`` refuses to overlap the suspended
        state — the old generation must resume and finish first), or
        when exclusivity forbids sharing: an ``exclusive`` request only
        runs as the sole member of an empty batch.

        Degraded storage (ResidencyEngine.degraded, DESIGN.md §6) sheds
        BACKGROUND jobs while any FOREGROUND job waits: every admission
        may cost an evict+recompute, so that bandwidth is reserved for
        the user-facing call.  When only background work remains it is
        admitted normally — the drain must keep making progress (and
        keep ticking the probe that exits degraded mode) or the queue
        would livelock."""
        suspended_cids = {k[3]["stub"].ctx_id for k in self._queue
                          if k[3]["state"] is not None}
        degraded = bool(getattr(getattr(self.svc, "res", None),
                                "degraded", False))
        shed_bg = degraded and any(k[3]["prio"] == FOREGROUND
                                   for k in self._queue)
        taken: List[dict] = []
        skipped: List[Tuple] = []
        while self._queue and len(taken) < limit:
            key = heapq.heappop(self._queue)
            job = key[3]
            cid = job["stub"].ctx_id
            exclusive = getattr(job["request"], "exclusive", False)
            if shed_bg and job["prio"] != FOREGROUND:
                skipped.append(key)
                self.bg_shed += 1
                continue
            if exclusive and (taken or active_cids):
                # an exclusive head WAITS for the engine to drain; stop
                # scanning so nothing behind it jumps the line and the
                # batch shrinks toward the empty engine it needs
                heapq.heappush(self._queue, key)
                break
            if cid in active_cids or (job["state"] is None
                                      and cid in suspended_cids):
                skipped.append(key)
                continue
            taken.append(job)
            active_cids.add(cid)
            if exclusive:
                break
        for key in skipped:
            heapq.heappush(self._queue, key)
        return taken

    def _pop_batch(self, limit: int, active_cids: set) -> List[dict]:
        with self._cv:
            return self._pop_locked(limit, active_cids)

    @requires_lock("_svc_lock")
    def _start_job(self, job, active: List[dict]) -> bool:
        """Admit one popped job into the running batch: begin (or
        resume) its generation so it holds a decode slot.  Returns True
        iff the job joined ``active`` (False: cancelled or failed)."""
        stream: GenerationStream = job["stream"]
        fut: Optional[Future] = job["future"]
        if job["state"] is None:
            # t_start doubles as a "future already running" marker: a
            # watchdog-requeued fresh job must not notify its Future a
            # second time (set_running_or_notify_cancel raises once the
            # Future left PENDING)
            if (job["t_start"] is None and fut is not None
                    and not fut.set_running_or_notify_cancel()):
                stream.finish(cancelled=True)
                return False
            if stream.cancel_requested:          # cancelled while queued
                stream.finish(cancelled=True)
                return False
            if job["t_start"] is None:
                job["t_start"] = self._now()
        try:
            st = job["state"]
            if st is None:
                cid = job["stub"].ctx_id
                if self._pred_next is not None:
                    self._pred_total += 1
                    self._pred_hits += self._pred_next == cid
                job["state"] = self.svc.begin_call(job["stub"],
                                                   job["request"])
                if self.on_begin is not None:
                    self.on_begin(job, False)
            elif st.suspended:
                if stream.cancel_requested:      # cancelled while preempted
                    self._complete(job, cancelled=True)
                    return False
                self.svc.resume_call(st)
                if self.on_begin is not None:
                    self.on_begin(job, True)
            active.append(job)
            return True
        except SwapTimeoutError as e:
            # per-slice watchdog (DESIGN.md §6): the switch-in's swap
            # read exceeded swap_deadline_s.  Turn the hang into a
            # preemption — requeue under the original admission key so
            # the job retries ahead of later arrivals — bounded so a
            # permanently wedged store still fails the call
            job["watchdogs"] = job.get("watchdogs", 0) + 1
            if job["watchdogs"] > 3:
                self._fail(job, e)
            else:
                self.watchdog_preempts += 1
                self._requeue(job)
            return False
        except Exception as e:              # report to the submitting app
            self._fail(job, e)
            return False
        except BaseException as e:          # KeyboardInterrupt/SystemExit:
            self._fail(job, e)              # fail the job AND abort dispatch
            raise

    @requires_lock("_svc_lock")
    def _run_slice(self, active: List[dict], refill: bool = False):
        """One decode slice over the running batch: up to ``slice_steps``
        rounds (K=0: until every member is exhausted), each round one
        batched decode emitting one token per live generation.  Jobs
        that finish or cancel leave ``active`` in place; the survivors
        keep decoding.

        With the paged KV pool, membership is CONTINUOUS: a member that
        finishes frees its row this round and a compatible queued job
        joins the very next round — joining is a prefill plus a new
        page-table row, with no cache merge for the survivors, so there
        is no reason to wait for the slice boundary.  (Slot-cache mode
        keeps boundary-only refill via ``_rebalance``; an exclusive
        queue head still blocks refill because ``_pop_locked`` refuses
        to pop it into a non-empty batch.)"""
        K = self.slice_steps
        cont = (refill and K > 0
                and bool(getattr(self.svc, "paged", False)))
        n = 0
        while active and (K <= 0 or n < K):
            live = []
            for job in list(active):
                if job["stream"].cancel_requested:
                    active.remove(job)
                    self._complete(job, cancelled=True)
                elif job["state"].exhausted:
                    active.remove(job)
                    self._complete(job)
                else:
                    live.append(job)
            if (cont and len(live) < self.decode_batch
                    and not any(getattr(j["request"], "exclusive", False)
                                for j in live)):
                cids = {j["stub"].ctx_id for j in live}
                for job in self._pop_batch(self.decode_batch - len(live),
                                           cids):
                    if self._start_job(job, active):
                        if not job["state"].exhausted:
                            live.append(job)
                        self.joins_mid_slice += 1
            if not live:
                return
            toks = self.svc.decode_step_batch([j["state"] for j in live])
            self.decode_rounds += 1
            self.decoded_tokens += sum(t is not None for t in toks)
            self._sample_queue_depth()
            if self.on_round is not None:
                # hook BEFORE the pushes: a virtual clock advanced here
                # stamps this round's tokens at the post-round instant
                self.on_round(live)
            for job, tok in zip(live, toks):
                if tok is not None:
                    job["stream"].push(tok)
                if job["state"].exhausted:
                    active.remove(job)
                    self._complete(job)
            n += 1

    @requires_lock("_svc_lock")
    def _rebalance(self, active: List[dict]):
        """Between slices: evict slots for strictly-higher-priority
        waiters (preemption suspends ONE generation, the rest of the
        batch keeps decoding), then refill free slots from the queue."""
        while active:
            victim = max(active, key=lambda j: (j["prio"], j["seq"]))
            active_cids = {j["stub"].ctx_id for j in active}
            # a waiter can only be seated by eviction when no slot is
            # free — and a running EXCLUSIVE generation blocks every
            # slot, so it counts as a full engine (else a foreground
            # arrival would wait out its whole generation)
            full = (len(active) >= self.decode_batch
                    or any(getattr(j["request"], "exclusive", False)
                           for j in active))
            if not full or self._preemptable_head(
                    victim["prio"], active_cids) is None:
                break
            # suspend BEFORE dropping the victim from ``active``: if the
            # switch-out throws, _run_batch's handler still owns the job
            # and fails it properly (stream resolves, slot released)
            self.svc.suspend_call(victim["state"])
            active.remove(victim)
            victim["stream"].n_preempts += 1
            self.preemptions += 1
            self.preemptions_by_prio[victim["prio"]] += 1
            if self.on_preempt is not None:
                self.on_preempt(victim)
            self._requeue(victim)
        free = self.decode_batch - len(active)
        if free > 0 and not any(getattr(j["request"], "exclusive", False)
                                for j in active):
            cids = {j["stub"].ctx_id for j in active}
            for job in self._pop_batch(free, cids):
                self._start_job(job, active)

    def _run_batch(self, jobs: List[dict],
                   max_slices: Optional[int] = None,
                   refill: bool = True) -> str:
        """Run a batch of popped jobs until every member finishes, is
        cancelled, or is suspended (-> re-queued).  ``max_slices``
        bounds the slices run THIS call (used by ``pump``: the whole
        surviving batch is then suspended and re-queued); preempted/
        paused jobs keep their state and continue from the interrupted
        decode on a later dispatch.  ``refill=False`` pins the batch to
        the given jobs (the inline system-prompt path must not touch
        the queue).  -> "done" | "paused" | "stopped" | "error"."""
        active: List[dict] = []
        try:
            with self._svc_lock:
                for job in jobs:
                    self._start_job(job, active)
                slices = 0
                while active:
                    self._run_slice(active, refill)
                    if not active:
                        break
                    slices += 1
                    if max_slices is not None and slices >= max_slices:
                        # suspend+requeue one at a time, popping as we
                        # go: a mid-loop failure leaves only the
                        # un-suspended jobs in ``active`` for the error
                        # handler (never a job both queued and failed)
                        while active:
                            job = active[-1]
                            self.svc.suspend_call(job["state"])
                            active.pop()
                            self._requeue(job)
                        return "paused"
                    if self._stop:              # abort mid-batch: cancel
                        while active:
                            job = active.pop()
                            self._complete(job, cancelled=True)
                        return "stopped"
                    if self.slice_steps > 0 and refill:
                        self._rebalance(active)
            return "done"
        except Exception as e:      # a failed batched step fails its batch
            for job in active:
                self._fail(job, e)
            return "error"
        except BaseException as e:          # KeyboardInterrupt/SystemExit:
            for job in active:
                self._fail(job, e)
            raise

    def _run_job(self, job, max_slices: Optional[int] = None) -> str:
        """Run one job inline as a solo batch, outside the queue (the
        system-prompt encode path)."""
        return self._run_batch([job], max_slices=max_slices, refill=False)

    @requires_lock("_svc_lock")
    def _complete(self, job, cancelled: bool = False):
        """finish_call + records + prediction hook (under _svc_lock)."""
        st, stream, fut = job["state"], job["stream"], job["future"]
        sess: AppSession = job["session"]
        cid = job["stub"].ctx_id
        self.svc.finish_call(st)
        # capture under the lock: another session's call must not slip a
        # record in between
        rec = self.svc.records[-1] if self.svc.records else {}
        self._after_call(cid)
        t_end = self._now()
        entry = {
            "app": sess.name, "priority": job["prio"], "ctx": cid,
            "wait_s": job["t_start"] - job["t_enqueue"],
            "service_s": t_end - job["t_start"],
            "switch_s": rec.get("switch_s", 0.0),
            "n_preempts": stream.n_preempts,
            "cancelled": cancelled,
        }
        if stream.t_first_token is not None:
            entry["ttft_s"] = stream.t_first_token - job["t_enqueue"]
            tbts = stream.tbt()
            if tbts:
                entry["tbt_mean_s"] = float(np.mean(tbts))
        acc = self._acc[job["prio"]]
        acc["wait"].append(entry["wait_s"])
        acc["serv"].append(entry["service_s"])
        if "ttft_s" in entry:
            acc["ttft"].append(entry["ttft_s"])
        if "tbt_mean_s" in entry:
            acc["tbt"].append(entry["tbt_mean_s"])
        self._acc_preempts[job["prio"]] += stream.n_preempts
        self._acc_cancelled[job["prio"]] += bool(cancelled)
        self.call_records.append(entry)
        stream.finish(cancelled=cancelled)
        if self.on_complete is not None:
            self.on_complete(job, cancelled)
        if fut is not None:
            fut.set_result((job["stub"], list(stream.tokens)))

    def _fail(self, job, err: BaseException):
        st = job["state"]
        if st is not None and not st.done:
            try:                    # best-effort: commit what was decoded
                with self._svc_lock:
                    self.svc.finish_call(st)
            except Exception:
                pass
        job["stream"].finish(error=err)
        if job["future"] is not None:
            job["future"].set_exception(err)

    @requires_lock("_svc_lock")
    def _after_call(self, cid: int):
        """Feed the trace history into the §3.4 AoT swap-out hint."""
        if self.predictor is None:
            return
        self.predictor.observe(cid)
        pred = self.predictor.predict(cid)
        self._pred_next = pred
        if pred is not None:
            self.prefetch_hints += 1
            self.aot_flushes += self.svc.prepare_switch(pred)

    @requires_lock("_svc_lock")
    def _sample_queue_depth(self):
        """One queue-depth sample per decode round.  The sample buffer is
        decimated deterministically (keep-every-2nd, stride doubles) once
        it fills, so percentiles stay available at 10^6-round scale."""
        with self._cv:
            qd = len(self._queue)
        self._qd_n += 1
        self._qd_sum += qd
        if qd > self._qd_max:
            self._qd_max = qd
        if self._qd_n % self._qd_stride == 0:
            self._qd_samples.append(qd)
            if len(self._qd_samples) > 65536:
                self._qd_samples = self._qd_samples[::2]
                self._qd_stride *= 2

    def pump(self, max_slices: int = 1) -> bool:
        """Inline dispatch of at most ``max_slices`` decode slices of a
        batch formed from the highest-priority compatible jobs, then
        return (unfinished members suspend and re-queue).  Deterministic
        building block for tests that need to interleave admissions with
        running generations.  A stopped router never dispatches: after
        ``abort()`` the work it promised to cancel must not run."""
        assert not self.started, "pump() is for inline (start=False) mode"
        if self._stop:
            return False
        jobs = self._pop_batch(self.decode_batch, set())
        if not jobs:
            return False
        self._run_batch(jobs, max_slices=max_slices)
        return True

    def drain(self):
        """Run (or wait for) every admitted job; returns when idle."""
        if self.started:
            with self._cv:
                while self._queue or self._inflight:
                    self._cv.wait()
            return
        while True:
            with self._cv:
                if not self._queue:
                    return
                jobs = self._pop_locked(self.decode_batch, set())
            if jobs:
                self._run_batch(jobs)

    def shutdown(self):
        if self._stop and not self._queue:
            return
        self.drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)

    def abort(self):
        """Stop WITHOUT draining: queued jobs are cancelled (futures
        cancel, streams finish cancelled), the worker stops after its
        current job.  Used by ``__exit__`` on an exception so unwinding
        doesn't first execute the whole remaining queue."""
        with self._cv:
            self._stop = True
            pending = [j for _, _, _, j in self._queue]
            self._queue.clear()
            self._cv.notify_all()
        for job in pending:
            st = job["state"]
            if st is not None and not st.done:   # suspended mid-generation:
                try:                             # release its context
                    with self._svc_lock:
                        self.svc.finish_call(st)
                except Exception:
                    pass
            if job["future"] is not None:
                job["future"].cancel()
            job["stream"].finish(cancelled=True)
        if self._worker is not None:
            self._worker.join(timeout=10.0)

    def __enter__(self) -> "ServiceRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.shutdown()

    # -- reporting ------------------------------------------------------- #
    def stats(self) -> Dict[str, Any]:
        """Aggregate QoS stats.  Per-priority sections come from the
        STREAMING accumulators (exact for every completed call even when
        ``record_limit`` bounds the retained per-call dicts)."""
        out: Dict[str, Any] = {
            "prefetch_hints": self.prefetch_hints,
            "aot_flushes": self.aot_flushes,
            "preemptions": self.preemptions,
            "preemptions_by_priority": {
                name: int(self.preemptions_by_prio.get(prio, 0))
                for prio, name in _PRIO_NAMES.items()},
            "watchdog_preempts": self.watchdog_preempts,
            "bg_shed": self.bg_shed,
            "pred_hits": self._pred_hits,
            "pred_total": self._pred_total,
            "decode_batch": self.decode_batch,
            "decode_rounds": self.decode_rounds,
            "decoded_tokens": self.decoded_tokens,
            "joins_mid_slice": self.joins_mid_slice,
            "tokens_per_round": (self.decoded_tokens / self.decode_rounds
                                 if self.decode_rounds else 0.0),
        }
        if self._qd_n:
            qs = self._qd_samples or [0]
            out["queue_depth"] = {
                "samples": self._qd_n,
                "mean": self._qd_sum / self._qd_n,
                "max": self._qd_max,
                "p50": float(np.percentile(qs, 50)),
                "p95": float(np.percentile(qs, 95)),
                "p99": float(np.percentile(qs, 99)),
            }
        for prio, name in _PRIO_NAMES.items():
            acc = self._acc.get(prio)
            if not acc or not acc["wait"]:
                continue
            waits, servs = acc["wait"], acc["serv"]
            lats = [w + s for w, s in zip(waits, servs)]
            out[name] = {
                "calls": len(waits),
                "wait_mean_s": float(np.mean(waits)),
                "wait_p50_s": float(np.percentile(waits, 50)),
                "wait_p95_s": float(np.percentile(waits, 95)),
                "wait_p99_s": float(np.percentile(waits, 99)),
                "service_mean_s": float(np.mean(servs)),
                "latency_mean_s": float(np.mean(lats)),
                "latency_p99_s": float(np.percentile(lats, 99)),
                "preempts": int(self._acc_preempts.get(prio, 0)),
                "cancelled": int(self._acc_cancelled.get(prio, 0)),
            }
            ttfts, tbts = acc["ttft"], acc["tbt"]
            if ttfts:
                out[name]["ttft_mean_s"] = float(np.mean(ttfts))
                out[name]["ttft_p50_s"] = float(np.percentile(ttfts, 50))
                out[name]["ttft_p95_s"] = float(np.percentile(ttfts, 95))
                out[name]["ttft_p99_s"] = float(np.percentile(ttfts, 99))
            if tbts:
                out[name]["tbt_mean_s"] = float(np.mean(tbts))
                out[name]["tbt_p50_s"] = float(np.percentile(tbts, 50))
                out[name]["tbt_p95_s"] = float(np.percentile(tbts, 95))
                out[name]["tbt_p99_s"] = float(np.percentile(tbts, 99))
        return out

    @requires_serialized
    def reset_stats(self):
        """Clear per-call records AND the streaming accumulators (warm
        pass -> measured pass); cumulative counters restart too."""
        self.call_records.clear()
        self._acc.clear()
        self._acc_preempts.clear()
        self._acc_cancelled.clear()
        self.preemptions = 0
        self.preemptions_by_prio.clear()
        self.watchdog_preempts = 0
        self.bg_shed = 0
        self.decode_rounds = 0
        self.decoded_tokens = 0
        self.joins_mid_slice = 0
        self._qd_samples = []
        self._qd_stride = 1
        self._qd_n = self._qd_max = self._qd_sum = 0
