"""Virtual-clock scenario driver + the repo's single trace-replay
implementation (DESIGN.md "Scale harness").

**Virtual clock.**  ``run_scenario`` replaces wall time with an
event-heap simulation clock injected into ``ServiceRouter`` and every
``GenerationStream``: the clock advances only on deterministic
scheduling events (a batched decode round costs ``spec.round_s``
virtual seconds, a begin costs ``switch_base_s`` plus prefill, an idle
engine jumps straight to the next arrival).  Model execution still
runs for real — tokens are genuinely decoded — but no code path ever
sleeps, so 10^4-10^5 synthetic contexts drive through the router on
CPU in bounded wall time while every QoS metric (TTFT, TBT, admission
wait, queue depth) is an exact, machine-portable function of the
scenario seed.  Arrivals are injected from the router's ``on_round``
hook at their exact virtual timestamps, so a burst that lands
mid-slice exercises preemption the same way a wall-clock run would.

**Replay.**  ``replay_trace`` is the wall-clock replay loop: serial
(strict trace order) or flood (admit everything, then drain, fg/bg
split).  A warm pass first keeps one-time costs (kernel builds, first
launches) out of the measured pass.

The port's copy of the JAX package's ``loadgen/driver.py``: the same
contract, with the service (``build_service``) and the multi-family
zoo (``build_zoo_service``) on ``device``.
"""
from __future__ import annotations

import hashlib
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.faults import (clear_faults, install_faults,
                                     plan_from_config, set_disk_full)
from repro_torch.core.restore import io_counters, set_disk_throttle
from repro_torch.core.requests import FOREGROUND
from repro_torch.core.scheduler import ServiceRouter, parse_priority
from repro_torch.core.service import LLMSConfig, LLMService
from repro_torch.core.zoo import ZooService
from repro_torch.loadgen.metrics import EventLog, build_report
from repro_torch.loadgen.spec import ScenarioSpec
from repro_torch.trace.synth import TraceEvent, synthesize_mixed


class VirtualClock:
    """Injectable simulation clock (callable -> current virtual time).

    ``advance`` charges a cost, ``advance_to`` jumps forward (never
    backward), and ``at`` temporarily rewinds to stamp an admission at
    its exact arrival instant while a later virtual time is current.
    """

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        self.t += dt

    def advance_to(self, t: float):
        if t > self.t:
            self.t = t

    @contextmanager
    def at(self, t: float):
        saved = self.t
        self.t = float(t)
        try:
            yield
        finally:
            self.t = max(saved, self.t)


def make_events(spec: ScenarioSpec, vocab: int) -> List[TraceEvent]:
    """The scenario's synthetic workload (deterministic in spec.seed)."""
    return synthesize_mixed(
        spec.n_contexts, spec.n_calls, vocab,
        arrival=dict(spec.arrival), ctx_pattern=spec.ctx_pattern,
        prompt_len=dict(spec.prompt_len), output_len=dict(spec.output_len),
        apps=[dict(a) for a in spec.apps],
        prompt_source=spec.prompt_source, seed=spec.seed)


def build_service(spec: ScenarioSpec, model, params,
                  device="cuda") -> LLMService:
    """The service under test, configured per the spec (the model is
    supplied by the caller — src/repro_torch/loadgen stays
    model-agnostic), on ``device`` (the card unless the caller asks for
    the CPU)."""
    if spec.disk_bw is None:
        set_disk_throttle(None)
    else:
        set_disk_throttle(spec.disk_bw, spec.disk_lat)
    dl = spec.faults.get("swap_deadline_s") if spec.faults else None
    sc = LLMSConfig(policy=spec.policy, max_ctx_len=spec.max_ctx_len,
                    chunk_tokens=spec.chunk_tokens,
                    memory_budget=spec.memory_budget,
                    decode_batch=spec.decode_batch,
                    quant_resident=spec.quant_resident,
                    paged_pool=spec.paged_pool,
                    record_limit=spec.record_limit,
                    swap_deadline_s=None if dl is None else float(dl),
                    swap_dir=tempfile.mkdtemp(
                        prefix=f"loadgen_{spec.name}_"))
    svc = LLMService(model, params, sc, device=device)
    if spec.profile and sc.use_pipeline:
        svc.profile_pipeline()
    return svc


def build_zoo_service(spec: ScenarioSpec,
                      models: Dict[str, Tuple[Any, Any]],
                      device="cuda") -> ZooService:
    """A multi-family ``ZooService`` under test, on ``device``: one
    member per entry of ``models`` (family -> (model, params)), every
    member configured from the spec but sharing ONE byte budget / swap
    tier / eviction order.  Per-member capability knobs derive from
    each family's KVSpec — ``quant_resident`` only lands on families
    that declare it."""
    if spec.disk_bw is None:
        set_disk_throttle(None)
    else:
        set_disk_throttle(spec.disk_bw, spec.disk_lat)
    dl = spec.faults.get("swap_deadline_s") if spec.faults else None
    members: Dict[str, Tuple[Any, Any, LLMSConfig]] = {}
    for fam, (model, params) in models.items():
        sc = LLMSConfig(
            policy=spec.policy, max_ctx_len=spec.max_ctx_len,
            chunk_tokens=spec.chunk_tokens,
            memory_budget=spec.memory_budget,
            decode_batch=spec.decode_batch,
            quant_resident=(spec.quant_resident
                            and model.kv_spec().quant_resident),
            paged_pool=spec.paged_pool,
            swap_deadline_s=None if dl is None else float(dl))
        members[fam] = (model, params, sc)
    return ZooService(members, memory_budget=spec.memory_budget,
                      swap_dir=tempfile.mkdtemp(
                          prefix=f"loadgen_{spec.name}_"), device=device)


def bind_apps_by_ctx(events: List[TraceEvent],
                     spec: ScenarioSpec) -> List[TraceEvent]:
    """Deterministically rebind every event to the app that owns its
    context (ctx_id modulo the app list), so each context's calls all
    belong to ONE app — the precondition for the per-family
    solo-vs-mixed token-identity probe (mixed_zoo gate): filtering the
    bound events by app yields exactly that family's workload."""
    apps = [dict(a) for a in spec.apps]
    for ev in events:
        a = apps[ev.ctx_id % len(apps)]
        ev.app = str(a["name"])
        ev.priority = str(a.get("priority", "foreground"))
    return events


def run_scenario(spec: ScenarioSpec, svc: Any, vocab: int, *,
                 log_keep: Optional[int] = 4096,
                 events: Optional[List[TraceEvent]] = None
                 ) -> Dict[str, Any]:
    """Drive one scenario through a ``ServiceRouter`` under the virtual
    clock; -> the report dict (see ``metrics.build_report``).

    The caller owns ``svc`` (build one with ``build_service``); the
    router is created here so the clock wires into every stream."""
    assert spec.slice_steps >= 1, \
        "scenario driver needs slice_steps >= 1 (refill/preempt between " \
        "slices); use replay_trace for whole-generation dispatch"
    if events is None:
        events = make_events(spec, vocab)
    clock = VirtualClock()
    log = EventLog(keep=log_keep)
    io0 = io_counters()
    wall0 = time.perf_counter()

    # fault plan (DESIGN.md §6): installed for the whole run, cleared on
    # exit; disk-full windows toggle on VIRTUAL time so every injected
    # failure — and the degraded-mode transitions it causes — lands at a
    # seed-deterministic instant
    fault_cfg = dict(spec.faults) if spec.faults else {}
    windows = [(float(a), float(b))
               for a, b in fault_cfg.get("disk_full_windows", ())]
    if fault_cfg:
        fspecs, fseed = plan_from_config(fault_cfg, spec.seed)
        install_faults(fspecs, fseed)
    else:
        clear_faults()
    df_on = False

    def update_disk_full():
        nonlocal df_on
        if not windows:
            return
        on = any(a <= clock.t < b for a, b in windows)
        if on != df_on:
            df_on = on
            set_disk_full(on)
            log.emit("disk_full", clock.t, int(on))

    router = ServiceRouter(svc, predict=spec.predict, start=False,
                           slice_steps=spec.slice_steps, clock=clock,
                           record_limit=spec.record_limit)
    sessions = {a["name"]: router.register_app(
        a["name"], a.get("priority", "foreground"),
        family=a.get("family")) for a in spec.apps}
    stubs: Dict[int, Any] = {}
    streams: List[Any] = []
    stream_apps: List[str] = []
    next_ev = 0

    def inject_due():
        """Admit every arrival whose virtual time has passed, stamped
        at its exact arrival instant."""
        nonlocal next_ev
        while next_ev < len(events) and events[next_ev].time <= clock.t:
            ev = events[next_ev]
            next_ev += 1
            sess = sessions[ev.app]
            if ev.ctx_id not in stubs:
                stubs[ev.ctx_id] = sess.new_ctx()
            with clock.at(ev.time):
                streams.append(sess.stream(
                    stubs[ev.ctx_id], ev.prompt.tolist(),
                    max_new_tokens=ev.max_new, priority=ev.priority))
            stream_apps.append(ev.app)
            log.emit("arrive", ev.time, ev.ctx_id, ev.priority, ev.app)

    def on_begin(job, resumed):
        dt = spec.switch_base_s
        if not resumed:
            dt += spec.prefill_per_token_s * len(job["request"].prompt)
        clock.advance(dt)
        log.emit("begin", clock.t, job["stub"].ctx_id, int(resumed),
                 job["prio"])

    def on_round(live):
        clock.advance(spec.round_s)
        update_disk_full()
        log.emit("round", clock.t, len(live))
        inject_due()

    def on_preempt(job):
        log.emit("preempt", clock.t, job["stub"].ctx_id, job["prio"])

    def on_complete(job, cancelled):
        log.emit("done", clock.t, job["stub"].ctx_id, job["prio"],
                 len(job["stream"].tokens), int(cancelled))

    router.on_begin = on_begin
    router.on_round = on_round
    router.on_preempt = on_preempt
    router.on_complete = on_complete

    try:
        with router:
            update_disk_full()
            while True:
                inject_due()
                if router.pump(max_slices=None):
                    continue
                if next_ev >= len(events):
                    break
                # engine idle, nothing queued: jump to the next arrival;
                # a long enough virtual gap lets the AoT writes complete
                # (device-idle I/O, benchmarks/common.py regime note)
                gap = events[next_ev].time - clock.t
                if spec.idle_flush_s is not None and gap > spec.idle_flush_s:
                    svc.swapper.flush(raise_errors=False)
                    log.emit("flush", clock.t, gap)
                clock.advance_to(events[next_ev].time)
                update_disk_full()

        # settle in-flight AoT writes BEFORE the final byte snapshot: the
        # last swap-outs are still on the swapper threads, and counting a
        # write depends on whether it executed yet — the one wall-clock
        # race that would leak into an otherwise deterministic report.
        # Errors never raise here: failed jobs were already classified
        # and counted on the workers (fault scenarios).
        svc.swapper.flush(raise_errors=False)
        wall_s = time.perf_counter() - wall0
        io1 = io_counters()
        n_stuck = sum(not s.done for s in streams)
        n_errors = sum(s.error is not None for s in streams)
        n_errors_fg = sum(
            s.error is not None
            and parse_priority(s.request.priority) == FOREGROUND
            for s in streams)
        # recovery-identity probe: every decoded token, streams in
        # admission order — two runs that recover differently (or a
        # fault run that diverges from the fault-free run) hash apart
        sha = hashlib.sha256()
        for s in streams:
            sha.update((",".join(map(str, s.tokens)) + ";").encode())
        # per-app split of the same probe: the mixed_zoo gate compares
        # each app's hash against the family served SOLO at the same seed
        by_app = {a["name"]: hashlib.sha256() for a in spec.apps}
        for s, app in zip(streams, stream_apps):
            by_app[app].update((",".join(map(str, s.tokens)) + ";").encode())
        return build_report(
            spec, router_stats=router.stats(), svc_stats=svc.stats(),
            log=log, virtual_s=clock.t, wall_s=wall_s,
            io_read=io1["read"] - io0["read"],
            io_written=io1["write"] - io0["write"],
            n_streams=len(streams), n_stuck=n_stuck, n_errors=n_errors,
            n_errors_fg=n_errors_fg, tokens_sha256=sha.hexdigest(),
            tokens_sha_by_app={k: v.hexdigest()
                               for k, v in by_app.items()},
            mem_used=svc.mem.used)
    finally:
        set_disk_full(False)
        clear_faults()


# --------------------------------------------------------------------- #
# wall-clock trace replay (the single implementation)
# --------------------------------------------------------------------- #
def replay_trace(svc: LLMService, events, *, mode: str = "serial",
                 max_new: int = 4, idle_flush_s: Optional[float] = 60.0,
                 warm: bool = True, predict: bool = False,
                 slice_steps: int = 0,
                 apps: Tuple[Tuple[str, str], ...] = (
                     ("bench", "foreground"),),
                 route: Optional[Callable[[Any], str]] = None,
                 measured_throttle: Optional[Tuple[float, float]] = (
                     25e6, 2e-4)) -> Dict[str, Any]:
    """Replay a trace through a ``ServiceRouter`` (inline dispatch).

      mode="serial"  one call at a time in strict trace order, arrival
                     gaps bookkept not slept (gaps > ``idle_flush_s``
                     flush the AoT writes) — benchmarks/common.replay.
      mode="flood"   admit every event up front, then drain: exercises
                     queueing/preemption — examples/serve_trace.py.

    ``route(ev) -> app name`` picks the submitting session (default:
    the first app).  With ``warm`` a full pass runs first (throttle
    off) so jit compilation never lands in the measured pass; stats are
    reset in between (``router.reset_stats`` — accumulators too, not
    just the record lists).  -> ``svc.stats()`` + ``"router"`` section.
    """
    assert mode in ("serial", "flood"), mode
    with ServiceRouter(svc, predict=predict, start=False,
                       slice_steps=slice_steps) as router:
        sessions = {name: router.register_app(name, prio)
                    for name, prio in apps}
        first = apps[0][0]
        pick = route or (lambda ev: first)

        def one_pass():
            stubs: Dict[int, Any] = {}
            if mode == "serial":
                prev_t = None
                for ev in events:
                    sess = sessions[pick(ev)]
                    if ev.ctx_id not in stubs:
                        stubs[ev.ctx_id] = sess.new_ctx()
                    if idle_flush_s is not None and prev_t is not None \
                            and ev.time - prev_t > idle_flush_s:
                        svc.swapper.flush()   # device idle: I/O completed
                    sess.call(stubs[ev.ctx_id], ev.prompt.tolist(),
                              max_new_tokens=max_new)
                    prev_t = ev.time
            else:
                streams = []
                for ev in events:
                    sess = sessions[pick(ev)]
                    if ev.ctx_id not in stubs:
                        stubs[ev.ctx_id] = sess.new_ctx()
                    streams.append(sess.stream(stubs[ev.ctx_id],
                                               ev.prompt.tolist(),
                                               max_new_tokens=max_new))
                router.drain()
                for s in streams:
                    s.result()    # surface call failures, like serial
            return stubs

        if warm:
            set_disk_throttle(None)       # warm pass: compile everything
            sess0 = sessions[first]
            for stub in one_pass().values():
                sess0.del_ctx(stub)
            svc.records.clear()
            router.reset_stats()
            if measured_throttle is not None:
                set_disk_throttle(*measured_throttle)
        one_pass()
        st = svc.stats()
        st["router"] = router.stats()
    return st
