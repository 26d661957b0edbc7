"""Serving driver: replay a synthesized context-switching trace through
the multi-app ServiceRouter (compressed-time: arrival gaps are bookkept,
not slept).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --reduced --device cpu --policy llms --contexts 4 --calls 24 \
      --concurrency 2 --slice-steps 4

``--device`` picks where the model and the service live: ``cuda`` (the
default) runs on the card and fails without one; ``cpu`` runs the plain
PyTorch versions of the kernels (tests, rehearsal).

``--concurrency N`` registers N app sessions with the router; each app
submits its share of the trace from its own thread, so admission is
genuinely concurrent while model execution stays serial (the paper's
working-set lock).  ``--priority-mix a:b`` assigns priorities to apps
round-robin (a foreground apps, then b background apps, repeating);
the router admits foreground calls ahead of queued background ones and
reports per-priority latency (queue wait + service) plus TTFT/TBT
percentiles from the stream timestamps.

``--slice-steps K`` enables decode-slice dispatch: generations run in
bounded K-step slices and a newly arrived foreground request preempts
an in-flight background stream mid-generation.  A/B the flag (0 =
whole-generation dispatch) to see foreground TTFT drop.

``--arch deepseek-v2-lite-16b`` (the MLA + MoE family) and ``--arch
rwkv6-1.6b`` (the RWKV6 family) serve on slot caches: their KVSpecs
declare no paged pool and no batched decode, so the pool stays off
whatever ``--paged-pool`` says, and ``--decode-batch > 1`` decodes a
round's members one after another, as in the reference.  RWKV6's
constant-size state moves as one whole-state snapshot under every
policy (no quant-resident tier: ``--quant-resident`` is refused).

The port's copy of the JAX package's ``launch/serve.py``: weights come
from ``model.init`` with a seeded ``torch.Generator`` on the device,
and ``main`` takes ``argv`` so that a caller can run it in-process.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.scheduler import ServiceRouter
from repro_torch.core.service import LLMSConfig, LLMService, POLICIES
from repro_torch.models.registry import build_model
from repro_torch.trace.synth import PATTERNS, synthesize


def parse_priority_mix(mix: str, n_apps: int):
    """"a:b" -> per-app priority names, fg-first round-robin."""
    try:
        fg, bg = (int(x) for x in mix.split(":"))
        if fg < 0 or bg < 0 or fg + bg == 0:
            raise ValueError(mix)
    except ValueError:
        raise SystemExit(
            f"--priority-mix must be 'FG:BG' with FG+BG > 0, got {mix!r}") from None
    cycle = ["foreground"] * fg + ["background"] * bg
    return [cycle[i % len(cycle)] for i in range(n_apps)]


def run_trace(router: ServiceRouter, events, n_apps: int = 1,
              priority_mix: str = "1:1", max_new: int = 8, verbose=False,
              pace: float = 0.0):
    """Replay ``events`` through ``router`` with ``n_apps`` submitting
    apps; contexts are assigned to apps round-robin.  ``pace`` replays
    the trace's Poisson arrival gaps in real time (wall seconds per
    trace second, 0 = submit everything immediately) — with a threaded
    router and ``slice_steps`` set, paced foreground arrivals land
    mid-generation and preempt in-flight background streams."""
    apps = [router.register_app(f"app{i}", prio) for i, prio in
            enumerate(parse_priority_mix(priority_mix, n_apps))]
    session_of = {}                 # ctx_id -> AppSession
    stubs = {}
    for ev in events:
        if ev.ctx_id not in stubs:
            sess = apps[ev.ctx_id % n_apps]
            session_of[ev.ctx_id] = sess
            stubs[ev.ctx_id] = sess.new_ctx()

    streams = []
    t0 = time.perf_counter()

    def submit_all(sess):
        for ev in events:
            if session_of[ev.ctx_id] is sess:
                if pace > 0:
                    lag = ev.time * pace - (time.perf_counter() - t0)
                    if lag > 0:
                        time.sleep(lag)
                streams.append(sess.stream(stubs[ev.ctx_id],
                                           ev.prompt.tolist(),
                                           max_new_tokens=max_new))

    if router.started and n_apps > 1:
        threads = [threading.Thread(target=submit_all, args=(s,))
                   for s in apps]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for sess in apps:
            submit_all(sess)
    router.drain()
    errors = [s.error for s in streams if s.error is not None]
    for e in errors[:3]:
        print(f"  !! dropped call: {type(e).__name__}: {e}")

    if verbose:
        for r in router.call_records:
            ttft = r.get("ttft_s")
            print(f"  {r['app']:6s} prio={r['priority']} ctx={r['ctx']}"
                  f" wait={r['wait_s']*1e3:7.2f}ms"
                  f" switch={r['switch_s']*1e3:7.2f}ms"
                  f" service={r['service_s']*1e3:7.1f}ms"
                  + (f" ttft={ttft*1e3:7.2f}ms" if ttft is not None else "")
                  + (f" preempts={r['n_preempts']}"
                     if r.get("n_preempts") else ""))
    stats = router.svc.stats()
    stats["router"] = router.stats()
    stats["failed_calls"] = len(errors)
    return stats


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    help="a ported configuration: the dense ones, "
                         "deepseek-v2-lite-16b (MLA + MoE) or rwkv6-1.6b "
                         "(RWKV6)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model and the service run (cpu: the "
                         "kernels' plain versions, for tests and "
                         "rehearsal)")
    ap.add_argument("--policy", default="llms", choices=POLICIES)
    ap.add_argument("--pattern", default="markov", choices=PATTERNS)
    ap.add_argument("--contexts", type=int, default=4)
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--max-ctx", type=int, default=256)
    ap.add_argument("--budget-mib", type=float, default=2.0)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--concurrency", type=int, default=1,
                    help="number of app sessions submitting the trace")
    ap.add_argument("--priority-mix", default="1:1",
                    help="fg:bg app ratio, assigned round-robin")
    ap.add_argument("--slice-steps", type=int, default=0,
                    help="decode-slice length K (0 = whole-generation "
                         "dispatch; >0 enables mid-generation preemption)")
    ap.add_argument("--decode-batch", type=int, default=1,
                    help="decode slots B: up to B queued generations "
                         "decode as one batched round (1 = the serial "
                         "paper-prototype path)")
    ap.add_argument("--paged-pool", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="decode over the unified paged KV pool "
                         "(switch-in = a page-table read; "
                         "--no-paged-pool serves from per-slot caches, "
                         "restored by the layer-pipelined I/O + "
                         "recompute of Fig. 8; swap and lmk always do, "
                         "and so do the families without a pool: MLA, "
                         "RWKV6)")
    ap.add_argument("--quant-resident", action="store_true",
                    help="attend over quantized chunks in place: 8-bit "
                         "chunks stay int8 (QUANT pages of the pool, or "
                         "the int8 segments of a slot cache) behind the "
                         "decode attention, 4/2-bit re-grid at admission "
                         "(requires a chunked policy and a family whose "
                         "KVSpec declares quant_resident: dense, MLA; "
                         "not RWKV6)")
    ap.add_argument("--pace", type=float, default=0.0,
                    help="wall seconds per trace second when replaying "
                         "arrival gaps (0 = compressed time)")
    ap.add_argument("--swap-dir", default=None,
                    help="directory of the chunk files (default: a new "
                         "temporary directory)")
    return ap.parse_args(argv)


def serve(model, params, args: argparse.Namespace, threaded=None,
          on_start=None, on_end=None, verbose=True, events=None):
    """The serving step of ``main`` on built weights: the service config
    from ``args``, the §3.3.i pipeline profile where the policy pipelines
    restores, a synthesized trace, the router and its replay.  The
    service runs on ``model``'s device.  ``threaded`` (default: more
    than one app) starts the router's worker thread and submits each
    app's share from a thread of its own; ``False`` replays inline,
    deterministically.  ``on_start(svc, router)`` runs just before the
    replay and ``on_end(svc, router, events)`` just after it, on the
    same router.  ``events`` (``trace.synth.TraceEvent``s) replaces the
    synthesized trace.  -> run_trace's stats, with ``wall_s``."""
    sc = LLMSConfig(policy=args.policy, max_ctx_len=args.max_ctx,
                    memory_budget=int(args.budget_mib * 2**20),
                    decode_batch=args.decode_batch,
                    quant_resident=args.quant_resident,
                    paged_pool=args.paged_pool,
                    swap_dir=args.swap_dir or tempfile.mkdtemp(
                        prefix="llms_serve_"))
    if events is None:
        events = synthesize(args.contexts, args.calls, model.cfg.vocab,
                            pattern=args.pattern, scale=0.1, seed=args.seed)
    if threaded is None:
        threaded = args.concurrency > 1
    with LLMService(model, params, sc, device=model.device) as svc:
        if sc.use_pipeline:
            svc.profile_pipeline()
        with ServiceRouter(svc, predict=True, start=threaded,
                           slice_steps=args.slice_steps) as router:
            if on_start is not None:
                on_start(svc, router)
            t0 = time.time()
            stats = run_trace(router, events,
                              n_apps=max(1, args.concurrency),
                              priority_mix=args.priority_mix,
                              max_new=args.max_new, verbose=verbose,
                              pace=args.pace)
            stats["wall_s"] = time.time() - t0
            if on_end is not None:
                on_end(svc, router, events)
    return stats


def main(argv=None):
    """Build the model and its seeded weights on ``--device``, serve the
    trace and print the stats as JSON.  -> the stats."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))
    stats = serve(model, params, args)
    print(json.dumps(stats, indent=1))
    return stats


if __name__ == "__main__":
    main()
