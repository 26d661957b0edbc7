"""The port's ServiceRouter against the JAX package's, on one trace.

Both packages replay the SAME synthesized trace (``trace.synth``, which
the two packages produce byte for byte: tests/test_torch_loadgen.py)
through their own ``launch.serve.run_trace``: an inline router
(``start=False``), 2 apps at priority mix 1:1, ``slice_steps=4``,
``decode_batch=4`` and next-context prediction on, over the reduced
smollm-360m (G = 2, tied head) with the same weights.  Every completed
call is logged in completion order with its context, tokens,
preemptions and bit plan (and quant flags with ``quant_resident``), and
every eviction in between.  The logs must be equal, and so must the
router's counts (rounds, tokens, joins, preemptions, prediction hits,
hints and AoT flushes, queue depth, per-priority call counts) and the
dropped calls.  Tolerance: none.

The head is scaled 16x in both packages' weights (with a tied head the
embedding it shares), as in tests/test_torch_service.py: the two
packages' logits differ at bf16 level, and a greedy pick between two
near-tied logits could flip (ROADMAP.md, Queue 3).  With it, every
token of these traces is equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, services  # noqa: F401
from repro.core.scheduler import ServiceRouter as JRouter
from repro.launch import serve as jserve
from repro.trace.synth import synthesize as jsynthesize
from repro_torch.core.scheduler import ServiceRouter as TRouter
from repro_torch.launch import serve as tserve
from repro_torch.trace.synth import synthesize as tsynthesize

RAW_CHUNK = 2 * 4 * 16 * 2 * 16 * 2     # k+v, L * cs * KV * hd, bf16
# Table-3 lengths scaled to prompts of 1-48 tokens, which fit the half
# window (64) of max_ctx_len 128 with the 6 new tokens
SCALE = 0.05


def _replay(svc, router_cls, run_trace, events, *, start=False, n_apps=2,
            max_new=6, quant=False):
    """Run ``events`` through a router over ``svc`` with ``run_trace``;
    -> (log of completions and evictions, run_trace's stats, decode
    batch sizes round by round)."""
    log, sizes = [], []
    res = svc.res
    evict = res.evict

    def ev(key):
        log.append(("evict", tuple(int(k) for k in key)))
        return evict(key)

    res.evict = ev
    with router_cls(svc, predict=True, start=start, slice_steps=4) as router:
        def done(job, cancelled):
            cid = job["stub"].ctx_id
            chunks = sorted(svc.contexts[cid].chunks.items())
            entry = ("done", cid, tuple(int(t) for t in job["stream"].tokens),
                     job["stream"].n_preempts, bool(cancelled),
                     tuple(m.bits for _, m in chunks))
            if quant:
                entry += (tuple(m.quant for _, m in chunks),)
            log.append(entry)

        router.on_complete = done
        router.on_round = lambda live: sizes.append(len(live))
        stats = run_trace(router, events, n_apps=n_apps, priority_mix="1:1",
                          max_new=max_new)
    return log, stats, sizes


_COUNTS = ("prefetch_hints", "aot_flushes", "preemptions",
           "preemptions_by_priority", "watchdog_preempts", "bg_shed",
           "pred_hits", "pred_total", "decode_batch", "decode_rounds",
           "decoded_tokens", "joins_mid_slice", "tokens_per_round",
           "queue_depth")


def _counts(stats):
    r = stats["router"]
    out = {k: r.get(k) for k in _COUNTS}
    for prio in ("foreground", "background"):
        if prio in r:
            out[prio] = {k: r[prio][k] for k in ("calls", "preempts",
                                                 "cancelled")}
    out["failed_calls"] = stats["failed_calls"]
    return out


def _first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return len(a), a[len(b):], b[len(a):]


def _run_both(policy="llms", quant=False, seed=2, n_ctx=6, n_calls=16,
              budget_chunks=3, paged_pool=True):
    js, ts, tcfg = services(policy=policy, decode_batch=4,
                            quant_resident=quant, paged_pool=paged_pool,
                            budget=budget_chunks * RAW_CHUNK)
    events_j = jsynthesize(n_ctx, n_calls, tcfg.vocab, pattern="markov",
                           scale=SCALE, seed=seed)
    events_t = tsynthesize(n_ctx, n_calls, tcfg.vocab, pattern="markov",
                           scale=SCALE, seed=seed)
    with js, ts:
        out_j = _replay(js, JRouter, jserve.run_trace, events_j, quant=quant)
        out_t = _replay(ts, TRouter, tserve.run_trace, events_t, quant=quant)
    return out_j, out_t


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_router_replay_matches_reference(quant):
    """decode_batch 4, slice_steps 4, predict, 2 apps at 1:1, with the
    bf16 pool and with quant_resident: equal completions (order, tokens,
    preemptions, bit plans, quant flags), evictions and router counts;
    the trace really batched, evicted, compressed and predicted."""
    (log_j, st_j, sz_j), (log_t, st_t, sz_t) = _run_both(quant=quant)
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j)
    assert sz_t == sz_j
    done = [e for e in log_t if e[0] == "done"]
    assert len(done) == 16 and st_t["failed_calls"] == 0
    assert max(sz_t) >= 2                         # batched rounds
    assert any(e[0] == "evict" for e in log_t)
    assert any(b < 16 for e in done for b in e[5])
    assert st_t["router"]["pred_total"] > 0
    assert st_t["router"]["prefetch_hints"] > 0
    if quant:
        assert any(any(q) for e in done for q in e[6:7])


def test_router_aot_hint_matches_reference():
    """With the service's own AoT swap-out off (``llms_nolife``), the
    §3.4 hint is what writes the other contexts' dirty chunks: both
    packages flush the same number (> 0) and give the same log.  (Under
    ``llms`` every switch-out already flushes, so the hint finds nothing
    dirty: 0 in both packages.)"""
    (log_j, st_j, _), (log_t, st_t, _) = _run_both(policy="llms_nolife")
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j)
    assert st_t["router"]["aot_flushes"] > 0


def test_threaded_router_matches_inline_tokens():
    """The threaded router (``start=True``, 2 apps submitting from their
    own threads) finishes with 0 failed calls, and each context's calls
    give the tokens of the inline run (a context's calls keep their
    trace order within its app; bit plans come from the context's own
    density)."""
    _, ts, tcfg = services(decode_batch=4, budget=3 * RAW_CHUNK,
                           port_only=True)
    _, ts2, _ = services(decode_batch=4, budget=3 * RAW_CHUNK,
                         port_only=True)
    events = tsynthesize(6, 16, tcfg.vocab, pattern="markov", scale=SCALE,
                         seed=2)
    with ts, ts2:
        log_i, st_i, _ = _replay(ts, TRouter, tserve.run_trace, events)
        log_th, st_th, _ = _replay(ts2, TRouter, tserve.run_trace, events,
                                   start=True)
    assert st_th["failed_calls"] == st_i["failed_calls"] == 0

    def by_ctx(log):
        out = {}
        for e in log:
            if e[0] == "done":
                out.setdefault(e[1], []).append(e[2])
        return out

    assert by_ctx(log_th) == by_ctx(log_i)
    assert sum(len(v) for v in by_ctx(log_th).values()) == 16


def test_paged_decode_matches_serial_decode():
    """The executor's paged [B, 1] entry over three contexts (one
    batched round) gives the argmax and mass of stepping each context
    alone through the same entry (B = 1), and of the reference's paged
    [B, 1] entry on the same pages.  Masses within 1e-4 (fp32 sums of
    bf16-derived probabilities)."""
    js, ts, tcfg = services(decode_batch=4)
    with js, ts:
        rng = np.random.RandomState(43)
        prompts = [rng.randint(1, tcfg.vocab, 6 + i).astype(np.int32)
                   for i in range(3)]
        rows = {}
        for name, svc in (("jax", js), ("torch", ts)):
            exe, pool = svc.exe, svc.res.pool
            ctxs, toks, pos = [], [], []
            for p in prompts:                      # a non-bucket n each
                ctx = svc.ctxs.create()
                svc.res.ensure_extend_range(ctx, 0, (len(p) - 1) // exe.cs)
                pt16, pt8, qmask = pool.rows([ctx.cid])
                pool.arenas, logits, _ = exe.paged_extend(
                    pool.arenas, p, 0, pt16, pt8, qmask)
                ctxs.append(ctx)
                toks.append(int(np.argmax(np.asarray(logits, np.float32))))
                pos.append(len(p))
            pt16, pt8, qmask = pool.rows([c.cid for c in ctxs])
            arenas = pool.arenas
            _, blogits, bmass = exe.paged_decode(arenas, toks, pos, pt16,
                                                 pt8, qmask)
            serial = []
            for i, c in enumerate(ctxs):
                r16, r8, rq = pool.rows([c.cid])
                _, sl, sm = exe.paged_decode(arenas, toks[i:i + 1],
                                             pos[i:i + 1], r16, r8, rq)
                serial.append((np.asarray(sl, np.float32)[0],
                               np.asarray(sm, np.float32)[0]))
            rows[name] = (toks, np.asarray(blogits, np.float32),
                          np.asarray(bmass, np.float32), serial)
    for name, (toks, bl, bm, serial) in rows.items():
        for i, (sl, sm) in enumerate(serial):
            assert int(np.argmax(sl)) == int(np.argmax(bl[i])), name
            np.testing.assert_allclose(bm[i], sm, atol=1e-4)
    assert rows["torch"][0] == rows["jax"][0]
    for i in range(3):
        assert int(np.argmax(rows["torch"][1][i])) == \
            int(np.argmax(rows["jax"][1][i]))
        np.testing.assert_allclose(rows["torch"][2][i], rows["jax"][2][i],
                                   atol=1e-4)


# --------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------- #
def test_serve_main_on_the_cpu(capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu``
    replays its trace through the router and prints the JSON stats,
    with no dropped call at a window that holds every event."""
    import json
    tserve.main(["--reduced", "--device", "cpu", "--calls", "8",
                 "--contexts", "3", "--max-ctx", "512", "--concurrency", "2",
                 "--decode-batch", "4", "--slice-steps", "4",
                 "--quant-resident"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == 0
    assert printed["router"]["foreground"]["calls"] \
        + printed["router"]["background"]["calls"] == 8
    assert printed["device"] == "cpu" and printed["paged_pool"]


def test_serve_step_runs_its_hooks_and_reruns_identically(tmp_path):
    """``launch.serve.serve``, the serving step of ``main``: under
    ``llms`` it profiles the restore pipeline before the replay, runs
    ``on_start`` just before the replay and ``on_end`` just after it on
    the same router with the trace's events, and replays inline with
    ``threaded=False`` although two apps submit.  Two runs from one seed
    complete the same calls in the same order with the same tokens (the
    profile's timings steer no paged switch-in)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    model = build_model(reduced(get_config("smollm-360m")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    runs = []
    for i in range(2):
        args = tserve.parse_args([
            "--device", "cpu", "--contexts", "4", "--calls", "10",
            "--max-ctx", "512", "--budget-mib", repr(3 * RAW_CHUNK / 2**20),
            "--concurrency", "2", "--decode-batch", "4",
            "--slice-steps", "4", "--swap-dir", str(tmp_path / str(i))])
        seen, log = [], []

        def on_start(svc, router):
            seen.append(("start", svc.res.profiled, router.started,
                         len(router.call_records)))
            seen.append(router)
            router.on_complete = lambda job, cancelled: log.append(
                (job["stub"].ctx_id, tuple(job["stream"].tokens)))

        def on_end(svc, router, events):
            assert router is seen.pop()
            seen.append(("end", len(router.call_records), len(events)))

        stats = tserve.serve(model, params, args, threaded=False,
                             on_start=on_start, on_end=on_end,
                             verbose=False)
        assert seen == [("start", True, False, 0), ("end", 10, 10)]
        assert stats["failed_calls"] == 0 and stats["wall_s"] > 0
        runs.append(log)
    assert len(runs[0]) == 10 and runs[1] == runs[0]


def test_serve_main_refuses_without_a_card(monkeypatch):
    """Without ``--device cpu`` the entry point runs on the card, and
    raises on a machine without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--reduced", "--calls", "2"])


@pytest.mark.parametrize("argv,what", [
    (["--no-paged-pool"], "slot engine"), (["--policy", "swap"], "whole"),
    (["--arch", "llama2-7b", "--policy", "lmk"], "whole")])
def test_serve_main_serves_slot_and_whole_state(argv, what, capsys):
    """``launch.serve.main`` serves the configurations it once refused
    (the slot engine, ``swap``, ``lmk``) on the CPU with no failed call
    and no paged pool; and the same policy and engine through both
    packages' routers on one trace give the same completions, evictions
    and counts (``_run_both``, decode_batch 4)."""
    import json
    tserve.main(["--reduced", "--device", "cpu", "--calls", "6",
                 "--contexts", "3", "--max-ctx", "512"] + argv)
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == 0 and not printed["paged_pool"], what
    policy = argv[argv.index("--policy") + 1] if "--policy" in argv \
        else "llms"
    (log_j, st_j, _), (log_t, st_t, _) = _run_both(
        policy=policy, paged_pool=False, n_calls=10)
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j)
    assert len([e for e in log_t if e[0] == "done"]) == 10


def test_parse_priority_mix_matches_reference():
    for mix, n in (("1:1", 4), ("2:1", 5), ("0:3", 2)):
        assert tserve.parse_priority_mix(mix, n) == \
            jserve.parse_priority_mix(mix, n)
    with pytest.raises(SystemExit):
        tserve.parse_priority_mix("0:0", 2)
