"""The port's ServiceRouter over its paged engine: the paged cases of the
JAX package's tests/test_scheduler.py, tests/test_streaming.py and
tests/test_batch_decode.py, carried over with the same assertions.

Admission and priority ordering, next-context prediction driving the
§3.4 AoT swap-out, decode-slice preemption, cancellation, exclusive
requests, continuous batching on the paged pool and the router's
stop check.  Each runs on the reduced smollm-360m (the model of the
reference's router tests) with the reference's weights, head scaled as
in tests/test_torch_service.py, on the CPU.  Where a case compares
tokens it also holds them against the JAX package's service on the
same weights (``_reference_tokens``).  Two service-level details differ
from the reference and are checked in the port's terms: an over-long
request raises ``ValueError`` (the reference asserts), and the parked
contexts are ``LLMService._reuse`` (the reference's ``_active`` is a
compat view of its last entry).
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, services  # noqa: F401
from repro_torch.core.requests import (BACKGROUND, FOREGROUND,
                                       GenerationRequest, SamplingParams)
from repro_torch.core.scheduler import (NextContextPredictor, ServiceRouter,
                                        parse_priority)
from repro_torch.trace.synth import synthesize


def make_svc(policy="llms", budget=10_000_000, max_ctx=128, decode_batch=1):
    _, svc, cfg = services(policy=policy, budget=budget, max_ctx=max_ctx,
                           decode_batch=decode_batch, port_only=True)
    return svc, cfg


def prompts_for(cfg, n, length=10, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, length).tolist() for _ in range(n)]


def _reference_tokens(prompts, max_new, policy="llms"):
    """The JAX package's direct callLLM tokens, one fresh context per
    prompt, on the same weights."""
    js, ts, _ = services(policy=policy)
    ts.close()
    with js:
        return [js.callLLM(js.newLLMCtx(), p, max_new_tokens=max_new)[1]
                for p in prompts]


def _last_parked(svc):
    return next(reversed(svc._reuse)) if svc._reuse else None


# --------------------------------------------------------------------- #
# admission / priority ordering (tests/test_scheduler.py)
# --------------------------------------------------------------------- #
def test_foreground_admitted_before_queued_background():
    svc, cfg = make_svc()
    router = ServiceRouter(svc, predict=False, start=False)
    fg = router.register_app("chat", "foreground")
    bg = router.register_app("indexer", "background")
    rng = np.random.RandomState(0)
    stubs = {s: sess.new_ctx() for s, sess in
             [("b0", bg), ("b1", bg), ("f0", fg), ("f1", fg)]}
    for name, sess in [("b0", bg), ("f0", fg), ("b1", bg), ("f1", fg)]:
        sess.submit(stubs[name], rng.randint(1, cfg.vocab, 8).tolist(),
                    max_new_tokens=2)
    router.drain()
    assert [r["app"] for r in router.call_records] == \
        ["chat", "chat", "indexer", "indexer"]
    assert [r["ctx"] for r in router.call_records[:2]] == \
        [stubs["f0"].ctx_id, stubs["f1"].ctx_id]
    router.shutdown()
    svc.close()


def test_per_priority_latency_stats():
    svc, cfg = make_svc()
    router = ServiceRouter(svc, predict=False, start=False)
    fg = router.register_app("a", "fg")
    bg = router.register_app("b", "bg")
    rng = np.random.RandomState(1)
    for sess in (fg, bg):
        stub = sess.new_ctx()
        for _ in range(2):
            sess.call(stub, rng.randint(1, cfg.vocab, 8).tolist(),
                      max_new_tokens=2)
    st = router.stats()
    for prio in ("foreground", "background"):
        assert st[prio]["calls"] == 2
        assert st[prio]["latency_mean_s"] >= st[prio]["service_mean_s"] >= 0
        assert st[prio]["wait_mean_s"] >= 0
    router.shutdown()
    svc.close()


def test_threaded_router_serializes_service_access():
    svc, cfg = make_svc()
    router = ServiceRouter(svc, predict=True, start=True)
    fg = router.register_app("app", "foreground")
    rng = np.random.RandomState(2)
    stubs = [fg.new_ctx() for _ in range(3)]
    futs = [fg.submit(stubs[i % 3], rng.randint(1, cfg.vocab, 8).tolist(),
                      max_new_tokens=2) for i in range(9)]
    router.drain()
    outs = [f.result(30.0) for f in futs]
    assert all(len(gen) == 2 for _, gen in outs)
    assert len(router.call_records) == 9
    assert svc.stats()["calls"] == 9
    router.shutdown()
    svc.close()


def test_exception_reported_to_submitter():
    svc, cfg = make_svc()
    router = ServiceRouter(svc, predict=False, start=False)
    fg = router.register_app("a", "fg")
    stub = fg.new_ctx()
    fut = fg.submit(stub, [1] * (svc.n_slots * 2), max_new_tokens=0)
    router.drain()
    with pytest.raises(ValueError, match="half the window"):
        fut.result(10.0)
    router.shutdown()
    svc.close()


def test_parse_priority():
    assert parse_priority("fg") == parse_priority("foreground") == 0
    assert parse_priority("bg") == parse_priority("background") == 1
    assert parse_priority(1) == 1
    assert (FOREGROUND, BACKGROUND) == (0, 1)


def test_predictor_learns_first_order_pattern():
    p = NextContextPredictor()
    for cid in [0, 1, 0, 1, 0, 1, 0]:
        p.observe(cid)
    assert p.predict(0) == 1
    assert p.predict(1) == 0
    assert p.predict() == 1
    assert p.predict(99) is None


def test_prediction_drives_aot_swap_out():
    """llms_nolife disables the service's own AoT swap-out; the router's
    prediction hook flushes the outgoing context's chunks to disk."""
    svc, cfg = make_svc(policy="llms_nolife")
    assert not svc.cfg.use_aot
    router = ServiceRouter(svc, predict=True, start=False)
    app = router.register_app("a", "fg")
    rng = np.random.RandomState(3)
    sa, sb = app.new_ctx(), app.new_ctx()
    for stub in (sa, sb, sa, sb, sa):
        app.call(stub, rng.randint(1, cfg.vocab, 12).tolist(),
                 max_new_tokens=2)
    assert router.prefetch_hints > 0
    assert router.aot_flushes > 0
    svc.swapper.flush()
    ctx_a = svc.contexts[sa.ctx_id]
    assert ctx_a.chunks
    assert all(not m.dirty and m.on_disk for m in ctx_a.chunks.values())
    assert all(svc.store.nbytes((ctx_a.cid, i)) for i in ctx_a.chunks)
    router.shutdown()
    svc.close()


@pytest.mark.parametrize("policy", ["vllm_sq", "llms_nolife"])
def test_prediction_flush_keeps_grown_chunks_fresh(policy):
    """A partial chunk flushed by the hint that then GROWS is re-encoded:
    payloads equal a prediction-off run byte for byte."""
    def payloads(predict):
        svc, cfg = make_svc(policy=policy)
        router = ServiceRouter(svc, predict=predict, start=False)
        app = router.register_app("a", "fg")
        rng = np.random.RandomState(5)
        sa, sb = app.new_ctx(), app.new_ctx()
        prompts = [rng.randint(1, cfg.vocab, 11).tolist() for _ in range(8)]
        for i, stub in enumerate([sa, sb] * 4):
            app.call(stub, prompts[i], max_new_tokens=3)
        snap = {(c.cid, i): {n: (np.asarray(p).copy(), np.asarray(s).copy())
                             for n, (p, s) in cc.data.items()}
                for c in svc.contexts.values()
                for i, cc in c.payload.items()}
        router.shutdown()
        svc.close()
        return snap

    with_pred, no_pred = payloads(True), payloads(False)
    assert set(with_pred) == set(no_pred) and with_pred
    for k in with_pred:
        for n in with_pred[k]:
            np.testing.assert_array_equal(with_pred[k][n][0],
                                          no_pred[k][n][0])


def test_prediction_accuracy_tracked():
    svc, cfg = make_svc()
    router = ServiceRouter(svc, predict=True, start=False)
    app = router.register_app("a", "fg")
    rng = np.random.RandomState(4)
    sa, sb = app.new_ctx(), app.new_ctx()
    for stub in (sa, sb) * 4:
        app.call(stub, rng.randint(1, cfg.vocab, 8).tolist(),
                 max_new_tokens=2)
    st = router.stats()
    assert st["pred_total"] > 0
    assert st["pred_hits"] >= st["pred_total"] // 2
    router.shutdown()
    svc.close()


# --------------------------------------------------------------------- #
# streaming and decode-slice preemption (tests/test_streaming.py)
# --------------------------------------------------------------------- #
def test_begin_decode_finish_matches_callLLM():
    svc_a, cfg = make_svc()
    svc_b, _ = make_svc()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, cfg.vocab, 10).tolist() for _ in range(4)]
    with svc_a, svc_b:
        sa, sb = svc_a.newLLMCtx(), svc_b.newLLMCtx()
        for p in prompts:
            _, gen_a = svc_a.callLLM(sa, p, max_new_tokens=3)
            st = svc_b.begin_call(sb, GenerationRequest(prompt=p,
                                                        max_new_tokens=3))
            gen_b = []
            while (tok := svc_b.decode_step(st)) is not None:
                gen_b.append(tok)
            svc_b.finish_call(st)
            assert gen_a == gen_b == st.generated
        ca, cb = svc_a.contexts[sa.ctx_id], svc_b.contexts[sb.ctx_id]
        assert ca.n_tokens == cb.n_tokens
        np.testing.assert_array_equal(ca.tokens[:ca.n_tokens],
                                      cb.tokens[:cb.n_tokens])


def test_routed_stream_matches_direct_callLLM():
    """The router's sliced stream path (no preemption) gives the direct
    greedy path's tokens, in the port and in the reference."""
    js, svc_a, cfg = services()
    svc_b, _ = make_svc()
    events = synthesize(3, 8, cfg.vocab, pattern="markov", scale=0.03,
                        seed=5)
    with js, svc_a, svc_b:
        direct, ref = [], []
        stubs_a, stubs_j = {}, {}
        for ev in events:
            if ev.ctx_id not in stubs_a:
                stubs_a[ev.ctx_id] = svc_a.newLLMCtx()
                stubs_j[ev.ctx_id] = js.newLLMCtx()
            direct.append(svc_a.callLLM(stubs_a[ev.ctx_id],
                                        ev.prompt.tolist(), 4)[1])
            ref.append(js.callLLM(stubs_j[ev.ctx_id], ev.prompt.tolist(),
                                  4)[1])
        with ServiceRouter(svc_b, predict=True, slice_steps=2) as router:
            app = router.register_app("a", "fg")
            stubs_b, streams = {}, []
            for ev in events:
                if ev.ctx_id not in stubs_b:
                    stubs_b[ev.ctx_id] = app.new_ctx()
                streams.append(app.stream(stubs_b[ev.ctx_id],
                                          ev.prompt.tolist(),
                                          max_new_tokens=4))
            router.drain()
            routed = [s.result() for s in streams]
    assert direct == routed == ref


def test_sampled_generation_reproducible():
    sp = SamplingParams(temperature=0.8, top_k=8, seed=42)
    outs = []
    for _ in range(2):
        svc, cfg = make_svc()
        with svc:
            prompt = np.random.RandomState(3).randint(
                1, cfg.vocab, 10).tolist()
            outs.append(svc.callLLM(svc.newLLMCtx(), prompt, 6,
                                    sampling=sp)[1])
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_slice_preemption_interleaves_inline():
    """A paused background stream resumes AFTER a later-admitted
    foreground request, whose first token lands before the background's
    tail tokens."""
    svc, cfg = make_svc()
    rng = np.random.RandomState(7)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        fg = router.register_app("chat", "foreground")
        bg = router.register_app("agent", "background")
        bg_stub, fg_stub = bg.new_ctx(), fg.new_ctx()
        bg_s = bg.stream(bg_stub, rng.randint(1, cfg.vocab, 8).tolist(),
                         max_new_tokens=12)
        router.pump()
        assert len(bg_s.tokens) == 2 and not bg_s.done
        fg_s = fg.stream(fg_stub, rng.randint(1, cfg.vocab, 8).tolist(),
                         max_new_tokens=3)
        router.drain()
        assert fg_s.result() and bg_s.result() is not None
        assert len(bg_s.tokens) == 12 and len(fg_s.tokens) == 3
        assert fg_s.t_done < bg_s.token_times[2]
        bg_rec = [r for r in svc.records if r["ctx"] == bg_stub.ctx_id][-1]
        assert bg_rec["n_preempts"] >= 1
        assert bg_rec["new_tokens"] == 8 + 12


def test_foreground_ttft_lower_under_slicing():
    def fg_ttft(slice_steps):
        svc, cfg = make_svc()
        rng = np.random.RandomState(11)
        with svc, ServiceRouter(svc, predict=False, start=True,
                                slice_steps=slice_steps) as router:
            fg = router.register_app("chat", "foreground")
            bg = router.register_app("agent", "background")
            fg_stub, bg_stub = fg.new_ctx(), bg.new_ctx()
            bg_s = bg.stream(bg_stub, rng.randint(1, cfg.vocab, 8).tolist(),
                             max_new_tokens=48)
            deadline = time.time() + 120
            while bg_s.t_first_token is None:
                assert time.time() < deadline, "bg stream never started"
                time.sleep(0.001)
            fg_s = fg.stream(fg_stub, rng.randint(1, cfg.vocab, 8).tolist(),
                             max_new_tokens=4)
            fg_s.result(timeout=120)
            bg_s.result(timeout=120)
            router.drain()
            return fg_s, bg_s, router.preemptions

    fg_whole, bg_whole, pre_whole = fg_ttft(0)
    fg_slice, bg_slice, pre_slice = fg_ttft(2)
    assert pre_whole == 0
    assert pre_slice >= 1 and bg_slice.n_preempts >= 1
    assert fg_slice.t_done < bg_slice.t_done
    assert fg_whole.t_first_token >= bg_whole.t_done
    assert fg_slice.ttft() < fg_whole.ttft()
    assert len(bg_slice.tokens) == 48


def test_future_cancel_queued_inline():
    svc, cfg = make_svc()
    rng = np.random.RandomState(1)
    with svc, ServiceRouter(svc, predict=False) as router:
        app = router.register_app("a", "fg")
        s1, s2 = app.new_ctx(), app.new_ctx()
        f1 = app.submit(s1, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        f2 = app.submit(s2, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        assert f2.cancel()
        router.drain()
        assert len(f1.result()[1]) == 2
        assert f2.cancelled()
        assert svc.contexts[s2.ctx_id].n_tokens == 0
        assert len(router.call_records) == 1


def test_future_cancel_queued_threaded():
    svc, cfg = make_svc()
    rng = np.random.RandomState(2)
    with svc, ServiceRouter(svc, predict=False, start=True) as router:
        app = router.register_app("a", "fg")
        s1, s2 = app.new_ctx(), app.new_ctx()
        f1 = app.submit(s1, rng.randint(1, cfg.vocab, 8).tolist(), 48)
        f2 = app.submit(s2, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        won = f2.cancel()
        router.drain()
        assert len(f1.result(120)[1]) == 48
        if won:
            assert f2.cancelled()
            assert svc.contexts[s2.ctx_id].n_tokens == 0
        else:
            assert len(f2.result(120)[1]) == 2


def test_stream_cancel_mid_generation_consistent():
    svc, cfg = make_svc()
    rng = np.random.RandomState(3)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        app = router.register_app("a", "fg")
        stub = app.new_ctx()
        prompt = rng.randint(1, cfg.vocab, 12).tolist()
        s = app.stream(stub, prompt, max_new_tokens=10)
        router.pump()
        assert s.cancel()
        router.drain()
        assert s.done and s.cancelled
        toks = s.result()
        assert len(toks) == 2
        ctx = svc.contexts[stub.ctx_id]
        assert ctx.busy == 0
        assert ctx.n_tokens == len(prompt) + len(toks)
        np.testing.assert_array_equal(ctx.tokens[:ctx.n_tokens],
                                      np.asarray(prompt + toks, np.int32))
        assert sum(m.n_covered for m in ctx.chunks.values()) == ctx.n_tokens
        assert svc.records[-1]["new_tokens"] == len(prompt) + len(toks)
        _, gen = app.call(stub, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        assert len(gen) == 2
        app.del_ctx(stub)


def test_delete_busy_context_refused():
    svc, cfg = make_svc()
    rng = np.random.RandomState(4)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        app = router.register_app("a", "fg")
        stub = app.new_ctx()
        s = app.stream(stub, rng.randint(1, cfg.vocab, 8).tolist(), 8)
        router.pump()
        with pytest.raises(RuntimeError):
            app.del_ctx(stub)
        # a failed delete has no side effects: the context stays parked
        assert _last_parked(svc) == stub.ctx_id
        s.cancel()
        router.drain()
        app.del_ctx(stub)
        assert stub.ctx_id not in svc.contexts


def test_same_context_calls_serialize_across_preemption():
    svc, cfg = make_svc()
    rng = np.random.RandomState(9)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        bg = router.register_app("agent", "background")
        stub = bg.new_ctx()
        s1 = bg.stream(stub, rng.randint(1, cfg.vocab, 8).tolist(), 8)
        router.pump()
        s2 = bg.stream(stub, rng.randint(1, cfg.vocab, 8).tolist(), 2,
                       priority="foreground")
        router.drain()
        assert s2.error is None
        assert len(s1.result()) == 8
        assert len(s2.result()) == 2
        ctx = svc.contexts[stub.ctx_id]
        assert ctx.busy == 0
        assert ctx.n_tokens == (8 + 8) + (8 + 2)


def test_begin_call_refuses_overlap_at_service_layer():
    svc, cfg = make_svc()
    rng = np.random.RandomState(11)
    with svc:
        stub = svc.newLLMCtx()
        st = svc.begin_call(stub, GenerationRequest(
            prompt=rng.randint(1, cfg.vocab, 6).tolist(), max_new_tokens=4))
        svc.decode_step_batch([st])
        svc.suspend_call(st)
        with pytest.raises(RuntimeError):
            svc.begin_call(stub, GenerationRequest(
                prompt=rng.randint(1, cfg.vocab, 4).tolist(),
                max_new_tokens=2))
        svc.resume_call(st)
        while not st.exhausted:
            svc.decode_step_batch([st])
        svc.finish_call(st)


def test_same_context_job_does_not_trigger_preemption():
    svc, cfg = make_svc()
    rng = np.random.RandomState(10)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        fg = router.register_app("chat", "foreground")
        bg = router.register_app("agent", "background")
        stub, other = bg.new_ctx(), fg.new_ctx()
        fg.stream(stub, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        assert not router._higher_priority_waiting(1, stub.ctx_id)
        assert router._higher_priority_waiting(1, other.ctx_id)
        router.drain()


def test_router_exit_aborts_on_exception():
    svc, cfg = make_svc()
    with svc:
        with pytest.raises(ValueError):
            with ServiceRouter(svc, predict=False) as router:
                app = router.register_app("a", "fg")
                stub = app.new_ctx()
                fut = app.submit(stub, [1, 2, 3], max_new_tokens=2)
                raise ValueError("boom")
        assert fut.cancelled()
        assert svc.contexts[stub.ctx_id].n_tokens == 0


def test_stream_tokens_arrive_incrementally():
    svc, cfg = make_svc()
    rng = np.random.RandomState(5)
    with svc, ServiceRouter(svc, predict=False, start=True) as router:
        app = router.register_app("a", "fg")
        s = app.stream(app.new_ctx(), rng.randint(1, cfg.vocab, 8).tolist(),
                       max_new_tokens=6)
        seen = list(s)
        assert seen == s.result() and len(seen) == 6
        assert s.ttft() is not None and s.ttft() >= 0
        assert len(s.tbt()) == 5
        st = router.stats()["foreground"]
        assert st["ttft_p99_s"] >= st["ttft_p50_s"] >= 0


def test_deadline_orders_same_priority():
    svc, cfg = make_svc()
    rng = np.random.RandomState(6)
    with svc, ServiceRouter(svc, predict=False) as router:
        app = router.register_app("a", "fg")
        c1, c2 = app.new_ctx(), app.new_ctx()
        app.stream(c1, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        app.stream(c2, rng.randint(1, cfg.vocab, 6).tolist(), 2,
                   deadline=time.perf_counter() + 0.5)
        router.drain()
        assert [r["ctx"] for r in router.call_records] == \
            [c2.ctx_id, c1.ctx_id]


def test_request_priority_overrides_session():
    svc, cfg = make_svc()
    rng = np.random.RandomState(7)
    with svc, ServiceRouter(svc, predict=False) as router:
        bg = router.register_app("agent", "background")
        c1, c2 = bg.new_ctx(), bg.new_ctx()
        bg.stream(c1, rng.randint(1, cfg.vocab, 6).tolist(), 2)
        bg.stream(c2, rng.randint(1, cfg.vocab, 6).tolist(), 2,
                  priority="foreground")
        router.drain()
        assert [r["ctx"] for r in router.call_records] == \
            [c2.ctx_id, c1.ctx_id]
        assert router.call_records[0]["priority"] == 0


def test_del_ctx_drops_the_parked_entry():
    """delLLMCtx forgets the deleted context's parked pages (the
    reference's ``_active`` regression, in the port's ``_reuse`` terms);
    deleting another context leaves the last parked one alone."""
    svc, cfg = make_svc()
    rng = np.random.RandomState(8)
    with svc:
        stub = svc.newLLMCtx()
        svc.callLLM(stub, rng.randint(1, cfg.vocab, 8).tolist(), 2)
        assert _last_parked(svc) == stub.ctx_id
        svc.delLLMCtx(stub)
        assert stub.ctx_id not in svc._reuse
        a, b = svc.newLLMCtx(), svc.newLLMCtx()
        svc.callLLM(a, rng.randint(1, cfg.vocab, 8).tolist(), 2)
        svc.callLLM(b, rng.randint(1, cfg.vocab, 8).tolist(), 2)
        svc.delLLMCtx(a)
        assert _last_parked(svc) == b.ctx_id


def test_system_prompt_routed_through_router():
    svc, cfg = make_svc()
    with svc, ServiceRouter(svc, predict=True) as router:
        app = router.register_app("a", "fg")
        stub = app.new_ctx(system_prompt=[1, 2, 3, 4])
        assert svc.contexts[stub.ctx_id].n_tokens == 4
        assert len(router.call_records) == 1
        assert router.call_records[0]["ctx"] == stub.ctx_id
        assert router.predictor.last == stub.ctx_id


def test_close_idempotent_and_context_managers():
    svc, cfg = make_svc()
    with svc:
        with ServiceRouter(svc, predict=False) as router:
            app = router.register_app("a", "fg")
            stub = app.new_ctx()
            app.call(stub, [1, 2, 3], max_new_tokens=2)
        with pytest.raises(RuntimeError):
            app.submit(stub, [4], max_new_tokens=1)
    svc.close()
    svc.close()


# --------------------------------------------------------------------- #
# batched decode on the paged pool (tests/test_batch_decode.py)
# --------------------------------------------------------------------- #
def test_batch1_token_identical_to_serial_path():
    svc_a, cfg = make_svc(decode_batch=1)
    svc_b, _ = make_svc(decode_batch=1)
    ps = prompts_for(cfg, 4, seed=3)
    with svc_a, svc_b:
        stubs_a = [svc_a.newLLMCtx() for _ in ps]
        direct = [svc_a.callLLM(s, p, 5)[1] for s, p in zip(stubs_a, ps)]
        with ServiceRouter(svc_b, predict=False, slice_steps=2) as router:
            app = router.register_app("a", "fg")
            stubs_b = [app.new_ctx() for _ in ps]
            streams = [app.stream(s, p, max_new_tokens=5)
                       for s, p in zip(stubs_b, ps)]
            router.drain()
            routed = [s.result() for s in streams]
    assert routed == direct
    assert router.stats()["tokens_per_round"] == 1.0


def test_batched_output_matches_serial_reference():
    """Greedy decode at decode_batch=4 gives the tokens of four
    independent serial generations, in the port and in the reference."""
    svc_a, cfg = make_svc(decode_batch=1)
    svc_b, _ = make_svc(decode_batch=4)
    ps = prompts_for(cfg, 4, seed=7)
    with svc_a, svc_b:
        ref = [svc_a.callLLM(svc_a.newLLMCtx(), p, 6)[1] for p in ps]
        with ServiceRouter(svc_b, predict=False, slice_steps=2) as router:
            app = router.register_app("a", "fg")
            streams = [app.stream(app.new_ctx(), p, max_new_tokens=6)
                       for p in ps]
            router.drain()
            out = [s.result() for s in streams]
    assert out == ref == _reference_tokens(ps, 6)
    st = router.stats()
    assert st["decode_batch"] == 4
    assert st["tokens_per_round"] > 1.0


def test_pump_interleaves_batch_deterministically():
    svc, cfg = make_svc(decode_batch=3)
    ps = prompts_for(cfg, 3, seed=11)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        app = router.register_app("a", "fg")
        streams = [app.stream(app.new_ctx(), p, max_new_tokens=6)
                   for p in ps]
        for expect in (2, 4, 6):
            assert router.pump()
            assert [len(s.tokens) for s in streams] == [expect] * 3
        assert not router.pump()
        for s in streams:
            assert s.done and len(s.result()) == 6
        assert len(svc.res.slots.held) == 0
        assert len(router.call_records) == 3


def test_partial_batch_refills_between_slices():
    svc, cfg = make_svc(decode_batch=2)
    ps = prompts_for(cfg, 3, seed=13)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        app = router.register_app("a", "fg")
        s1 = app.stream(app.new_ctx(), ps[0], max_new_tokens=2)
        s2 = app.stream(app.new_ctx(), ps[1], max_new_tokens=8)
        s3 = app.stream(app.new_ctx(), ps[2], max_new_tokens=4)
        router.drain()
        for s, n in ((s1, 2), (s2, 8), (s3, 4)):
            assert len(s.result()) == n
        assert s3.t_first_token < s2.token_times[-1]


def test_slot_eviction_under_memory_pressure():
    svc_ref, cfg = make_svc(decode_batch=1)
    svc, _ = make_svc(decode_batch=2, budget=40_000)
    ps = prompts_for(cfg, 4, seed=17)
    order = [0, 1, 2, 3, 0, 2, 1, 3]
    with svc_ref, svc:
        stubs_ref = [svc_ref.newLLMCtx() for _ in ps]
        ref = [svc_ref.callLLM(stubs_ref[i], ps[i], 3)[1] for i in order]
        stubs = [svc.newLLMCtx() for _ in ps]
        out = []
        for i in order:
            out.append(svc.callLLM(stubs[i], ps[i], 3)[1])
            assert len(svc._reuse) <= 2
            assert set(svc._reuse) == set(svc.res.slots.idle)
        assert out == ref
        assert set(svc.res.slots.idle) < {s.ctx_id for s in stubs}
        assert svc.stats()["decode_slots"] == 2


def test_slot_allocator_refuses_oversubscription():
    svc, cfg = make_svc(decode_batch=2)
    ps = prompts_for(cfg, 3, seed=19)
    with svc:
        sts = [svc.begin_call(svc.newLLMCtx(),
                              GenerationRequest(prompt=p, max_new_tokens=4))
               for p in ps[:2]]
        stub3 = svc.newLLMCtx()
        with pytest.raises(RuntimeError):
            svc.begin_call(stub3,
                           GenerationRequest(prompt=ps[2], max_new_tokens=4))
        for st in sts:
            while svc.decode_step(st) is not None:
                pass
            svc.finish_call(st)
        assert len(svc.callLLM(stub3, ps[2], max_new_tokens=2)[1]) == 2


def test_preemption_evicts_single_slot():
    svc, cfg = make_svc(decode_batch=2)
    ps = prompts_for(cfg, 3, seed=23)
    with svc, ServiceRouter(svc, predict=False, start=True,
                            slice_steps=2) as router:
        bg = router.register_app("agent", "background")
        fg = router.register_app("chat", "foreground")
        fg_stub = fg.new_ctx()
        bg_stubs = [bg.new_ctx(), bg.new_ctx()]
        bgs = [bg.stream(stub, p, max_new_tokens=48)
               for stub, p in zip(bg_stubs, ps[:2])]
        deadline = time.time() + 120
        while any(s.t_first_token is None for s in bgs):
            assert time.time() < deadline, "bg batch never started"
            time.sleep(0.001)
        fg_s = fg.stream(fg_stub, ps[2], max_new_tokens=4)
        fg_s.result(timeout=120)
        router.drain()
        assert router.preemptions >= 1
        preempted = [s for s in bgs if s.n_preempts > 0]
        assert len(preempted) == 1
        survivor = next(s for s in bgs if s.n_preempts == 0)
        assert any(t > fg_s.t_first_token for t in survivor.token_times)
        for s in bgs:
            assert len(s.result(timeout=120)) == 48


def test_exclusive_head_drains_batch_without_thrash():
    svc, cfg = make_svc(decode_batch=2)
    ps = prompts_for(cfg, 4, seed=37)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        bg = router.register_app("agent", "background")
        fg = router.register_app("chat", "foreground")
        bgs = [bg.stream(bg.new_ctx(), p, max_new_tokens=6)
               for p in ps[:2]]
        router.pump()
        solo = fg.submit_request(
            fg.new_ctx(), GenerationRequest(prompt=ps[2], max_new_tokens=4,
                                            exclusive=True))
        late_bg = bg.stream(bg.new_ctx(), ps[3], max_new_tokens=2)
        router.drain()
        assert router.preemptions == 0
        assert len(solo.result()) == 4
        for s in bgs:
            assert len(s.result()) == 6
        assert len(late_bg.result()) == 2
        assert late_bg.t_first_token > solo.t_done


def test_running_exclusive_preempted_by_foreground():
    svc, cfg = make_svc(decode_batch=2)
    ps = prompts_for(cfg, 2, seed=41)
    with svc, ServiceRouter(svc, predict=False, start=True,
                            slice_steps=2) as router:
        bg = router.register_app("agent", "background")
        fg = router.register_app("chat", "foreground")
        fg_stub, bg_stub = fg.new_ctx(), bg.new_ctx()
        solo = bg.submit_request(
            bg_stub, GenerationRequest(prompt=ps[0], max_new_tokens=48,
                                       exclusive=True))
        deadline = time.time() + 120
        while solo.t_first_token is None:
            assert time.time() < deadline, "exclusive stream never started"
            time.sleep(0.001)
        fg_s = fg.stream(fg_stub, ps[1], max_new_tokens=4)
        fg_s.result(timeout=120)
        router.drain()
        assert router.preemptions >= 1 and solo.n_preempts >= 1
        assert fg_s.t_done < solo.t_done
        assert len(solo.result(timeout=120)) == 48


def test_exclusive_request_runs_alone():
    svc, cfg = make_svc(decode_batch=4)
    ps = prompts_for(cfg, 3, seed=29)
    with svc, ServiceRouter(svc, predict=False, slice_steps=2) as router:
        app = router.register_app("a", "fg")
        solo = app.submit_request(
            app.new_ctx(), GenerationRequest(prompt=ps[0], max_new_tokens=4,
                                             exclusive=True))
        mates = [app.stream(app.new_ctx(), p, max_new_tokens=4)
                 for p in ps[1:]]
        assert router.pump()
        assert len(solo.tokens) == 2
        assert all(not s.tokens for s in mates)
        router.drain()
        assert len(solo.result()) == 4
        assert all(len(s.result()) == 4 for s in mates)


def test_pump_refuses_work_after_abort():
    svc, cfg = make_svc(decode_batch=1)
    with svc:
        router = ServiceRouter(svc, predict=False, slice_steps=2)
        app = router.register_app("a", "fg")
        stub = app.new_ctx()
        s = app.stream(stub, prompts_for(cfg, 1, seed=31)[0],
                       max_new_tokens=4)
        router.abort()
        assert s.cancelled
        assert not router.pump()
        assert svc.contexts[stub.ctx_id].n_tokens == 0
