"""The port's MoE family (llama4-maverick-400b-a17b) against the JAX package.

Both packages run the reduced llama4-maverick (4 layers, d 64, 4 heads
over 2 KV heads, 4 experts top-1 of 96 + one shared expert of 96,
capacity factor 2, groups of 32) from the SAME weights: the reference's
``init(PRNGKey(0))`` carried across bit for bit.

* ``moe_ffn`` at top-1: the same capacity, dispatch and combine, with
  and without capacity overflow; outputs within one bf16 ulp of their
  range.
* ``decode_step`` (window and mixed caches) and ``recompute``: logits,
  hidden states and K/V at bf16 level (atol 0.02 x max|ref|, rtol 0.02),
  the density within 1e-4 or one bf16 ulp of its largest value.  A
  top-1 router sends a token to another expert where two gates are
  nearly equal; such a pick changes the token's FFN output by far more
  than bf16 level, so these entries run teacher-forced at expert
  near-ties (``_forced_experts``): the reference runs eagerly and
  records its gates, and where the port's pick differs the reference's
  gap between the two experts must lie below the packages' largest gate
  difference; the port then takes the reference's expert.
* The KVSpec (no restore recompute, no pool, no pipelined restore)
  through both packages' ``LLMService`` under one injected restore
  profile, on slot caches: ``llms``, ``llms_nocomp``, ``swap``, ``lmk``
  and ``quant_resident`` replays give equal tokens, bit plans,
  evictions, disk reads and counters (teacher-forced at token near-ties,
  ``_force_ties``), every restore all I/O; ``profile_pipeline`` is a
  no-op; an unreadable chunk counts ``recover_failed`` and raises
  ``ChunkCorruptError`` in both packages.
* Both routers at ``decode_batch=2`` (on slot caches) and
  ``launch.serve.main --arch llama4-maverick-400b-a17b``.
"""
import contextlib
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import (one_torch_thread, services, tiny_pair,  # noqa: F401
                           to_np, to_torch)
from conftest import make_batch
from test_torch_mla import _assert_near_tie, _bf16_ulp, _force_ties
from test_torch_slot import (FAULTS, PROFILE, _assert_same, _replay, _trace,
                             clean_faults)  # noqa: F401

NAME = "llama4-maverick-400b-a17b"
# one raw chunk of the reduced model: k + v x 4 layers x 16 tokens x 2
# KV heads x hd 16 x bf16
RAW_CHUNK = 2 * 4 * 16 * 2 * 16 * 2
BUDGET = 3 * RAW_CHUNK // 2


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


@contextlib.contextmanager
def _forced_experts():
    """Record the reference's router gates, call by call (run the
    reference eagerly inside the block first, then the port); the port's
    ``moe_dispatch`` takes the reference's top-1 expert wherever its own
    differs, which must be a near-tie.  Yields the list of forced
    (call, group, token) triples."""
    from repro.models import moe_layer as jmoe
    from repro_torch.models import moe_layer as tmoe
    jdisp, tdisp = jmoe.moe_dispatch, tmoe.moe_dispatch
    seen, forced, at = [], [], [0]

    def record(gates, top_k, cap):
        seen.append(np.asarray(gates))
        return jdisp(gates, top_k, cap)

    def force(gates, top_k, cap):
        ref = seen[at[0]]
        at[0] += 1
        mine = gates.numpy()
        a_ref, a_port = ref.argmax(-1), mine.argmax(-1)
        if (a_ref != a_port).any():
            gates = gates.clone()
            for g, s in np.argwhere(a_ref != a_port):
                _assert_near_tie(ref[g, s], mine[g, s], a_ref[g, s],
                                 a_port[g, s], "expert choice")
                gates[g, s, a_ref[g, s]] = float(np.nextafter(
                    mine[g, s, a_port[g, s]], np.float32(1)))
                forced.append((at[0] - 1, int(g), int(s)))
        return tdisp(gates, top_k, cap)

    jmoe.moe_dispatch, tmoe.moe_dispatch = record, force
    try:
        with jax.disable_jit():
            yield forced
    finally:
        jmoe.moe_dispatch, tmoe.moe_dispatch = jdisp, tdisp
    assert at[0] == len(seen), "the packages dispatched a different number " \
        "of times"


def test_reduced_config_weights_and_spec_match_reference():
    """The port's configs (full and reduced) are the reference's; the
    converted weights are the reference's bit for bit (no dense FFN, the
    router fp32 (L, d, E), the experts (L, E, d, fe) / (L, E, fe, d));
    the KVSpec equals the reference's: dense's with no restore
    recompute, no pool and no pipelined restore."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    assert (tcfg.moe.n_experts, tcfg.moe.top_k, tcfg.moe.n_shared) == (4, 1, 1)
    lay = tparams["layers"]
    assert lay["router"].dtype == torch.float32
    assert tuple(lay["w_gate"].shape) == (4, 4, 64, 96)
    assert tuple(lay["s_down"].shape) == (4, 96, 64)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 3 + len(lay)
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(to_np(t), np.asarray(leaf).astype(
            np.float32))
    spec, jspec = tmodel.kv_spec(), jmodel.kv_spec()
    assert spec.__dict__ == jspec.__dict__
    assert (spec.recomputable, spec.paged, spec.pipelined_restore,
            spec.batched_decode) == (False, False, False, True)


def test_init_draws_experts_one_at_a_time():
    """The port's own init: the dense stack without its FFN plus the MoE
    leaves from the same generator; a seeded generator repeats; experts
    and layers differ."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    model = build_model(reduced(get_config(NAME)), device="cpu")
    p = model.init(torch.Generator().manual_seed(1))
    q = model.init(torch.Generator().manual_seed(1))
    lay = p["layers"]
    assert set(lay) == {"ln_attn", "ln_ffn", "wq", "wk", "wv", "wo",
                        "router", "w_gate", "w_up", "w_down", "s_gate",
                        "s_up", "s_down"}
    assert all(torch.equal(lay[k], q["layers"][k]) for k in lay)
    assert not torch.equal(lay["w_up"][0, 0], lay["w_up"][0, 1])
    assert not torch.equal(lay["w_up"][0, 0], lay["w_up"][1, 0])
    assert 0.015 < float(lay["w_down"].float().std()) < 0.025


@pytest.mark.parametrize("cf", [2.0, 0.25], ids=["cap16", "cap4"])
def test_moe_ffn_top1_matches_reference(cf):
    """Layer 2's MoE FFN at top-1 on 40 random bf16 tokens (two groups of
    32, the second padded): capacity 16 a group and expert at cf 2 (the
    24 zero pad rows all pick one expert and overflow it), 4 at cf 0.25
    (real tokens dropped too: the shared expert alone carries them).
    The same dispatch and combine (or, where another expert took a
    token, a near-tie), no expert over its capacity, and the outputs of
    every token whose experts agree within one bf16 ulp of their
    range."""
    from repro.models import moe_layer as jmoe
    from repro_torch.models import moe_layer as tmoe
    jcfg, _, jparams, tcfg, _, tparams = tiny_pair(NAME)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    assert tmoe.capacity(32, tm) == jmoe.capacity(32, jm) == \
        (16 if cf == 2.0 else 4)
    pj = {k: jparams["layers"][k][2] for k in tmoe.MOE_KEYS}
    pt = {k: tparams["layers"][k][2] for k in tmoe.MOE_KEYS}
    rng = np.random.default_rng(int(cf * 100))
    x32 = rng.standard_normal((40, 64)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = to_torch(np.asarray(xj))
    xg = jnp.concatenate([xj, jnp.zeros((24, 64), jnp.bfloat16)]).reshape(
        2, 32, 64)
    gj = jax.nn.softmax(xg.astype(jnp.float32) @ pj["router"], axis=-1)
    gt = torch.softmax(to_torch(np.asarray(xg)).float() @ pt["router"],
                       dim=-1)
    cap = tmoe.capacity(32, tm)
    dj, cj, auxj = jmoe.moe_dispatch(gj, 1, cap)
    dt, ct, auxt = tmoe.moe_dispatch(gt, 1, cap)
    dj, dt = np.asarray(dj), dt.numpy()
    pick_j, pick_t = np.asarray(gj).argmax(-1), gt.numpy().argmax(-1)
    for g, s in np.argwhere(pick_j != pick_t):
        _assert_near_tie(np.asarray(gj)[g, s], gt.numpy()[g, s],
                         pick_j[g, s], pick_t[g, s], "expert choice")
    if (pick_j == pick_t).all():
        np.testing.assert_array_equal(dt, dj)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    routed = int(dt.sum())
    assert dt.sum(axis=(1, 3)).max() <= cap          # (G, E) slots used
    assert routed < 64 and (cf == 2.0 or routed <= 2 * 4 * 4)

    yj, _ = jax.jit(functools.partial(jmoe.moe_ffn, moe=jm))(xj, pj)
    yt, _ = tmoe.moe_ffn(xt, pt, tm)
    assert yt.shape == (40, 64) and yt.dtype == torch.bfloat16
    yj = np.asarray(yj).astype(np.float32)
    same = (dj.any(-1) == dt.any(-1)).all(-1).reshape(-1)[:40]
    assert same.sum() >= 40 - 4, same
    ulp = _bf16_ulp(float(np.max(np.abs(yj))))
    assert float(np.max(np.abs(to_np(yt) - yj)[same])) <= ulp


def _dense_caches(jmodel, layout, S, rng):
    """A random reference cache of ``layout`` over S positions and its
    port copy: bf16 K/V, and in the mixed layout int8 K/V with
    per-(token, kv-head) scales on positions [8, 24)."""
    from repro.kernels import ref as jref
    jc = dict(jmodel.init_cache(1, S, layout=layout))
    for n in ("k", "v"):
        x = rng.standard_normal(jc[n].shape).astype(np.float32)
        jc[n] = jnp.asarray(x).astype(jnp.bfloat16)
        if layout == "mixed":
            codes, sc = jref.quantize_token_head_ref(jnp.asarray(
                rng.standard_normal(jc[n].shape).astype(np.float32)))
            jc[n + "_q"], jc[n + "_scale"] = codes, sc
    if layout == "mixed":
        qm = np.zeros((1, 1, S), bool)
        qm[..., 8:24] = True
        jc["quant_mask"] = jnp.asarray(qm)
    tc = {k: to_torch(np.asarray(v)) for k, v in jc.items() if k != "pos"}
    if layout == "mixed":
        tc["quant_mask"] = torch.from_numpy(np.array(jc["quant_mask"]))
    return jc, tc


@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_decode_step_matches_reference(layout):
    """Four decode steps from position 30 over a random cache of 48
    positions, teacher-forced tokens and expert near-ties: logits at
    bf16 level, the per-key mass within 1e-4, the new K/V at bf16
    level, written in place; at most two forced experts."""
    _, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    rng = np.random.default_rng(6)
    jc, tc = _dense_caches(jmodel, layout, 48, rng)
    jc["pos"] = jnp.int32(30)
    tc["pos"] = torch.tensor(30)
    toks = rng.integers(1, 512, 4)
    with _forced_experts() as forced:
        for t in toks:
            jout, jmass = jmodel.decode_step(
                jparams, jnp.asarray([[t]], jnp.int32), jc,
                want_density=True)
            tout, tmass = tmodel.decode_step(
                tparams, torch.tensor([[int(t)]]), tc, want_density=True)
            _close_bf16(jout.logits, tout.logits)
            np.testing.assert_allclose(tmass.numpy(), np.asarray(jmass),
                                       atol=1e-4, rtol=0)
            assert tout.cache["k"] is tc["k"]               # in place
            jc, tc = dict(jout.cache), dict(tout.cache)
    assert len(forced) <= 2, forced
    for n in ("k", "v"):
        _close_bf16(np.asarray(jc[n])[:, :, 30:34], tc[n][:, :, 30:34])
    if layout == "mixed":
        np.testing.assert_array_equal(tc["quant_mask"].numpy(),
                                      np.asarray(jc["quant_mask"]))


@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_recompute_matches_reference(layout):
    """The reference's ``test_recompute_exact`` case on MoE: a 32-token
    prefill by the reference, holes at [3, 4, 10, 11, 20, 21], recomputed
    by both packages with the density, teacher-forced at expert
    near-ties: hidden states and K/V at bf16 level, the density within
    1e-4 or one bf16 ulp of its largest value; in the mixed cache (int8
    K/V on [24, 32), a hole marked quant) the same quant mask."""
    from repro.kernels import ref as jref
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    S = 32
    toks = make_batch(jcfg, 1, S)["tokens"]
    miss = jnp.array([3, 4, 10, 11, 20, 21])
    with _forced_experts() as forced:
        pf = jmodel.prefill(jparams, {"tokens": toks})
        holey = dict(pf.cache)
        for n in ("k", "v"):
            holey[n] = holey[n].at[:, :, miss].set(0)
        if layout == "mixed":
            for n in ("k", "v"):
                holey[n + "_q"], holey[n + "_scale"] = \
                    jref.quantize_token_head_ref(holey[n].astype(
                        jnp.float32))
            qm = np.zeros((1, 1, S), bool)
            qm[..., 24:] = True
            qm[..., 3] = True
            holey["quant_mask"] = jnp.asarray(qm)
        jcache, jx, jdens = jmodel.recompute(jparams, toks[:, miss], miss,
                                             holey, S, want_density=True)
        tc = {k: to_torch(np.asarray(v)) for k, v in holey.items()
              if k != "pos"}
        if layout == "mixed":
            tc["quant_mask"] = torch.from_numpy(np.array(holey["quant_mask"]))
        tc["pos"] = torch.tensor(S)
        # the port's own prefill first, in the reference's call order
        tpf = tmodel.prefill(tparams, {"tokens": to_torch(
            np.asarray(toks)).long()})
        tcache, tx, tdens = tmodel.recompute(
            tparams, to_torch(np.asarray(toks[:, miss])).long(),
            torch.from_numpy(np.array(miss)).long(), tc, S,
            want_density=True)
    assert len(forced) <= 4, forced
    _close_bf16(pf.logits, tpf.logits)
    _close_bf16(jx, tx)
    jd = np.asarray(jdens)
    tol = max(1e-4, _bf16_ulp(float(np.max(np.abs(jd)))))
    np.testing.assert_allclose(tdens.numpy(), jd, atol=tol, rtol=0)
    for n in ("k", "v"):
        _close_bf16(np.asarray(jcache[n]), tcache[n])
        _close_bf16(np.asarray(pf.cache[n]), tpf.cache[n])
    if layout == "mixed":
        np.testing.assert_array_equal(tcache["quant_mask"].numpy(),
                                      np.asarray(jcache["quant_mask"]))


# --------------------------------------------------------------------- #
# whole services
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy,quant,budget", [
    ("llms", False, BUDGET), ("llms_nocomp", False, BUDGET),
    ("swap", False, BUDGET), ("lmk", False, BUDGET),
    ("llms", True, 5 * RAW_CHUNK // 2)],
    ids=["llms", "llms_nocomp", "swap", "lmk", "quant_resident"])
def test_service_replay_matches_reference(policy, quant, budget):
    """3 contexts x 9 calls of 12 + 4 tokens at a budget of 1.5 raw
    chunks (``quant_resident``: 2.5, so that 8-bit chunks stay resident
    as int8 and contexts are still evicted), both packages under one injected restore profile, on slot
    caches (the family declares no pool), teacher-forced at token
    near-ties (at most two): equal tokens, per-call bit plans,
    evictions, disk restores, splits and counters.  No restore
    recomputes (the family is not recomputable); ``lmk`` recomputes
    killed contexts from their text instead."""
    js, ts, cfg = services(name=NAME, policy=policy, quant_resident=quant,
                           budget=budget)
    trace = _trace(cfg.vocab)
    forced = _force_ties(js, ts)
    with js, ts:
        assert not ts.paged and not ts.exe.recomputable
        rec_j, st_j = _replay(js, trace, 3, quant=quant)
        rec_t, st_t = _replay(ts, trace, 3, quant=quant)
        rf = (js.stats()["recover_failed"], ts.stats()["recover_failed"])
    _assert_same(rec_j, rec_t)
    assert len(forced) <= 2, forced
    assert st_t == st_j and rf == (0, 0)
    assert all(len(r["tokens"]) == 4 for r in rec_t)
    assert any(r["evicted"] for r in rec_t)
    splits = [s for r in rec_t for s in r["split"]]
    assert all(not re for _, re, _ in splits)          # all I/O
    if policy == "lmk":
        assert not any(r["restored"] for r in rec_t)
    elif not quant:
        assert any(r["restored"] for r in rec_t)
    if policy in ("swap", "lmk"):
        assert any(r["whole"] for r in rec_t)
    if quant:
        assert any(r["quant_resident_chunks"] for r in rec_t)


def test_profile_pipeline_is_a_no_op():
    """The §3.3.i profile needs restore recompute: both packages return
    without profiling, and restores stay unprofiled (all I/O)."""
    js, ts, _ = services(name=NAME, policy="llms", budget=BUDGET)
    with js, ts:
        for svc in (js, ts):
            svc.profile_pipeline()
            assert not svc.res.profiled


def test_unreadable_chunk_raises_in_both_packages(clean_faults):
    """Bit-flipped chunk files (``bit_flip`` on disk.write, rate 0.25,
    seed 2024, in both packages' fault registries): the first restore
    that finds a corrupt chunk cannot recompute it, counts
    ``recover_failed`` and raises ``ChunkCorruptError``, in both
    packages, at the same call, after the same tokens (teacher-forced at
    token near-ties) and with the same counters."""
    from test_torch_slot import _COUNTERS
    js, ts, cfg = services(name=NAME, policy="llms_nocomp", budget=BUDGET)
    forced = _force_ties(js, ts)
    for f in FAULTS.values():
        f.install_faults([f.FaultSpec(kind="bit_flip", sites=("disk.write",),
                                      rate=0.25)], seed=2024)
    out = {}
    with js, ts:
        for pkg, svc in (("jax", js), ("torch", ts)):
            stubs = [svc.newLLMCtx() for _ in range(3)]
            done, err = [], None
            for c, prompt, n in _trace(cfg.vocab):
                try:
                    done.append(svc.callLLM(stubs[c], prompt, n)[1])
                except FAULTS[pkg].ChunkCorruptError as e:
                    err = str(e)
                    break
            st = svc.stats()
            out[pkg] = (done, err, {k: st[k] for k in _COUNTERS})
    assert out["torch"][0] == out["jax"][0] and len(forced) <= 2, forced
    assert out["torch"][2] == out["jax"][2]
    done, err, st = out["torch"]
    assert "cannot recompute" in err and "cannot recompute" in out["jax"][1]
    assert st["faults_injected_total"] > 0, "no faults drawn: dead test"
    assert st["recover_failed"] == 1 and st["chunks_corrupt_detected"] >= 1
    assert st["chunks_recovered_recompute"] == 0 and len(done) >= 3


def test_router_and_serve_main_match_reference(capsys):
    """Both packages' routers over the reduced llama4-maverick at
    ``decode_batch=2`` on one markov trace (slot caches: a round of two
    decodes its members one after another, as in the reference):
    equal completions, evictions and router counts.  Then
    ``launch.serve.main --device cpu --reduced --arch
    llama4-maverick-400b-a17b`` serves its trace with no failed call and
    no paged pool, with the mixed slot cache."""
    from repro.core.scheduler import ServiceRouter as JRouter
    from repro.launch import serve as jserve
    from repro.trace.synth import synthesize as jsynth
    from repro_torch.core.scheduler import ServiceRouter as TRouter
    from repro_torch.launch import serve as tserve
    from repro_torch.trace.synth import synthesize as tsynth
    from test_torch_router import _counts, _first_difference
    from test_torch_router import _replay as router_replay
    js, ts, cfg = services(name=NAME, decode_batch=2, budget=3 * RAW_CHUNK)
    ev_j = jsynth(4, 10, cfg.vocab, pattern="markov", scale=0.05, seed=2)
    ev_t = tsynth(4, 10, cfg.vocab, pattern="markov", scale=0.05, seed=2)
    forced = _force_ties(js, ts)
    with js, ts:
        for svc in (js, ts):
            for k, v in PROFILE.items():
                setattr(svc.res.profile, k, v)
            svc.res.profiled = True
        log_j, st_j, sz_j = router_replay(js, JRouter, jserve.run_trace, ev_j)
        log_t, st_t, sz_t = router_replay(ts, TRouter, tserve.run_trace, ev_t)
        assert ts.exe.decode_slots == 2 and not ts.paged
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j) and sz_t == sz_j
    # three of its ~90 entry calls fork at near-ties: reference gaps
    # 0.021-0.024 between logits near 8, below one bf16 ulp there (0.031)
    assert len(forced) <= 3, forced
    assert len([e for e in log_t if e[0] == "done"]) == 10
    assert st_t["failed_calls"] == 0
    assert any(e[0] == "evict" for e in log_t)

    tserve.main(["--reduced", "--device", "cpu", "--arch", NAME, "--calls",
                 "6", "--contexts", "3", "--max-ctx", "512",
                 "--decode-batch", "2", "--concurrency", "2",
                 "--quant-resident"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == 0 and not printed["paged_pool"]
    assert printed["router"]["foreground"]["calls"] \
        + printed["router"]["background"]["calls"] == 6
