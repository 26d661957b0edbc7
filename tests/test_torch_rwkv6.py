"""The port's RWKV6 family (rwkv6-1.6b) against the JAX package.

Both packages run the reduced rwkv6 (4 layers, d 64, 4 heads of 16,
decay LoRA 8, mix LoRA 4, chunks of 16) from the SAME weights: the
reference's ``init(PRNGKey(0))`` carried across bit for bit by
``convert.params_from_jax``.

Tolerances.
* ``_wkv_chunked`` on the same fp32 inputs: within 1e-5 of the output's
  and the state's range (both compute in fp32; the cumulative sums and
  products sum in different orders).  Against the sequential recurrence
  of the same inputs (the reference's ``test_rwkv_chunked_matches_
  sequential`` in fp32, without bf16 inputs): 1e-4 of the range.
* ``prefill``, ``decode_step`` and ``recompute`` on the model: logits and
  the bf16 token-shift rows ``tm`` / ``cm`` within 2% of their range
  (bf16 level, as the dense and MLA tests), the fp32 ``wkv`` state
  within 2% of its range (it integrates bf16 k / v that differ at bf16
  level).
* The services (``llms``, ``swap``, ``lmk``), both routers and
  ``launch.serve.main``: equal tokens, per-call records (evictions, disk
  reads, snapshot bytes) and stats.  The service replays pick every
  token as the reference does.  The router's trace meets two exact bf16
  ties, at picks 48 and 49 and nowhere else: the port's two logits are
  the same bf16 value (8.375, 8.125; a bf16 ulp there is 0.0625), and
  the reference's, rounded to bf16 as its model declares them, lie one
  ulp apart (raw gaps 0.052 and 0.072).  The router replay runs
  teacher-forced at those two picks only
  (``test_torch_mla._force_ties(..., bf16_ties=(48, 49))``).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, services, tiny_pair  # noqa: F401
from _torch_parity import to_np
from conftest import make_batch
from test_torch_mla import _close_bf16, _force_ties
from test_torch_slot import _assert_same, _replay, _trace

NAME = "rwkv6-1.6b"
# one whole-state snapshot of the reduced model: wkv fp32 (L, 1, H, hd,
# hd) + tm / cm fp16 (L, 1, d)
SNAPSHOT = 4 * 4 * 16 * 16 * 4 + 2 * 4 * 64 * 2
BUDGET = 3 * SNAPSHOT // 2


def _frac_of_range(a, b, frac):
    a, b = to_np(a), to_np(b)
    span = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=0, atol=frac * span)


def test_reduced_config_and_weights_match_reference():
    """The port's configs equal the reference's (full and reduced), the
    converted weights are the reference's bit for bit, and the port's
    own ``init`` draws the same tree of shapes and dtypes."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, _, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 4 + len(tparams["layers"])
    for path, leaf in flat_j:
        t = tparams
        for k in (p.key for p in path):
            t = t[k]
        np.testing.assert_array_equal(to_np(t), to_np(leaf))
    own = tmodel.init(torch.Generator().manual_seed(1))

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict)
                else (tuple(v.shape), v.dtype) for k, v in tree.items()}
    assert layout(own) == layout(tparams)


def _wkv_inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    # log-decays as the model makes them: -exp(.) clamped at the floor
    ld = np.maximum(-np.exp(rng.standard_normal((B, S, H, hd)) - 0.5),
                    -5.0).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    return r, k, v, ld, u, s0


def _wkv_sequential(r, k, v, ld, u, s0):
    """The recurrence one step at a time (fp64 numpy)."""
    r, k, v, ld, u, S = (a.astype(np.float64) for a in (r, k, v, ld, u, s0))
    out = np.zeros_like(v)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]          # (B,H,k,v)
        out[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t],
                              S + u[None, :, :, None] * kv)
        S = np.exp(ld[:, t])[..., None] * S + kv
    return out, S


@pytest.mark.parametrize("S", [16, 37], ids=["one-chunk", "padded"])
def test_wkv_chunked_matches_reference_and_sequential(S):
    """``_wkv_chunked`` on the same fp32 inputs (two rows, a carried
    state, S = 37: two chunks and a padded third) against the
    reference's jitted one within 1e-5 of the range, and against the
    sequential recurrence within 1e-4."""
    _, jmodel, _, _, tmodel, _ = tiny_pair(NAME)
    args = _wkv_inputs(2, S, 4, 16, seed=S)
    jout, jstate = jax.jit(jmodel._wkv_chunked)(*map(jnp.asarray, args))
    tout, tstate = tmodel._wkv_chunked(*map(torch.from_numpy, args))
    assert tout.shape == (2, S, 4, 16) and tstate.dtype == torch.float32
    _frac_of_range(jout, tout, 1e-5)
    _frac_of_range(jstate, tstate, 1e-5)
    sout, sstate = _wkv_sequential(*args)
    _frac_of_range(sout, tout, 1e-4)
    _frac_of_range(sstate, tstate, 1e-4)


def test_prefill_decode_recompute_match_reference():
    """Two rows: a 21-token prefill, 8 decode steps teacher-forced, then
    a 12-token ``recompute`` continuing the carried state, in both
    packages: logits, ``wkv`` / ``tm`` / ``cm`` at bf16 level (2% of
    range); the port writes in place, its decode emits a (B, 1) zero
    mass and its recompute a zero density; the port's chunked prefill
    equals its own sequential decode of the same tokens."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    B, S = 2, 21
    toks = np.array(make_batch(jcfg, B, S + 8 + 12, seed=3)["tokens"])
    jpf = jax.jit(jmodel.prefill)(jparams,
                                  {"tokens": jnp.asarray(toks[:, :S])})
    tpf = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])})
    assert tpf.density is None and int(tpf.cache["pos"]) == S
    _close_bf16(jpf.logits, tpf.logits)
    jc, tc = dict(jpf.cache), tpf.cache
    wkv_prefill = tc["wkv"].clone()
    dec = jax.jit(jmodel.decode_step, static_argnames="want_density")
    for i in range(S, S + 8):
        t = toks[:, i:i + 1]
        jo = dec(jparams, jnp.asarray(t), jc)
        to, mass = tmodel.decode_step(tparams, torch.from_numpy(t), tc,
                                      want_density=True)
        assert to.cache is tc and tuple(mass.shape) == (B, 1)
        assert not mass.any()
        _close_bf16(jo.logits, to.logits)
        jc = dict(jo.cache)
    assert int(tc["pos"]) == S + 8
    rec = jax.jit(lambda p, t, q, c: jmodel.recompute(
        p, t, q, c, S + 20, want_density=True))
    miss = np.arange(S + 8, S + 20)
    jc2, jx, jd = rec(jparams, jnp.asarray(toks[:, S + 8:]),
                      jnp.asarray(miss), jc)
    tc2, tx, td = tmodel.recompute(tparams, torch.from_numpy(toks[:, S + 8:]),
                                   torch.from_numpy(miss), tc, S + 20,
                                   want_density=True)
    assert tc2 is tc and not td.any() and tuple(td.shape) == (B, 12)
    _close_bf16(jx, tx)
    for n in ("wkv", "tm", "cm"):
        _frac_of_range(np.asarray(jc2[n]).astype(np.float32), tc2[n], 0.02)
    # the chunked-parallel prefill against the port's own sequential form
    seq = tmodel.init_cache(B, 0)
    for i in range(S):
        tmodel.decode_step(tparams, torch.from_numpy(toks[:, i:i + 1]), seq)
    _frac_of_range(wkv_prefill, seq["wkv"], 0.02)


def test_whole_state_codec_round_trips():
    """``WholeStateCodec``: extract gives every state leaf whole whatever
    the range; insert writes them back in place (fp16 snapshots cast to
    bf16); scatter and scatter_quant raise.  The service's snapshot of a
    state cache keeps wkv in fp32 bit for bit and tm / cm as fp16, and
    restores it exactly; the extend runs at exact length."""
    from repro_torch.core.chunks import WholeStateCodec
    _, ts, _ = services(name=NAME, port_only=True, budget=10 * SNAPSHOT)
    with ts:
        exe = ts.exe
        assert isinstance(exe.codec, WholeStateCodec) and not exe.pad_safe
        assert exe.leaf_shapes == {"wkv": (4, 1, 4, 16, 16), "tm": (4, 1, 64),
                                   "cm": (4, 1, 64)}
        seen = []
        recompute = exe.model.recompute

        def counted(params, toks, pos, *a, **k):
            seen.append((toks.shape[1], tuple(pos.tolist())))
            return recompute(params, toks, pos, *a, **k)
        exe.model.recompute = counted
        cache, logits, dens = exe.extend(exe.fresh_cache(0),
                                         np.arange(1, 11, dtype=np.int32), 0)
        exe.model.recompute = recompute
        assert seen == [(10, tuple(range(10)))]        # no bucket pad
        assert logits.shape == (512,) and dens.shape == (10,)
        codec = exe.codec
        blocks = codec.extract(cache, 3, 5)
        assert set(blocks) == {"wkv", "tm", "cm"}
        assert blocks["wkv"] is cache["wkv"]
        snap = ts.res._extract_whole(cache, 10)
        assert snap["wkv"].dtype == np.float32
        assert snap["tm"].dtype == snap["cm"].dtype == np.float16
        np.testing.assert_array_equal(snap["wkv"], cache["wkv"].numpy())
        cache["wkv"] += 1.0                      # the snapshot is a copy
        assert not np.array_equal(snap["wkv"], cache["wkv"].numpy())
        back = codec.insert(exe.fresh_cache(10), 0,
                            {k: torch.from_numpy(v) for k, v in snap.items()})
        np.testing.assert_array_equal(back["wkv"].numpy(), snap["wkv"])
        for n in ("tm", "cm"):
            assert back[n].dtype == torch.bfloat16
            np.testing.assert_array_equal(to_np(back[n]),
                                          snap[n].astype(np.float32))
        with pytest.raises(NotImplementedError, match="scatter"):
            codec.scatter(cache, None, {})
        with pytest.raises(NotImplementedError, match="quant"):
            codec.scatter_quant(cache, None, {}, {})
        with pytest.raises(ValueError, match="state leaves"):
            WholeStateCodec(())


def _records_with_snapshots(svc, trace):
    """``test_torch_slot._replay`` and, per call, the bytes of the
    context's resident snapshot and whether its snapshot file exists.
    (The files' sizes differ by 4 bytes of pickle framing: the
    reference's fp32 leaf is a read-only view of its device buffer.)"""
    sizes = []
    call = svc.callLLM

    def sized(stub, prompt, max_new):
        out = call(stub, prompt, max_new)
        svc.swapper.flush(raise_errors=False)
        ctx = svc.contexts[stub.ctx_id]
        sizes.append((svc.res._whole_bytes(ctx),
                      bool(svc.store.nbytes((ctx.cid, -1)))))
        return out
    svc.callLLM = sized
    records, stats = _replay(svc, trace, 3)
    for r, s in zip(records, sizes):
        r["snapshot_bytes"], r["on_disk"] = s
    return records, stats


@pytest.mark.parametrize("policy", ["llms", "swap", "lmk"])
def test_service_replay_matches_reference(policy):
    """3 contexts x 9 calls of 12 + 4 tokens at a budget of 1.5 whole-
    state snapshots, both packages, not teacher-forced: equal tokens,
    evictions, disk reads, snapshot bytes, snapshot files and stats, no
    chunk ever (the state is one 16-bit-or-wider blob under every
    policy); ``llms`` and ``swap`` read snapshots back from disk,
    ``lmk`` recomputes them from the text."""
    js, ts, cfg = services(name=NAME, policy=policy, budget=BUDGET)
    trace = _trace(cfg.vocab)
    with js, ts:
        assert not ts.paged and not ts.exe.chunked_cache
        rec_j, st_j = _records_with_snapshots(js, trace)
        rec_t, st_t = _records_with_snapshots(ts, trace)
    _assert_same(rec_j, rec_t)
    assert st_t == st_j
    assert all(len(r["tokens"]) == 4 and not r["bits"] for r in rec_t)
    assert any(r["evicted"] for r in rec_t)
    assert all(r["snapshot_bytes"] in (0, SNAPSHOT) for r in rec_t)
    if policy == "lmk":
        assert not any(r["restored"] for r in rec_t)
        assert not any(r["on_disk"] for r in rec_t)
    else:
        assert sum(bool(r["restored"]) for r in rec_t) >= 2
        assert any(r["on_disk"] for r in rec_t)


def test_router_and_serve_main_match_reference(capsys):
    """Both packages' routers over the reduced rwkv6 at ``decode_batch=2``
    on one markov trace (no batched decode: a round's members decode one
    after another): equal completions, evictions and router counts.
    Then ``launch.serve.main --device cpu --reduced --arch rwkv6-1.6b``
    serves its trace with no failed call and no paged pool."""
    from repro.core.scheduler import ServiceRouter as JRouter
    from repro.launch import serve as jserve
    from repro.trace.synth import synthesize as jsynth
    from repro_torch.core.scheduler import ServiceRouter as TRouter
    from repro_torch.launch import serve as tserve
    from repro_torch.trace.synth import synthesize as tsynth
    from test_torch_router import _counts, _first_difference
    from test_torch_router import _replay as router_replay
    js, ts, cfg = services(name=NAME, decode_batch=2, budget=2 * SNAPSHOT)
    ev_j = jsynth(4, 10, cfg.vocab, pattern="markov", scale=0.05, seed=2)
    ev_t = tsynth(4, 10, cfg.vocab, pattern="markov", scale=0.05, seed=2)
    forced = _force_ties(js, ts, bf16_ties=(48, 49))
    with js, ts:
        log_j, st_j, sz_j = router_replay(js, JRouter, jserve.run_trace, ev_j)
        log_t, st_t, sz_t = router_replay(ts, TRouter, tserve.run_trace, ev_t)
        assert ts.exe.decode_slots == 2 and not ts.exe.can_batch_decode
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j) and sz_t == sz_j
    assert forced == [48, 49], forced
    assert len([e for e in log_t if e[0] == "done"]) == 10
    assert st_t["failed_calls"] == 0
    assert any(e[0] == "evict" for e in log_t)

    tserve.main(["--reduced", "--device", "cpu", "--arch", NAME, "--calls",
                 "6", "--contexts", "3", "--max-ctx", "512",
                 "--decode-batch", "2", "--concurrency", "2",
                 "--budget-mib", "0.03"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == 0 and not printed["paged_pool"]
    assert printed["router"]["foreground"]["calls"] \
        + printed["router"]["background"]["calls"] == 6
