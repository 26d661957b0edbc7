"""The port's MLA + MoE family (deepseek-v2-lite-16b) against the JAX package.

Both packages run the reduced deepseek-v2-lite (4 layers, d 64, 4
experts top-2 + 2 shared, rank 32, nope 16, rope 8, v 16) from the SAME
weights: the reference's ``init(PRNGKey(0))`` carried across bit for
bit by ``convert.params_from_jax``.

* ``moe_ffn``: the same dispatch and combine, and outputs within one
  bf16 ulp of their range, with and without capacity overflow.
* ``decode_step`` (absorbed attention): logits at bf16 level, the
  per-key mass within 1e-4, window and mixed caches.
* ``recompute`` (Fig. 7): the reference's ``test_recompute_exact`` case,
  latents at rtol = atol = 2e-2 against the reference's prefill, the
  density within 1e-4 or one bf16 ulp of its largest value.
* ``attn_density``'s plain version at Dqk != Dv against ``gqa_attention``.
* Both packages' ``LLMService`` under one injected restore profile
  (``llms``, ``llms_nopipe``, ``swap``, ``lmk``, ``quant_resident``),
  both routers at ``decode_batch=2`` (serial rounds: no batched decode
  for this family), and ``launch.serve.main``.  Equal tokens, bit plans
  (all >= 8, the family's floor), evictions and splits.

Where the packages pick another expert or another token, the first
difference must be a near-tie: the reference's gap between the two
choices below the packages' largest difference of the quantity picked
from (``_assert_near_tie``).  The services run teacher-forced at such
ties (``_force_ties``): the logits are bf16 values, so a gap of one
logit ulp is a tie the two packages may break differently (the
reduced model hits one in ``swap``'s replay: gap 0.0045 against a
difference of 0.046).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import (one_torch_thread, services, tiny_pair,  # noqa: F401
                           to_np, to_torch)
from conftest import make_batch
from test_torch_slot import PROFILE, _assert_same, _replay, _trace

NAME = "deepseek-v2-lite-16b"
# one raw latent chunk of the reduced model: (ckv 32 + kpe 8) x 4 layers
# x 16 tokens x bf16
RAW_CHUNK = (32 + 8) * 4 * 16 * 2
BUDGET = 3 * RAW_CHUNK // 2


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def _assert_near_tie(ref_vals, port_vals, ref_pick, port_pick, what):
    """The packages picked differently from ``ref_vals`` / ``port_vals``
    (the same quantity): the reference's gap between its pick and the
    port's is below the packages' largest difference of that quantity."""
    ref_vals, port_vals = np.asarray(ref_vals), np.asarray(port_vals)
    gap = float(ref_vals[ref_pick] - ref_vals[port_pick])
    err = float(np.max(np.abs(ref_vals - port_vals)))
    assert 0.0 <= gap <= err, (what, gap, err)


def _assert_bf16_tie(ref_vals, port_vals, ref_pick, port_pick):
    """The port's logits at both picks are the same bf16 value (argmax
    breaks the tie by the lower id), and the reference's, rounded to
    bf16 as its model declares them (``x @ head`` of bf16 operands; XLA
    on the CPU hands them back unrounded), lie at most one bf16 ulp
    apart: the smallest gap two different bf16 logits can have."""
    assert port_vals[ref_pick] == port_vals[port_pick], (
        port_vals[ref_pick], port_vals[port_pick])
    pair = torch.tensor([ref_vals[ref_pick], ref_vals[port_pick]])
    hi, lo = pair.to(torch.bfloat16).double().tolist()
    assert 0.0 <= hi - lo <= _bf16_ulp(abs(port_vals[port_pick])), (hi, lo)


def _force_ties(js, ts, bf16_ties=(), entries=("extend", "decode")):
    """Teacher-force the port's service at near-ties: the reference's
    executor ``entries`` (which return (cache, logits, extra), the logits
    one row) record their logits in call order; where the port's call of
    the same index picks another greedy token, that must be a near-tie,
    and the port's logits are raised at the reference's pick so that
    both go on from the same token.  At the call indices in
    ``bf16_ties`` the pick must instead be an exact bf16 tie
    (``_assert_bf16_tie``).  Run the reference first.
    -> the indices of the forced calls."""
    seq, forced, at = [], [], [0]

    def record(f):
        def run(*a):
            out = f(*a)
            seq.append(np.asarray(out[1], np.float64).reshape(-1))
            return out
        return run

    def force(f):
        def run(*a):
            cache, logits, extra = f(*a)
            ref = seq[at[0]]
            at[0] += 1
            row = np.asarray(logits, np.float64).reshape(-1)
            a_ref, a_port = int(np.argmax(ref)), int(np.argmax(row))
            if a_ref != a_port:
                if at[0] - 1 in bf16_ties:
                    _assert_bf16_tie(ref, row, a_ref, a_port)
                else:
                    _assert_near_tie(ref, row, a_ref, a_port, "token")
                logits = np.array(logits)
                logits.reshape(-1)[a_ref] = row[a_port] + 1.0
                forced.append(at[0] - 1)
            return cache, logits, extra
        return run

    for name in entries:
        setattr(js.exe, name, record(getattr(js.exe, name)))
        setattr(ts.exe, name, force(getattr(ts.exe, name)))
    return forced


def test_reduced_config_and_weights_match_reference():
    """The port's reduced config is the reference's (MLA and MoE fields
    included), and the converted weights are the reference's bit for
    bit: the router fp32 (L, d, E), experts (L, E, d, fe) / (L, E, fe,
    d), every leaf stacked over L."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, _, jparams, tcfg, _, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    L, d, E, fe = 4, 64, 4, 96
    lay = tparams["layers"]
    assert lay["router"].dtype == torch.float32
    assert tuple(lay["router"].shape) == (L, d, E)
    assert tuple(lay["w_gate"].shape) == (L, E, d, fe)
    assert tuple(lay["w_down"].shape) == (L, E, fe, d)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat_j) == 3 + len(lay)
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tparams
        for k in keys:
            t = t[k]
        a = np.asarray(leaf)
        assert t.dtype == (torch.bfloat16 if a.dtype.name == "bfloat16"
                           else torch.from_numpy(a[:0].copy()).dtype), keys
        np.testing.assert_array_equal(to_np(t), a.astype(np.float32), keys)


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["fits", "overflow"])
def test_moe_ffn_matches_reference(cf):
    """Layer 1's MoE FFN on 40 random bf16 tokens (two groups of 32, the
    second padded): the same capacity, dispatch and combine (or, where
    another expert took a token, a near-tie), and the outputs of every
    token whose experts agree within one bf16 ulp of their range.  At a
    capacity factor of 0.5 (capacity 8 of 32 slots) tokens are
    dropped."""
    from repro.models import moe_layer as jmoe
    from repro_torch.models import moe_layer as tmoe
    jcfg, _, jparams, tcfg, _, tparams = tiny_pair(NAME)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    tm = dataclasses.replace(tcfg.moe, capacity_factor=cf)
    assert tmoe.capacity(32, tm) == jmoe.capacity(32, jm) == \
        (32 if cf == 2.0 else 8)
    keys = ("router", "w_gate", "w_up", "w_down", "s_gate", "s_up",
            "s_down")
    pj = {k: jparams["layers"][k][1] for k in keys}
    pt = {k: tparams["layers"][k][1] for k in keys}
    rng = np.random.default_rng(int(cf * 10))
    x32 = rng.standard_normal((40, 64)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = to_torch(np.asarray(xj))

    # the router and the dispatch, group by group
    xg = np.concatenate([x32, np.zeros((24, 64), np.float32)])
    xgj = jnp.asarray(xg).astype(jnp.bfloat16).reshape(2, 32, 64)
    gj = jax.nn.softmax(xgj.astype(jnp.float32) @ pj["router"], axis=-1)
    gt = torch.softmax(to_torch(np.asarray(xgj)).float() @ pt["router"],
                       dim=-1)
    dj, cj, auxj = jmoe.moe_dispatch(gj, jm.top_k, jmoe.capacity(32, jm))
    dt, ct, auxt = tmoe.moe_dispatch(gt, tm.top_k, tmoe.capacity(32, tm))
    dj, dt = np.asarray(dj), dt.numpy()
    if not np.array_equal(dj, dt):
        # another expert somewhere: the first such token's pick is a tie
        g, s = np.argwhere((dj != dt).any(axis=(2, 3)))[0]
        ej = np.flatnonzero(dj[g, s].any(-1))
        et = np.flatnonzero(dt[g, s].any(-1))
        a = next(e for e in ej if e not in et)
        b = next(e for e in et if e not in ej)
        _assert_near_tie(np.asarray(gj)[g, s], gt.numpy()[g, s], a, b,
                         "expert choice")
    else:
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)
    routed = dt.sum()
    if cf == 0.5:
        assert routed < 40 * tm.top_k + 24 * tm.top_k      # tokens dropped
    else:
        assert routed == 64 * tm.top_k                      # none dropped

    yj, _ = jax.jit(functools.partial(jmoe.moe_ffn, moe=jm))(xj, pj)
    yt, mt = tmoe.moe_ffn(xt, pt, tm)
    assert yt.shape == (40, 64) and yt.dtype == torch.bfloat16
    yj = np.asarray(yj).astype(np.float32)
    ulp = _bf16_ulp(float(np.max(np.abs(yj))))
    # every token whose experts (after the capacity drop) agree gives the
    # same output; one that another expert took is the near-tie above
    same = (dj.any(-1) == dt.any(-1)).all(-1).reshape(-1)[:40]
    assert same.sum() >= 40 - 4, same
    assert float(np.max(np.abs(to_np(yt) - yj)[same])) <= ulp
    np.testing.assert_allclose(float(mt["moe_aux"]), float(auxj), rtol=1e-5)


def test_moe_init_draws_one_layer_at_a_time():
    """``init_moe_params``: stacked shapes and dtypes of the reference's,
    the router bf16-valued in fp32, a seeded generator repeats."""
    from repro_torch.models.moe_layer import init_moe_params
    _, _, _, tcfg, _, _ = tiny_pair(NAME)
    p = init_moe_params(torch.Generator().manual_seed(3), 64, tcfg.moe,
                        "cpu", n_layers=2)
    q = init_moe_params(torch.Generator().manual_seed(3), 64, tcfg.moe,
                        "cpu", n_layers=2)
    assert p["router"].dtype == torch.float32
    assert torch.equal(p["router"], p["router"].bfloat16().float())
    assert tuple(p["w_up"].shape) == (2, 4, 64, 96)
    assert tuple(p["s_down"].shape) == (2, 96, 64)
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(p["w_gate"][0], p["w_gate"][1])


# --------------------------------------------------------------------- #
# the model entries
# --------------------------------------------------------------------- #
def _caches(jmodel, layout, S, rng):
    """A random reference cache of ``layout`` over S positions and its
    port copy: bf16 latents, and in the mixed layout int8 latents with
    per-(token, layer) scales on positions [8, 24)."""
    from repro.kernels import ref as jref
    jc = dict(jmodel.init_cache(1, S, layout=layout))
    for n, w in (("ckv", 32), ("kpe", 8)):
        x = rng.standard_normal((4, 1, S, w)).astype(np.float32)
        jc[n] = jnp.asarray(x).astype(jnp.bfloat16)
        if layout == "mixed":
            codes, sc = jref.quantize_token_head_ref(jnp.asarray(
                rng.standard_normal((4, 1, S, 1, w)).astype(np.float32)))
            jc[n + "_q"], jc[n + "_scale"] = codes[..., 0, :], sc[..., 0]
    if layout == "mixed":
        qm = np.zeros((1, 1, S), bool)
        qm[..., 8:24] = True
        jc["quant_mask"] = jnp.asarray(qm)
    tc = {k: to_torch(np.asarray(v)) for k, v in jc.items() if k != "pos"}
    if layout == "mixed":
        tc["quant_mask"] = torch.from_numpy(np.array(jc["quant_mask"]))
    return jc, tc


@pytest.mark.parametrize("window,n_sinks", [(0, 0), (12, 2)])
@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_decode_step_matches_reference(layout, window, n_sinks):
    """Three absorbed decode steps from position 30 over a random cache
    of 48 positions, teacher-forced: logits at bf16 level, the per-key
    mass within 1e-4, the new latents at bf16 level, written in place;
    in the mixed cache the new positions leave the quant mask."""
    _, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    rng = np.random.default_rng(5)
    jc, tc = _caches(jmodel, layout, 48, rng)
    jc["pos"] = jnp.int32(30)
    tc["pos"] = torch.tensor(30)
    toks = rng.integers(1, 512, 3)
    dec = jax.jit(functools.partial(jmodel.decode_step, window=window,
                                    n_sinks=n_sinks, want_density=True))
    for t in toks:
        jout, jmass = dec(jparams, jnp.asarray([[t]], jnp.int32), jc)
        tout, tmass = tmodel.decode_step(
            tparams, torch.tensor([[int(t)]]), tc, window=window,
            n_sinks=n_sinks, want_density=True)
        _close_bf16(jout.logits, tout.logits)
        np.testing.assert_allclose(tmass.numpy(), np.asarray(jmass),
                                   atol=1e-4, rtol=0)
        assert tout.cache["ckv"] is tc["ckv"]               # in place
        jc, tc = dict(jout.cache), dict(tout.cache)
        assert int(tc["pos"]) == int(jc["pos"])
    for n in ("ckv", "kpe"):
        _close_bf16(np.asarray(jc[n])[:, :, 30:33], tc[n][:, :, 30:33])
    if layout == "mixed":
        np.testing.assert_array_equal(tc["quant_mask"].numpy(),
                                      np.asarray(jc["quant_mask"]))


@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_recompute_matches_reference(layout):
    """The reference's ``test_recompute_exact`` case: a 32-token prefill
    by the reference, holes at [3, 4, 10, 11, 20, 21], recomputed by both
    packages with the density.  The port's latents equal the prefill's
    at rtol = atol = 2e-2 (window cache); the hidden states agree at
    bf16 level and the density within 1e-4 or one bf16 ulp of its
    largest value.  In the mixed cache (int8 latents on [24, 32)) the
    recomputed positions leave the quant mask as in the reference."""
    from repro.kernels import ref as jref
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    S = 32
    batch = make_batch(jcfg, 1, S)
    pf = jax.jit(lambda p, b: jmodel.prefill(p, b))(
        jparams, {"tokens": batch["tokens"]})
    miss = jnp.array([3, 4, 10, 11, 20, 21])
    holey = dict(pf.cache)
    for n in ("ckv", "kpe"):
        holey[n] = holey[n].at[:, :, miss].set(0)
    if layout == "mixed":
        for n in ("ckv", "kpe"):
            codes, sc = jref.quantize_token_head_ref(
                holey[n].astype(jnp.float32)[..., None, :])
            holey[n + "_q"], holey[n + "_scale"] = codes[..., 0, :], sc[..., 0]
        qm = np.zeros((1, 1, S), bool)
        qm[..., 24:] = True
        qm[..., 3] = True                       # a hole marked quant
        holey["quant_mask"] = jnp.asarray(qm)
    jrec = jax.jit(lambda p, t, q, c: jmodel.recompute(
        p, t, q, c, S, want_density=True))
    jcache, jx, jdens = jrec(jparams, batch["tokens"][:, miss], miss, holey)
    tc = {k: to_torch(np.asarray(v)) for k, v in holey.items() if k != "pos"}
    if layout == "mixed":
        tc["quant_mask"] = torch.from_numpy(np.array(holey["quant_mask"]))
    tc["pos"] = torch.tensor(S)
    tcache, tx, tdens = tmodel.recompute(
        tparams, to_torch(np.asarray(batch["tokens"][:, miss])).long(),
        torch.from_numpy(np.array(miss)).long(), tc, S, want_density=True)
    assert tcache is tc and tx.shape == (1, 6, 64)
    _close_bf16(jx, tx)
    jd = np.asarray(jdens)
    tol = max(1e-4, _bf16_ulp(float(np.max(np.abs(jd)))))
    np.testing.assert_allclose(tdens.numpy(), jd, atol=tol, rtol=0)
    for n in ("ckv", "kpe"):
        if layout == "window":
            np.testing.assert_allclose(to_np(tcache[n]),
                                       np.asarray(pf.cache[n]).astype(
                                           np.float32), rtol=2e-2, atol=2e-2)
        _close_bf16(np.asarray(jcache[n]), tcache[n])
    if layout == "mixed":
        np.testing.assert_array_equal(tcache["quant_mask"].numpy(),
                                      np.asarray(jcache["quant_mask"]))
        assert not tcache["quant_mask"][0, 0, 3]


def test_undeclared_entries_raise():
    """The entries this family's KVSpec does not declare raise a clear
    error; the spec sends the service to slot caches at the 8-bit
    floor of the latent class."""
    _, _, _, _, tmodel, _ = tiny_pair(NAME)
    spec = tmodel.kv_spec()
    assert (spec.paged, spec.batched_decode, spec.pipelined_restore) == \
        (False, False, False)
    assert (spec.min_bits, spec.tolerance_class) == (8, "latent")
    for entry, cap in (("recompute_pipelined", "pipelined_restore"),
                       ("decode_paged", "paged"), ("extend_paged", "paged")):
        with pytest.raises(NotImplementedError, match=cap):
            getattr(tmodel, entry)(None)


@pytest.mark.parametrize("form", ["served", "flash"])
def test_plain_attn_density_at_mla_dims_matches_gqa_attention(form):
    """The plain ``attn_density`` at MLA's head-dim split (Dqk 24, Dv 16
    here; 192 / 128 at full width) over a holey cache with bucket pads:
    the served form is ``gqa_attention`` under the extend mask, op for
    op (out bit for bit, density within 1e-6); the flash form's out at
    bf16 level."""
    from repro_torch.kernels import ref as kref
    from repro_torch.models import common as C
    rng = np.random.default_rng(9)
    S, H = 64, 4
    q = torch.from_numpy(rng.standard_normal((1, 16, H, 24)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((1, S, H, 24)).astype(
        np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((1, S, H, 16)).astype(
        np.float32)).bfloat16()
    q_pos = torch.tensor(list(range(20, 32)) + [63] * 4)
    out, dens = kref.attn_density_plain(q, k, v, q_pos, 32, want_density=True,
                                        form=form)
    mask = C.causal_window_mask(q_pos, torch.arange(S)) & \
        (torch.arange(S) < 32)[None, :]
    ref = C.gqa_attention(q, k, v, mask, want_density=True)
    assert out.shape == (1, 16, H, 16)
    if form == "served":
        assert torch.equal(out, ref.out)
        np.testing.assert_allclose(dens.numpy(), ref.key_density.numpy(),
                                   atol=1e-6, rtol=0)
    else:
        _close_bf16(ref.out, out)


# --------------------------------------------------------------------- #
# whole services
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy,quant", [
    ("llms", False), ("llms_nopipe", False), ("swap", False),
    ("lmk", False), ("llms", True)],
    ids=["llms", "llms_nopipe", "swap", "lmk", "quant_resident"])
def test_service_replay_matches_reference(policy, quant):
    """3 contexts x 9 calls of 12 + 4 tokens at a budget of 1.5 raw
    latent chunks, both packages under one injected restore profile, on
    slot caches (the family declares no paged pool), teacher-forced at
    near-ties (at most two): equal tokens, per-call bit plans (every
    chunk at >= 8 bits), evictions, disk restores, recompute/I-O splits
    and stats."""
    js, ts, cfg = services(name=NAME, policy=policy, quant_resident=quant,
                           budget=BUDGET)
    trace = _trace(cfg.vocab)
    forced = _force_ties(js, ts)
    with js, ts:
        assert not ts.paged
        rec_j, st_j = _replay(js, trace, 3, quant=quant)
        rec_t, st_t = _replay(ts, trace, 3, quant=quant)
    _assert_same(rec_j, rec_t)
    assert len(forced) <= 2, forced
    assert st_t == st_j
    assert all(len(r["tokens"]) == 4 for r in rec_t)
    assert all(b >= 8 for r in rec_t for b in r["bits"].values())
    assert any(r["evicted"] for r in rec_t)
    if policy == "lmk":
        assert not any(r["restored"] for r in rec_t)
    else:
        assert any(r["restored"] for r in rec_t)
    if policy == "llms":
        assert any(re for r in rec_t for _, re, _ in r["split"])
    if quant:
        assert any(r["quant_resident_chunks"] for r in rec_t)


def test_serve_replays_a_given_trace(tmp_path):
    """``launch.serve.serve(..., events=...)`` replays the given trace
    (the chip smoke's MLA phase passes the serve phase's calls) instead
    of synthesizing one: each event once, in order, with its prompt, on
    slot caches."""
    from repro_torch.launch import serve as tserve
    from repro_torch.trace.synth import TraceEvent
    _, _, _, _, tmodel, tparams = tiny_pair(NAME)
    rng = np.random.default_rng(3)
    events = [TraceEvent(time=float(i), ctx_id=i % 2,
                         prompt=rng.integers(1, 512, 20 + i).astype(np.int32),
                         ground_truth=np.zeros(0, np.int32), dataset="t")
              for i in range(4)]
    args = tserve.parse_args(["--device", "cpu", "--arch", NAME, "--reduced",
                              "--max-ctx", "256", "--max-new", "3",
                              "--swap-dir", str(tmp_path)])
    seen = []

    def on_start(svc, router):
        begin = svc.begin_call

        def begun(stub, request):
            seen.append((stub.ctx_id, len(request.prompt)))
            return begin(stub, request)
        svc.begin_call = begun

    stats = tserve.serve(tmodel, tparams, args, threaded=False,
                         on_start=on_start, verbose=False, events=events)
    assert stats["failed_calls"] == 0 and not stats["paged_pool"]
    assert [n for _, n in seen] == [20, 21, 22, 23]
    assert seen[0][0] == seen[2][0] != seen[1][0] == seen[3][0]


def test_router_and_serve_main_match_reference(capsys):
    """Both packages' routers over the reduced deepseek-v2-lite at
    ``decode_batch=2`` on one markov trace (slot caches: rounds decode
    their members one after another): equal completions, evictions and
    router counts.  Then ``launch.serve.main --device cpu --reduced
    --arch deepseek-v2-lite-16b`` serves its trace with no failed call
    and no paged pool."""
    import json
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
        assert ts.exe.decode_slots == 2 and not ts.exe.can_batch_decode
    assert log_t == log_j, _first_difference(log_j, log_t)
    assert _counts(st_t) == _counts(st_j) and sz_t == sz_j
    assert len(forced) <= 2, forced
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
