"""The port's slot engine and whole-state policies against the JAX package.

* ``DenseModel.recompute_pipelined`` (paper Fig. 8) against the
  reference's, jitted with a ``fetch`` that serves the same numpy
  arrays: window and mixed caches, with and without a window and sinks.
  Tolerances as tests/test_torch_models.py (bf16 level).
* The port's pipelined restore equals its I/O-then-recompute restore
  (``insert`` + ``extend_nod``) of the same chunks from the same cache.
  Tolerance: none.
* Every ``POLICIES`` entry served with ``paged_pool=False`` (and
  ``swap`` / ``lmk``, which turn the pool off) through both packages'
  ``LLMService`` under one injected restore profile: equal tokens,
  per-call bit plans, evictions, disk restores, recompute/I-O splits
  and memory accounting.  Tolerance: none.
* Slot ``quant_resident`` against the reference and against the
  ``force_dequant`` control; ``swap``'s ``(cid, -1)`` files across
  packages; the slot fault ladder; the router at ``decode_batch=2`` on
  slot caches with a preemption.

Every service runs the reduced smollm-360m with its head scaled 16x
(``_torch_parity.services``), whose greedy picks are far from ties on
these traces (ROADMAP.md, Queue 3).
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import (one_torch_thread, services, tiny_pair,  # noqa: F401
                           to_np, to_torch)
from repro.core import faults as jfaults
from repro.core.scheduler import ServiceRouter as JRouter
from repro.core.service import POLICIES
from repro.core.swap import DiskStore as JStore
from repro_torch.core import faults as tfaults
from repro_torch.core.restore import (LayerFeed, read_chunk_file,
                                      write_chunk_file)
from repro_torch.core.scheduler import ServiceRouter as TRouter
from repro_torch.core.swap import DiskStore as TStore

RAW_CHUNK = 2 * 4 * 16 * 2 * 16 * 2     # smollm reduced: k+v, L cs KV hd, bf16
# the budget of the reference's fault tests: chunks go to disk and back
BUDGET = 12_000
# one restore profile for both packages: a recompute costs 1 ms + 1 ms a
# chunk, a read 0.5 us a byte, so that restores of 2+ chunks split
PROFILE = dict(re_base=1e-3, re_per_chunk=1e-3, io_base=0.0,
               io_per_byte=5e-7)


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


# --------------------------------------------------------------------- #
# the model entry
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mixed", [False, True], ids=["window", "mixed"])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (24, 2)])
def test_recompute_pipelined_matches_reference(mixed, window, n_sinks):
    """Chunk 0 recomputed (a KV hole at 5, one pad row), chunk 1 and a
    pad chunk fed from ``fetch`` layer by layer, chunk 2 resident (int8
    segments in the mixed cache): hidden states and cache rows agree at
    bf16 level, the fed rows exactly, and both packages leave the same
    quant mask; ``fetch`` is called once per layer, in order."""
    from repro.kernels import ref as jref
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair("smollm-360m")
    L, KV, hd, S, pad = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim, 64, 63
    rng = np.random.default_rng(11 + mixed)
    layout = "mixed" if mixed else "window"
    jc = jmodel.init_cache(1, S, layout=layout)
    jc = dict(jc)
    for n in ("k", "v"):
        jc[n] = jnp.asarray(rng.standard_normal((L, 1, S, KV, hd)).astype(
            np.float32) * 0.5).astype(jnp.bfloat16)
        if mixed:
            codes, sc = jref.quantize_token_head_ref(jnp.asarray(
                rng.standard_normal((L, 1, S, KV, hd)).astype(np.float32)))
            jc[n + "_q"], jc[n + "_scale"] = codes, sc
    if mixed:
        qm = np.zeros((1, 1, S), bool)
        qm[..., 32:48] = True
        jc["quant_mask"] = jnp.asarray(qm)
    tc = {k: to_torch(np.asarray(v)) for k, v in jc.items()}
    tc["pos"] = torch.zeros((), dtype=torch.int64)
    if mixed:
        tc["quant_mask"] = torch.from_numpy(np.array(jc["quant_mask"]))

    miss = np.array([p for p in range(16) if p != 5] + [pad], np.int32)
    toks = rng.integers(1, jcfg.vocab, 16).astype(np.int32)
    toks[-1] = 0
    io_pos = np.concatenate([np.arange(16, 32), np.full(16, pad)]
                            ).astype(np.int32)
    fed = []
    for _ in range(L):
        d = {n: rng.standard_normal((32, KV, hd)).astype(np.float32)
             for n in ("k", "v")}
        for a in d.values():
            a[16:] = 0.0                         # the pad chunk
        fed.append(d)
    calls = []

    def fetch(layer):
        calls.append(int(layer))
        return fed[int(layer)]

    jfn = jax.jit(functools.partial(jmodel.recompute_pipelined, fetch=fetch,
                                    window=window, n_sinks=n_sinks))
    jout, jx, _ = jfn(jparams, jnp.asarray(toks)[None], jnp.asarray(miss),
                      jnp.asarray(io_pos), jc, jnp.int32(48))
    jax.block_until_ready(jout["k"])
    assert calls == list(range(L))
    calls.clear()
    tout, tx, td = tmodel.recompute_pipelined(
        tparams, torch.from_numpy(toks).long()[None],
        torch.from_numpy(miss).long(), torch.from_numpy(io_pos).long(), tc,
        48, fetch, window=window, n_sinks=n_sinks)
    assert calls == list(range(L)) and td is None
    assert tout is tc                                # in place
    _close_bf16(jx[:, :15], tx[:, :15])
    for n in ("k", "v"):
        a, b = np.asarray(jout[n]).astype(np.float32), to_np(tout[n])
        _close_bf16(a[:, :, :48], b[:, :, :48])
        np.testing.assert_array_equal(a[:, :, 16:32], b[:, :, 16:32])
        np.testing.assert_array_equal(a[:, :, 5], b[:, :, 5])   # the hole
    if mixed:
        np.testing.assert_array_equal(np.asarray(jout["quant_mask"]),
                                      tout["quant_mask"].numpy())
        assert tout["quant_mask"][0, 0, 32:48].all()


def _zero_rows(cache, positions):
    for n in ("k", "v"):
        cache[n][:, :, positions] = 0
    return cache


@pytest.mark.parametrize("quant", [False, True], ids=["window", "mixed"])
def test_pipelined_restore_equals_io_then_recompute(quant, tmp_path):
    """From one prefilled cache, chunks 0 (8-bit) and 3 (16-bit) come
    from chunk files and chunk 2 is recomputed: the layer-pipelined
    restore and the whole-file inserts followed by ``extend_nod`` give
    the same K/V bit for bit (and, in the mixed cache with chunk 1
    resident as int8 segments, the same quant mask)."""
    _, ts, cfg = services(port_only=True, paged_pool=False,
                          quant_resident=quant)
    with ts:
        exe, res = ts.exe, ts.res
        cs = exe.cs
        rng = np.random.default_rng(3)
        toks = rng.integers(1, cfg.vocab, 64).astype(np.int32)
        full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
        if quant:
            qc = res._make_payload(full, 1, 8, quant=True)
            exe.codec.scatter_quant(
                full, exe._t(exe.chunk_positions([1])),
                {n: torch.from_numpy(qc.data[n][0]) for n in ("k", "v")},
                {n: torch.from_numpy(qc.data[n][1]) for n in ("k", "v")})
        io_idx, re_idx = [0, 3], [2]
        paths = []
        for i, bits in zip(io_idx, (8, 16)):
            p = str(tmp_path / f"c{i}")
            write_chunk_file(p, res._make_payload(full, i, bits),
                             exe.n_layers)
            paths.append(p)
        restored = exe.chunk_positions(io_idx + re_idx)
        miss_b = exe.bucket_pad(exe.chunk_positions(re_idx), exe.pad_slot)
        toks_b = exe.bucket_pad(toks[exe.chunk_positions(re_idx)], 0)
        nio_b = next(x for x in exe.io_buckets if x >= len(io_idx))
        io_pos_b = np.concatenate(
            [exe.chunk_positions(io_idx),
             np.full((nio_b - len(io_idx)) * cs, exe.pad_slot, np.int32)])

        a = _zero_rows({k: v.clone() for k, v in full.items()}, restored)
        feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers, cs,
                         exe.leaf_dims, pad_chunks=nio_b - len(io_idx),
                         alloc=exe.host_alloc)
        _, h_a = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, a, 64)
        feed.close()
        assert exe.last_pipelined["wall_s"] > 0

        b = _zero_rows({k: v.clone() for k, v in full.items()}, restored)
        for i, p in zip(io_idx, paths):
            exe.codec.insert(b, i * cs, res._payload_blocks(
                read_chunk_file(p)))
        _, h_b, _ = exe.extend_nod(toks_b, miss_b, b, 64)
        assert torch.equal(h_a, h_b)
        for n in ("k", "v"):
            assert torch.equal(a[n][:, :, :64], b[n][:, :, :64]), n
            # the recomputed chunk is the prefill's up to bf16 level
            _close_bf16(full[n][:, :, 32:48], a[n][:, :, 32:48])
        if quant:
            assert torch.equal(a["quant_mask"], b["quant_mask"])
            assert a["quant_mask"][0, 0, 16:32].all()
            assert not a["quant_mask"][0, 0, :16].any()


def test_run_pipelined_closes_the_feed_on_failure(tmp_path):
    """A feed whose file fails mid-restore (a flipped byte inside the
    last layer's segment: the header still validates) stops the loop;
    ``run_pipelined`` closes the feed, raises, and is not left marked as
    running; a nested call is refused."""
    _, ts, cfg = services(port_only=True, paged_pool=False)
    with ts:
        exe, res = ts.exe, ts.res
        toks = np.arange(1, 33, dtype=np.int32)
        full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
        p = str(tmp_path / "c1")
        write_chunk_file(p, res._make_payload(full, 1, 4), exe.n_layers)
        with open(p, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            b = f.read(1)
            f.seek(-3, os.SEEK_END)
            f.write(bytes([b[0] ^ 0x40]))
        feed = LayerFeed([p], exe.codec.leaves, exe.n_layers, exe.cs,
                         exe.leaf_dims)
        with pytest.raises(RuntimeError, match="LayerFeed I/O failed"):
            exe.run_pipelined(feed, toks[:16], np.arange(16, dtype=np.int32),
                              exe.chunk_positions([1]), full, 32)
        assert feed._fut.done() and not exe._pipelining
        exe._pipelining = True
        with pytest.raises(RuntimeError, match="re-entrant"):
            exe.run_pipelined(feed, toks[:16], np.arange(16, dtype=np.int32),
                              exe.chunk_positions([1]), full, 32)
        exe._pipelining = False


# --------------------------------------------------------------------- #
# whole services
# --------------------------------------------------------------------- #
def _instrument(svc):
    """Per-call log of evicted keys, disk reads (chunk files, layer
    feeds and whole-state snapshots) and restore splits."""
    log = {"evicted": [], "restored": [], "split": []}
    res = svc.res
    evict, read_async = res.evict, res._read_chunk_async
    plan, whole_read = res._plan_restore, res.swapper.read
    read_sync = res._read_chunk

    def ev(key):
        log["evicted"].append(tuple(int(k) for k in key))
        return evict(key)

    def rd(key):
        log["restored"].append(tuple(int(k) for k in key))
        return read_async(key)

    def rs(key):                # after a layer feed: the payload's read
        log["restored"].append(tuple(int(k) for k in key))
        return read_sync(key)

    def pl(ctx, missing):
        re_idx, io_idx = plan(ctx, missing)
        log["split"].append((ctx.cid, list(map(int, re_idx)),
                             list(map(int, io_idx))))
        return re_idx, io_idx

    def wr(key, timeout=None):
        log["restored"].append(tuple(int(k) for k in key))
        return whole_read(key, timeout=timeout)

    res.evict, res._read_chunk_async, res._plan_restore = ev, rd, pl
    res._read_chunk = rs
    res.swapper.read = wr
    return log


def _trace(vocab, n_ctx=3, rounds=9, seed=7, length=12, max_new=4):
    rng = np.random.RandomState(seed)
    return [(r % n_ctx, rng.randint(1, vocab, size=length).tolist(), max_new)
            for r in range(rounds)]


def _replay(svc, trace, n_ctx, profile=True, quant=False):
    if profile:
        for k, v in PROFILE.items():
            setattr(svc.res.profile, k, v)
        svc.res.profiled = True
    log = _instrument(svc)
    stubs = [svc.newLLMCtx() for _ in range(n_ctx)]
    records = []
    for c, prompt, max_new in trace:
        for v in log.values():
            v.clear()
        _, toks = svc.callLLM(stubs[c], prompt, max_new)
        ctx = svc.contexts[stubs[c].ctx_id]
        rec = {"tokens": [int(t) for t in toks],
               "bits": {i: m.bits for i, m in sorted(ctx.chunks.items())},
               "evicted": sorted(log["evicted"]),
               "restored": sorted(log["restored"]),
               "split": list(log["split"]),
               "n_tokens": ctx.n_tokens,
               "mem_used": svc.records[-1]["mem_used"],
               "whole": ctx.whole is not None}
        if quant:
            st = svc.stats()
            rec.update(quant={i: m.quant for i, m in sorted(ctx.chunks.items())},
                       quant_resident_chunks=st["quant_resident_chunks"],
                       decode_ready_contexts=st["decode_ready_contexts"])
        records.append(rec)
    svc.swapper.flush(raise_errors=False)
    st = svc.stats()
    return records, {k: st[k] for k in (
        "calls", "paged_pool", "evict_dropped", "chunks_recovered_recompute",
        "degraded_entries", "decode_ready_contexts")}


def _assert_same(rec_j, rec_t):
    assert len(rec_j) == len(rec_t)
    for i, (a, b) in enumerate(zip(rec_j, rec_t)):
        assert a == b, f"call {i}: reference {a} != port {b}"


@pytest.mark.parametrize("policy", POLICIES)
def test_slot_policies_replay_matches_reference(policy):
    """The reference's ``test_policies_run_and_account`` trace (3
    contexts x 9 calls of 12 + 4 tokens) on slot caches at a budget of
    about 1.5 raw chunks, both packages under PROFILE."""
    js, ts, cfg = services(policy=policy, paged_pool=False, budget=BUDGET)
    trace = _trace(cfg.vocab)
    with js, ts:
        rec_j, st_j = _replay(js, trace, 3)
        rec_t, st_t = _replay(ts, trace, 3)
        used, budget = ts.mem.used, ts.mem.budget
    _assert_same(rec_j, rec_t)
    assert st_t == st_j
    assert not st_t["paged_pool"] and st_t["calls"] == 9
    assert all(len(r["tokens"]) == 4 for r in rec_t)
    assert used <= budget or policy == "lmk"
    assert any(r["evicted"] for r in rec_t)
    if policy == "lmk":                     # killed contexts recompute
        assert not any(r["restored"] for r in rec_t)
    elif policy != "llms_nocomp":           # (PROFILE recomputes 16-bit)
        assert any(r["restored"] for r in rec_t)
    if policy in ("swap", "lmk"):
        assert all(r["bits"] == {} for r in rec_t)
        assert any(r["whole"] for r in rec_t)
    splits = [s for r in rec_t for s in r["split"]]
    if policy in ("llms", "llms_nolife"):
        assert any(re and io for _, re, io in splits)   # Fig. 8 ran
    elif policy == "llms_nocomp":        # 16-bit reads cost more: recompute
        assert any(re for _, re, _ in splits)
    elif policy in ("swap", "lmk"):
        assert not splits
    else:                                # no pipeline: I/O only
        assert splits and all(not re for _, re, _ in splits)


def test_slot_unprofiled_split_matches_reference():
    """Without a profile the heaviest half of the missing chunks is
    recomputed, in both packages."""
    js, ts, cfg = services(policy="llms", paged_pool=False, budget=BUDGET)
    trace = _trace(cfg.vocab, seed=8)
    with js, ts:
        rec_j, st_j = _replay(js, trace, 3, profile=False)
        rec_t, st_t = _replay(ts, trace, 3, profile=False)
    _assert_same(rec_j, rec_t)
    assert any(re for r in rec_t for _, re, _ in r["split"])


@pytest.mark.parametrize("budget", [BUDGET, 30_000])
def test_slot_quant_resident_matches_reference(budget):
    """``quant_resident=True`` on slot caches: 8-bit chunks scatter their
    decode-grid codes into the mixed cache's int8 segments, 4/2-bit ones
    are re-gridded, decode attends through the mixed select.  Equal
    records (quant flags and stats included).  At the tight budget
    chunks go to disk and come back through the pipelined restore; at
    the looser one 8-bit chunks stay resident as int8."""
    js, ts, cfg = services(policy="llms", paged_pool=False,
                           quant_resident=True, budget=budget)
    trace = _trace(cfg.vocab, n_ctx=3, rounds=9, seed=5, length=14)
    with js, ts:
        rec_j, st_j = _replay(js, trace, 3, quant=True)
        rec_t, st_t = _replay(ts, trace, 3, quant=True)
    _assert_same(rec_j, rec_t)
    assert st_t == st_j
    assert any(b in (2, 4) for r in rec_t for b in r["bits"].values())
    if budget == BUDGET:
        assert any(re and io for r in rec_t for _, re, io in r["split"])
    else:
        assert any(r["quant_resident_chunks"] for r in rec_t)


def test_slot_quant_resident_tokens_equal_force_dequant():
    """Decoding over the int8 segments gives the tokens of the
    force_dequant control, which materializes the SAME payloads into the
    bf16 window (policy vllm_sq: every chunk 8-bit)."""
    def drive(force):
        _, ts, cfg = services(policy="vllm_sq", paged_pool=False,
                              quant_resident=True, port_only=True)
        ts.res.force_dequant = force
        rng = np.random.default_rng(5)
        prompts = [rng.integers(1, cfg.vocab, 18).tolist() for _ in range(3)]
        with ts:
            stubs = [ts.newLLMCtx() for _ in prompts]
            toks = [ts.callLLM(st, p[r:], 6)[1]
                    for r in range(2) for st, p in zip(stubs, prompts)]
            quant = [m.quant for c in ts.contexts.values()
                     for m in c.chunks.values()]
            return toks, quant, ts.stats()["quant_resident_chunks"]

    toks_q, quant_q, n_q = drive(False)
    toks_d, quant_d, n_d = drive(True)
    assert quant_q and all(quant_q) and quant_q == quant_d and n_q == n_d
    assert toks_q == toks_d


def test_parked_slot_caches_are_never_shared():
    """decode_batch=2 on slot caches: each parked context keeps its own
    cache tensors, the exact-reuse switch-in hands back that same cache,
    and an eviction (epoch change) makes the next switch-in rebuild,
    into the context's own static slot cache (zeroed in place, so its
    graphs' addresses hold)."""
    _, ts, cfg = services(policy="llms", paged_pool=False, decode_batch=2,
                          port_only=True)
    with ts:
        a, b = ts.newLLMCtx(), ts.newLLMCtx()
        ts.callLLM(a, [5, 6, 7], 2)
        ts.callLLM(b, [8, 9, 10], 2)
        ca, cb = ts._reuse[a.ctx_id][0], ts._reuse[b.ctx_id][0]
        assert all(ca[n].data_ptr() != cb[n].data_ptr() for n in ("k", "v"))
        from repro_torch.core.requests import GenerationRequest
        st = ts.begin_call(a, GenerationRequest(prompt=[3], max_new_tokens=1))
        assert st.cache is ca and a.ctx_id not in ts._reuse
        while ts.decode_step(st) is not None:
            pass
        ts.finish_call(st)
        ts.res.epoch += 1
        rebuilt, switch_in = [], ts.res.switch_in

        def logged(ctx, slot=None):
            rebuilt.append((ctx.cid, slot))
            return switch_in(ctx, slot)

        ts.res.switch_in = logged
        st = ts.begin_call(b, GenerationRequest(prompt=[4], max_new_tokens=1))
        assert rebuilt == [(b.ctx_id, st.slot)]
        assert st.cache is cb and ts.exe.slot_of(cb) == st.slot
        assert all(st.cache[n].data_ptr() != ca[n].data_ptr()
                   for n in ("k", "v"))
        ts.finish_call(st)


def test_swap_whole_state_files_cross_read():
    """Under ``swap`` an evicted context's ``(cid, -1)`` snapshot file
    written by either package is read by the other's ``DiskStore``:
    the same fp16/fp32 arrays, byte for byte; and the port's snapshot
    layer 0 equals the reference's (deeper layers differ at bf16 level,
    ROADMAP.md Queue 3)."""
    js, ts, cfg = services(policy="swap", paged_pool=False, budget=BUDGET)
    trace = _trace(cfg.vocab, rounds=6)
    with js, ts:
        _replay(js, trace, 3)
        _replay(ts, trace, 3)
        snaps = {}
        for name, own, other in (("jax", js.store, TStore(js.store.root)),
                                 ("torch", ts.store, JStore(ts.store.root))):
            names = sorted(f for f in os.listdir(own.root)
                           if f.endswith("_chunk-1.pkl"))
            assert names, name
            for f in names:
                cid = int(f[3:f.index("_")])
                mine, theirs = own.read((cid, -1)), other.read((cid, -1))
                assert mine.keys() == theirs.keys() == {"k", "v"}
                for n in mine:
                    assert mine[n].dtype == theirs[n].dtype == np.float16
                    assert mine[n].tobytes() == theirs[n].tobytes()
                snaps[name, cid] = mine
    both = [cid for (pkg, cid) in snaps if pkg == "jax"
            and ("torch", cid) in snaps]
    assert both
    F0 = snaps["jax", both[0]]["k"].shape[1] // 4       # layer 0 of 4
    for cid in both:
        j, t = snaps["jax", cid], snaps["torch", cid]
        if j["k"].shape == t["k"].shape:
            np.testing.assert_array_equal(j["k"][:, :F0], t["k"][:, :F0])


# --------------------------------------------------------------------- #
# the fault ladder on slot caches (tests/test_faults.py, paged=False)
# --------------------------------------------------------------------- #
FAULTS = {"jax": jfaults, "torch": tfaults}
_COUNTERS = ("faults_injected_total", "chunks_corrupt_detected",
             "chunks_recovered_recompute", "io_errors_detected",
             "recover_failed", "degraded_entries", "degraded_exits",
             "evict_dropped")


@pytest.fixture
def clean_faults():
    for f in FAULTS.values():
        f.clear_faults()
    yield
    for f in FAULTS.values():
        f.clear_faults()
        f.set_disk_full(False)


def _svc(pkg, policy, **kw):
    js, ts, cfg = services(policy=policy, paged_pool=False,
                           budget=BUDGET,
                           port_only=pkg == "torch", **kw)
    if js is not None:
        ts.close()
        return js, cfg
    return ts, cfg


def _drive(svc, cfg, rounds=9, disk_full=None, faults=None):
    svc.res.profiled = False
    stubs = [svc.newLLMCtx() for _ in range(3)]
    outs = []
    for r, (c, prompt, max_new) in enumerate(_trace(cfg.vocab,
                                                    rounds=rounds)):
        if disk_full is not None and r in disk_full:
            faults.set_disk_full(disk_full[r])
        outs.append(svc.callLLM(stubs[c], prompt, max_new)[1])
    svc.swapper.flush(raise_errors=False)
    st = svc.stats()
    return outs, {k: st[k] for k in _COUNTERS}


def _both(run):
    out = {pkg: run(pkg) for pkg in FAULTS}
    assert out["torch"] == out["jax"], out
    return out["torch"]


def test_slot_corrupt_chunk_recovery_token_identity(clean_faults):
    """Bit-flipped chunk files (``bit_flip`` on disk.write, rate 0.25,
    seed 2024) are caught by CRC and recomputed; under the 16-bit policy
    the tokens equal the fault-free run's, in both packages."""
    def run(pkg):
        f = FAULTS[pkg]
        svc, cfg = _svc(pkg, "llms_nocomp")
        with svc:
            clean, _ = _drive(svc, cfg)
        f.install_faults([f.FaultSpec(kind="bit_flip", sites=("disk.write",),
                                      rate=0.25)], seed=2024)
        svc2, _ = _svc(pkg, "llms_nocomp")
        try:
            faulty, st = _drive(svc2, cfg)
        finally:
            f.clear_faults()
            svc2.close()
        return clean, faulty, st

    clean, faulty, st = _both(run)
    assert st["faults_injected_total"] > 0, "no faults drawn: dead test"
    assert st["chunks_corrupt_detected"] > 0
    assert st["chunks_recovered_recompute"] > 0
    assert st["recover_failed"] == 0
    assert faulty == clean


def test_slot_flipped_layer_segment_falls_back(clean_faults):
    """A byte flipped inside the last layer's segment of the first
    pipelined restore's first I/O chunk passes header validation and
    stops the feed mid-restore, after the port has written the earlier
    layers in place.  Both packages fall back to whole-file reads, find
    the chunk corrupt, recompute it, and give the same tokens and
    counters (one mid-feed I/O error, one corrupt chunk, one recovered)
    — and, under the 16-bit policy, the fault-free run's tokens."""
    def run(pkg):
        out = []
        for flip in (False, True):
            svc, cfg = _svc(pkg, "llms_nocomp")
            res = svc.res
            orig, hits = res._restore_pipelined, []

            def pipelined(ctx, cache, re_idx, io_idx):
                if flip and not hits and io_idx:
                    hits.append(io_idx[0])
                    path = res.store._path((ctx.cid, io_idx[0]))
                    with open(path, "r+b") as f:
                        f.seek(-5, os.SEEK_END)
                        b = f.read(1)
                        f.seek(-5, os.SEEK_END)
                        f.write(bytes([b[0] ^ 0x10]))
                return orig(ctx, cache, re_idx, io_idx)

            res._restore_pipelined = pipelined
            with svc:
                toks, st = _drive(svc, cfg, rounds=12)
            out.append((toks, st, hits))
        return out

    (clean, st0, _), (faulty, st, hits) = _both(run)
    assert hits, "no pipelined restore with an I/O chunk: dead test"
    assert st["io_errors_detected"] == 1 and st["chunks_corrupt_detected"] == 1
    assert st["chunks_recovered_recompute"] == 1 and st["recover_failed"] == 0
    assert faulty == clean


def test_slot_whole_state_enospc(clean_faults):
    """``swap`` with the disk full over calls 3-6: an eviction cannot
    write its ``(cid, -1)`` snapshot, so it enters degraded mode and
    drops it; the context's next switch-in recomputes its whole text
    (LMK-style).  Both packages give the same tokens and counters."""
    def run(pkg):
        svc, cfg = _svc(pkg, "swap")
        with svc:
            return _drive(svc, cfg, disk_full={3: True, 7: False},
                          faults=FAULTS[pkg])

    toks, st = _both(run)
    assert st["evict_dropped"] > 0 and st["degraded_entries"] == 1
    assert all(len(t) == 4 for t in toks)


# --------------------------------------------------------------------- #
# the router on slot caches
# --------------------------------------------------------------------- #
def _router_episode(svc, router_cls, cfg):
    """Inline: two background generations fill both decode slots, a
    foreground call arrives after their second round and, at the slice
    boundary, preempts one of them (suspend + resume through the slot
    engine); then three more calls on the same contexts.  -> completion
    and eviction log, preemptions, tokens per stream."""
    log = []
    evict = svc.res.evict
    svc.res.evict = lambda key: (log.append(("evict", tuple(map(int, key)))),
                                 evict(key))[1]
    rng = np.random.RandomState(23)
    ps = [rng.randint(1, cfg.vocab, 10).tolist() for _ in range(6)]
    with router_cls(svc, predict=False, slice_steps=2) as router:
        router.on_complete = lambda job, cancelled: log.append(
            ("done", job["stub"].ctx_id, tuple(job["stream"].tokens),
             job["stream"].n_preempts))
        bg = router.register_app("agent", "background")
        fg = router.register_app("chat", "foreground")
        bg_stubs = [bg.new_ctx(), bg.new_ctx()]
        fg_stub = fg.new_ctx()
        bgs = [bg.stream(s, p, max_new_tokens=8)
               for s, p in zip(bg_stubs, ps[:2])]
        fgs, rounds = [], []

        def arrive(live):
            rounds.append(len(live))
            if len(rounds) == 2:
                fgs.append(fg.stream(fg_stub, ps[2], max_new_tokens=4))

        router.on_round = arrive
        router.drain()
        router.on_round = None
        more = [bg.stream(bg_stubs[0], ps[3], max_new_tokens=4),
                fg.stream(fg_stub, ps[4], max_new_tokens=4),
                bg.stream(bg_stubs[1], ps[5], max_new_tokens=4)]
        router.drain()
        preempts = router.preemptions
    return log, preempts, [len(s.tokens) for s in bgs + fgs + more]


def test_slot_router_preemption_matches_reference():
    """decode_batch=2 on slot caches (each round steps its members one
    after another): the same completions, preemptions and evictions as
    the reference."""
    js, ts, cfg = services(policy="llms", paged_pool=False, decode_batch=2,
                           budget=12_000)
    with js, ts:
        out_j = _router_episode(js, JRouter, cfg)
        out_t = _router_episode(ts, TRouter, cfg)
    assert out_t == out_j
    log, preempts, lens = out_t
    assert preempts >= 1 and any(e[0] == "done" and e[3] for e in log)
    assert lens == [8, 8, 4, 4, 4, 4]


@pytest.mark.parametrize("kw", [dict(paged_pool=False), dict(policy="swap"),
                                dict(policy="lmk")],
                         ids=["slot", "swap", "lmk"])
def test_loadgen_build_service_passes_policy_and_engine(kw):
    """``loadgen.build_service`` hands the spec's policy and engine to
    the service unchanged, as the reference's does: the same policy
    flags, ``paged_pool`` and engine in both packages."""
    from _torch_parity import scaled_head_pair
    from repro import loadgen as jloadgen
    from repro_torch import loadgen as tloadgen
    _, jmodel, jparams, _, tmodel, tparams = scaled_head_pair("smollm-360m",
                                                              16.0)
    out = []
    for lg, model, params, dev in ((jloadgen, jmodel, jparams, None),
                                   (tloadgen, tmodel, tparams, "cpu")):
        spec = lg.get_scenario("smoke_ci", profile=False, **kw)
        svc = (lg.build_service(spec, model, params) if dev is None
               else lg.build_service(spec, model, params, device=dev))
        with svc:
            c = svc.cfg
            out.append((c.policy, c.paged_pool, c.chunked, c.use_pipeline,
                        c.use_disk, bool(svc.paged)))
    assert out[1] == out[0]
    if "policy" in kw:
        assert out[1][0] == kw["policy"]
    assert not out[1][1] and not out[1][5]
