"""Port's serving path vs the JAX package's, on the reduced llama2-7b.

* ``ChunkCodec`` payloads (8/4/2-bit) and 16-bit payload encodings are
  byte-equal to the reference's for the same blocks.  Tolerance: none.
* A chunk file written by one package is read by the other, and both
  write the same bytes for the same payload.  Tolerance: none.
* One small trace replayed through both ``LLMService``s (policy llms,
  paged pool, a budget tight enough that compression, AoT swap-out,
  LCTRU eviction and disk restores all fire): equal tokens and equal
  per-call records (bits per chunk, evicted keys, disk-restored keys).
  Tolerance: none on tokens and records.  The model numerics differ at
  bf16 level (tests/test_torch_models.py), and the random-init logits
  are nearly flat, so a greedy argmax between two near-tied logits
  could flip: both packages get the SAME converted weights with the
  head scaled by ``HEAD_SCALE``, which spreads the logits so the top
  two are far apart relative to the bf16-level difference.
"""
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import tiny_pair, to_torch
from repro.core import chunks as jchunks
from repro.core import restore as jrestore
from repro.core.service import LLMSConfig as JConfig
from repro.core.service import LLMService as JService
from repro_torch.core import chunks as tchunks
from repro_torch.core import restore as trestore
from repro_torch.core.pipeline import PipelineProfile
from repro_torch.core.service import LLMSConfig as TConfig
from repro_torch.core.service import LLMService as TService
from repro_torch.models.convert import params_from_jax

HEAD_SCALE = 16.0


def _blocks(F=256, T=16, seed=0):
    rng = np.random.default_rng(seed)
    out_j, out_t = {}, {}
    for n in ("k", "v"):
        x = jnp.asarray(rng.standard_normal((T, F)).astype(np.float32)
                        ).astype(jnp.bfloat16)
        out_j[n] = x
        out_t[n] = to_torch(np.asarray(x))
    return out_j, out_t


def _assert_payload_equal(a, b):
    assert (a.bits, a.n_tokens) == (b.bits, b.n_tokens)
    assert a.shapes == b.shapes
    assert a.data.keys() == b.data.keys()
    for n in a.data:
        for x, y in zip(a.data[n], b.data[n]):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_codec_payloads_byte_equal(bits):
    bj, bt = _blocks(seed=bits)
    pj = jchunks.ChunkCodec(("k", "v"), 16).compress_blocks(bj, bits)
    pt = tchunks.ChunkCodec(("k", "v"), 16, "cpu").compress_blocks(bt, bits)
    _assert_payload_equal(pj, pt)
    dj = jchunks.ChunkCodec(("k", "v"), 16).decompress(pj)
    dt = tchunks.ChunkCodec(("k", "v"), 16, "cpu").decompress(pt)
    for n in dj:
        np.testing.assert_array_equal(np.asarray(dj[n]).view(np.int16),
                                      dt[n].view(torch.int16).numpy())


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_quantize_leaves_cpu_matches_quantize_ref(bits, dtype):
    """On the CPU, ``ops.chunk_quantize_leaves`` gives the bytes of a
    loop of ``quantize_ref``, as views of one buffer (the chunk's one
    copy to the host)."""
    from repro_torch.kernels import chunk_quant
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(bits)
    xs = [torch.from_numpy((rng.standard_normal((16, F)) * 3)
                           .astype(np.float32)).to(getattr(torch, dtype))
          for F in (1024, 384, 100)]
    before = chunk_quant.quantize.launches
    buf, outs = tops.chunk_quantize_leaves(xs, bits)
    assert chunk_quant.quantize.launches == before
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    for x, (p, s) in zip(xs, outs):
        rp, rs = tref.quantize_ref(x, bits)
        assert p.dtype == torch.int8 and s.dtype == torch.float32
        assert p.numpy().tobytes() == rp.numpy().tobytes()
        assert s.numpy().tobytes() == rs.numpy().tobytes()
        assert lo <= p.data_ptr() and s.data_ptr() + 4 * s.numel() <= hi


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_codec_multi_leaf_payloads_byte_equal(bits):
    """``ChunkCodec.compress_blocks`` quantizes a chunk's leaves together
    (one launch and one host copy on the card) and its payloads stay
    byte-equal to the reference's, leaves of different F included."""
    rng = np.random.default_rng(10 + bits)
    bj, bt = {}, {}
    for n, F in (("k", 384), ("v", 100), ("w", 256)):
        x = jnp.asarray(rng.standard_normal((16, F)).astype(np.float32)
                        ).astype(jnp.bfloat16)
        bj[n], bt[n] = x, to_torch(np.asarray(x))
    pj = jchunks.ChunkCodec(("k", "v", "w"), 16).compress_blocks(bj, bits)
    pt = tchunks.ChunkCodec(("k", "v", "w"), 16, "cpu").compress_blocks(
        bt, bits)
    _assert_payload_equal(pj, pt)
    assert pt.nbytes == pj.nbytes


def test_codec_extract_insert_match_reference():
    """Canonical (T, F) views of a window cache agree bit for bit with
    the reference's, and insert writes them back where extract read."""
    rng = np.random.default_rng(3)
    shape = (4, 1, 64, 4, 16)                    # (L, B, S, KV, hd)
    cache32 = {n: rng.standard_normal(shape).astype(np.float32)
               for n in ("k", "v")}
    cj = {n: jnp.asarray(a).astype(jnp.bfloat16) for n, a in cache32.items()}
    ct = {n: to_torch(np.asarray(a)) for n, a in cj.items()}
    jc = jchunks.ChunkCodec(("k", "v"), 16)
    tc = tchunks.ChunkCodec(("k", "v"), 16, "cpu")
    bj, bt = jc.extract(cj, 16, 32), tc.extract(ct, 16, 32)
    for n in bj:
        np.testing.assert_array_equal(np.asarray(bj[n]).view(np.int16),
                                      bt[n].view(torch.int16).numpy())
    zero = {n: torch.zeros_like(t) for n, t in ct.items()}
    tc.insert(zero, 16, bt)
    for n in ct:
        assert torch.equal(zero[n][:, :, 16:32], ct[n][:, :, 16:32])
        assert not zero[n][:, :, :16].any() and not zero[n][:, :, 32:].any()
    pt = tc.compress_blocks(bt, 4)
    assert tc.raw_chunk_bytes(pt) == jc.raw_chunk_bytes(
        jc.compress_blocks(bj, 4)) == 2 * 16 * 256 * 2
    assert tchunks.chunk_ranges(40, 16) == jchunks.chunk_ranges(40, 16)


def _services(budget, max_ctx=64, swap_dirs=None, **extra):
    jcfg, jmodel, jparams, tcfg, tmodel, _ = tiny_pair()
    jparams = dict(jparams)
    jparams["head"] = (jparams["head"].astype(jnp.float32) * HEAD_SCALE
                       ).astype(jnp.bfloat16)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    dirs = swap_dirs or (tempfile.mkdtemp(), tempfile.mkdtemp())
    kw = dict(policy="llms", paged_pool=True, decode_batch=1,
              max_ctx_len=max_ctx, chunk_tokens=16, memory_budget=budget,
              **extra)
    js = JService(jmodel, jparams, JConfig(swap_dir=dirs[0], **kw))
    ts = TService(tmodel, tparams, TConfig(swap_dir=dirs[1], **kw),
                  device="cpu")
    return js, ts


def test_16bit_payload_encoding_byte_equal():
    """bf16 blocks -> fp16 numpy payloads with identical bytes, and back
    to identical bf16 blocks."""
    js, ts = _services(1 << 20)
    with js, ts:
        bj, bt = _blocks(seed=16)
        pj = js.res._encode_blocks(bj, 16, quant=False)
        pt = ts.res._encode_blocks(bt, 16)
        _assert_payload_equal(pj, pt)
        rj, rt = js.res._payload_blocks(pj), ts.res._payload_blocks(pt)
        for n in rj:
            np.testing.assert_array_equal(np.asarray(rj[n]).view(np.int16),
                                          rt[n].view(torch.int16).numpy())


@pytest.mark.parametrize("bits", [16, 8, 4, 2])
def test_chunk_files_cross_read(bits, tmp_path):
    bj, bt = _blocks(F=4 * 256, seed=bits + 1)
    js, ts = _services(1 << 20)
    with js, ts:
        pj = js.res._encode_blocks(bj, bits, quant=False)
        pt = ts.res._encode_blocks(bt, bits)
    fj, ft = str(tmp_path / "j.chunk"), str(tmp_path / "t.chunk")
    jrestore.write_chunk_file(fj, pj, 4)
    trestore.write_chunk_file(ft, pt, 4)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    _assert_payload_equal(pj, trestore.read_chunk_file(fj))
    _assert_payload_equal(pt, jrestore.read_chunk_file(ft))


# --------------------------------------------------------------------- #
# end-to-end replay through both services
# --------------------------------------------------------------------- #
def _instrument(svc):
    """Log evicted keys and disk-restored keys per call."""
    log = {"evicted": [], "restored": []}
    res = svc.res
    evict, read_async = res.evict, res._read_chunk_async

    def ev(key):
        log["evicted"].append(tuple(key))
        return evict(key)

    def rd(key):
        log["restored"].append(tuple(key))
        return read_async(key)

    res.evict, res._read_chunk_async = ev, rd
    return log


def _replay(svc, trace, n_ctx, quant=False):
    log = _instrument(svc)
    stubs = [svc.newLLMCtx() for _ in range(n_ctx)]
    records = []
    for c, prompt, max_new in trace:
        log["evicted"].clear()
        log["restored"].clear()
        _, toks = svc.callLLM(stubs[c], prompt, max_new)
        ctx = svc.contexts[stubs[c].ctx_id]
        records.append({
            "tokens": [int(t) for t in toks],
            "bits": {i: m.bits for i, m in sorted(ctx.chunks.items())},
            "evicted": sorted(log["evicted"]),
            "restored": sorted(log["restored"]),
            "n_tokens": ctx.n_tokens,
        })
        if quant:
            stats = svc.stats()
            records[-1].update(
                quant={i: m.quant for i, m in sorted(ctx.chunks.items())},
                quant_resident_chunks=stats["quant_resident_chunks"],
                decode_ready_contexts=stats["decode_ready_contexts"],
                pages8_used=stats["pool_pages8_used"])
    return records


def _trace(n_ctx=4, rounds=3, seed=5, vocab=512):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        for c in range(n_ctx):
            n = int(rng.integers(10, 18))
            out.append((c, rng.integers(1, vocab, n).tolist(), 5))
    return out


@pytest.mark.parametrize("n_ctx,rounds,budget_chunks", [(4, 3, 5),
                                                       (2, 5, 2)])
def test_llmservice_replay_matches_reference(n_ctx, rounds, budget_chunks):
    """4 contexts x 3 rounds under a budget of ~2 contexts' raw KV; and
    2 contexts x 5 rounds, which overflow the 64-token window and take
    the condense path."""
    raw_chunk = 2 * 4 * 4 * 16 * 16 * 2          # k+v, L*KV*hd*cs bf16
    js, ts = _services(budget=budget_chunks * raw_chunk)
    trace = _trace(n_ctx, rounds)
    with js, ts:
        rec_j = _replay(js, trace, n_ctx)
        rec_t = _replay(ts, trace, n_ctx)
        stats_t = ts.stats()
    for i, (a, b) in enumerate(zip(rec_j, rec_t)):
        assert a == b, f"call {i}: reference {a} != port {b}"
    # the trace really exercised the tiers
    assert any(b < 16 for r in rec_t for b in r["bits"].values())
    assert any(r["evicted"] for r in rec_t)
    assert any(r["restored"] for r in rec_t)
    assert stats_t["pool_page_faults"] > 0
    if rounds == 5:      # the window overflowed: tokens restart low
        assert any(b["n_tokens"] < a["n_tokens"]
                   for a, b in zip(rec_t, rec_t[n_ctx:]))


def test_profile_pipeline_fits_both_costs():
    """Installation-time profiling (paper §3.3.i) runs on the port:
    recompute timed through ``extend_nod`` on a fresh cache, chunk-file
    reads timed on probe files that it removes again."""
    _, ts = _services(1 << 20)
    with ts:
        ts.profile_pipeline()
        fitted = [getattr(ts.res.profile, k) for k in
                  ("re_base", "re_per_chunk", "io_base", "io_per_byte")]
        default = [getattr(PipelineProfile(), k) for k in
                   ("re_base", "re_per_chunk", "io_base", "io_per_byte")]
        assert ts.res.profiled
        assert np.all(np.isfinite(fitted)) and fitted != default
        assert not [f for f in os.listdir(ts.store.root) if "probe" in f]


def test_port_reads_reference_swap_files_after_replay():
    """The chunk files the reference service swapped out are readable by
    the port's reader, payload for payload."""
    js, _ = _services(budget=30_000)
    with js:
        _replay(js, _trace(n_ctx=2, rounds=2), 2)
        js.swapper.flush()
        names = [f for f in os.listdir(js.store.root) if f.startswith("ctx") and f.endswith(".pkl")]
        assert names
        for f in names:
            p = os.path.join(js.store.root, f)
            _assert_payload_equal(jrestore.read_chunk_file(p),
                                  trestore.read_chunk_file(p))


# --------------------------------------------------------------------- #
# quant-resident decode (int8 QUANT pages attended in place)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_ctx,rounds,budget_chunks", [(4, 3, 5),
                                                       (3, 3, 3)])
def test_quant_resident_replay_matches_reference(n_ctx, rounds,
                                                 budget_chunks):
    """The same replay with ``quant_resident=True`` in both services:
    8-bit chunks become decode-grid payloads admitted into QUANT pages,
    4/2-bit chunks are re-gridded, decode attends the mixed cache.
    Equal tokens and per-call records (bits, quant flags, the
    ``quant_resident_chunks`` and ``decode_ready_contexts`` stats, QUANT
    pages in use, evicted and disk-restored keys).  Tolerance: none."""
    raw_chunk = 2 * 4 * 4 * 16 * 16 * 2
    js, ts = _services(budget=budget_chunks * raw_chunk, quant_resident=True)
    trace = _trace(n_ctx, rounds)
    with js, ts:
        rec_j = _replay(js, trace, n_ctx, quant=True)
        rec_t = _replay(ts, trace, n_ctx, quant=True)
    for i, (a, b) in enumerate(zip(rec_j, rec_t)):
        assert a == b, f"call {i}: reference {a} != port {b}"
    assert any(r["quant_resident_chunks"] for r in rec_t)
    assert any(r["pages8_used"] for r in rec_t)
    assert any(r["restored"] for r in rec_t)
    assert any(b in (2, 4) for r in rec_t for b in r["bits"].values())


def test_quant_resident_tokens_equal_force_dequant():
    """Token identity of the tier (the reference's
    tests/test_quant_resident.py contract): decoding over int8 QUANT
    pages through the fused select gives exactly the tokens of the
    force_dequant control, which materializes the SAME payloads into
    bf16 pages.  Policy vllm_sq makes every chunk 8-bit."""
    _, _, _, tcfg, tmodel, tparams = tiny_pair()
    kw = dict(policy="vllm_sq", paged_pool=True, decode_batch=1,
              max_ctx_len=64, chunk_tokens=16, memory_budget=10_000_000,
              quant_resident=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tcfg.vocab, 18).tolist() for _ in range(3)]

    def drive(force):
        svc = TService(tmodel, tparams,
                       TConfig(swap_dir=tempfile.mkdtemp(), **kw),
                       device="cpu")
        svc.res.force_dequant = force
        with svc:
            stubs = [svc.newLLMCtx() for _ in prompts]
            toks = [svc.callLLM(st, p[r:], 6)[1]
                    for r in range(2) for st, p in zip(stubs, prompts)]
            quant = [m.quant for c in svc.contexts.values()
                     for m in c.chunks.values()]
            return toks, quant, svc.stats()

    toks_q, quant_q, st_q = drive(False)
    toks_d, quant_d, st_d = drive(True)
    assert quant_q and all(quant_q) and quant_q == quant_d
    assert st_q["pool_pages8_used"] > 0 and st_d["pool_pages8_used"] == 0
    assert toks_q == toks_d


def test_token_head_chunk_files_cross_read(tmp_path):
    """A decode-grid (``token_head``) chunk file written by one package
    is read by the other, payload for payload, and both write the same
    bytes for the same blocks.  Tolerance: none."""
    bj, bt = _blocks(F=4 * 4 * 16, seed=21)
    js, ts = _services(1 << 20, quant_resident=True)
    with js, ts:
        pj = js.res._encode_blocks(bj, 8, quant=True)
        pt = ts.res._encode_blocks(bt, 8, quant=True)
    assert isinstance(pt, tchunks.QuantResidentChunk)
    fj, ft = str(tmp_path / "j.chunk"), str(tmp_path / "t.chunk")
    jrestore.write_chunk_file(fj, pj, 4)
    trestore.write_chunk_file(ft, pt, 4)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    rj, rt = trestore.read_chunk_file(fj), jrestore.read_chunk_file(ft)
    assert isinstance(rj, tchunks.QuantResidentChunk)
    assert isinstance(rt, jchunks.QuantResidentChunk)
    _assert_payload_equal(pj, rj)
    _assert_payload_equal(pt, rt)


def test_pagepool_quant_rows_alloc8_and_free_chunk():
    """The pool's QUANT bookkeeping: ``alloc8`` marks the chunk QUANT in
    the table, ``rows`` returns its int8 page row and mask (None rows
    outside quant-resident mode), ``free_chunk`` returns the page."""
    _, ts = _services(1 << 20, quant_resident=True)
    with ts:
        pool = ts.res.pool
        free8 = len(pool._free8)
        page = pool.alloc8(7, 1)
        p16 = pool.alloc16(7, 0)
        pt16, pt8, qmask = pool.rows([7, 8])
        assert pt8[0, 1] == page and pt16[0, 0] == p16 and pt16[0, 1] == 0
        assert qmask.tolist()[0][:3] == [False, True, False]
        assert not qmask[1].any() and not pt8[1].any()
        assert pool.stats()["pool_pages8_used"] == 1
        pool.free_chunk(7, 1)
        assert len(pool._free8) == free8 and pool.kind(7, 1) == 0
        assert not pool.rows([7])[2].any()
    _, plain = _services(1 << 20)
    with plain:
        assert plain.res.pool.rows([0])[1:] == (None, None)
