"""The Fig.-8 pipelined restore as a slot entry of the compile layer
(``ModelExecutor.run_pipelined`` through ``core/graphs.py``) on the CPU,
where the graph's body runs eagerly on the slot's own buffers and each
layer's gate is the plain one (``kernels/ref.py::feed_gate_plain``),
waiting on the host for the feed's flag word as the card's kernel waits
on the device.

* The reduced llama2-7b and ``bench_model``'s size, bf16 window and
  mixed (quant-resident) caches, on a decode slot and the scratch slot,
  over a spread of (token bucket, I/O chunk bucket) pairs: the restore
  equals the restore as it ran before the compile layer (the model's
  ``recompute_pipelined`` on a private copy with a ``fetch`` that hands
  it the feed's arrays) bit for bit, every leaf, the quant mask and the
  hidden rows; and the reference's jitted ``recompute_pipelined`` on the
  same state and rows within ``test_torch_slot.py``'s tolerances
  (hidden rows and K/V 2% of the largest value, the fed rows and the
  quant mask exactly).
* The feed with a sink publishes every layer at its generation, in
  order; a flipped byte in one layer's segment publishes the negative
  generation from that layer on, and the restore raises ``RuntimeError``
  from the feed's error with the quant mask as it was; a feed that never
  publishes raises ``SwapTimeoutError`` within its deadline, and the
  next restore runs; the feed's thread (and a relay's) call nothing of
  torch.
"""
import dataclasses
import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np  # noqa: F401
from repro_torch.core import restore
from repro_torch.core.chunks import CompressedChunk
from repro_torch.core.executor import ModelExecutor as TExecutor
from repro_torch.core.faults import ChunkCorruptError, SwapTimeoutError
from repro_torch.core.restore import LayerFeed, write_chunk_file
from repro_torch.core.service import LLMSConfig as TConfig
from test_torch_graphs import _models as _bench_models
from test_torch_slot_graphs import _assert_same_cache, _copy, _load, _state

CS, MAX_CTX, N = 16, 64, 64
CASES = [("llama2-7b", False), ("llama2-7b", True), ("bench", False),
         ("bench", True)]
# (slot: "decode" slot 0 or "scratch", recomputed chunks, I/O chunks and
# their bits): pairs (16, 4), (32, 1), (32, 2) and (64, 1)
RESTORES = [("decode", [2], [(0, 8), (1, 4), (3, 16)]),
            ("decode", [0, 3], [(1, 8)]),
            ("decode", [1, 2], [(0, 4), (3, 8)]),
            ("scratch", [0, 1, 2, 3], [])]
_EXES = {}


def _executor(name, quant):
    """-> (torch executor with its slots made, jax model, jax params)."""
    if (name, quant) not in _EXES:
        if name == "bench":
            jmodel, jparams, tmodel, tparams = _bench_models("bench")
        else:
            _, jmodel, jparams, _, tmodel, tparams = tiny_pair(name)
        cfg = TConfig(policy="llms", paged_pool=False, decode_batch=1,
                      max_ctx_len=MAX_CTX, chunk_tokens=CS,
                      quant_resident=quant)
        exe = TExecutor(tmodel, tparams, cfg, "cpu")
        exe.init_slots()
        _EXES[name, quant] = (exe, jmodel, jparams)
    return _EXES[name, quant]


def _chunk_file(path, exe, bits, seed):
    """A chunk file of random codes at ``bits`` over every layer."""
    rng = np.random.default_rng(seed)
    L, (KV, hd) = exe.n_layers, exe.leaf_dims["k"]
    F = L * KV * hd
    data = {}
    for n in exe.codec.leaves:
        if bits == 16:
            packed = (rng.standard_normal((CS, F)) * 0.5).astype(np.float16)
        else:
            packed = rng.integers(-128, 128, (CS * bits // 8, F),
                                  dtype=np.int16).astype(np.int8)
        data[n] = (packed, (rng.random(F) * 0.05 + 0.01).astype(np.float32))
    write_chunk_file(path, CompressedChunk(
        bits=bits, n_tokens=CS, data=data,
        shapes={n: (L, 1, CS, KV, hd) for n in data}), L)
    return path


def _plan(exe, re_idx, io):
    """-> (tokens, miss positions, I/O positions, pad chunks), bucket-
    padded as ``ResidencyEngine._restore_pipelined`` pads them."""
    nio = next(x for x in exe.io_buckets if x >= max(len(io), 1))
    io_pos = np.concatenate(
        [exe.chunk_positions([i for i, _ in io]),
         np.full((nio - len(io)) * CS, exe.pad_slot, np.int32)])
    miss = exe.chunk_positions(re_idx)
    toks = np.random.default_rng(len(re_idx)).integers(
        1, exe.model.cfg.vocab, len(miss)).astype(np.int32)
    return (exe.bucket_pad(toks, 0), exe.bucket_pad(miss, exe.pad_slot),
            io_pos, nio - len(io))


def _old_restore(exe, state, toks_b, miss_b, io_pos_b, fed):
    """The restore as it ran before the compile layer: the model's
    ``recompute_pipelined`` on a private copy, ``fetch(l)`` the feed's
    arrays of layer l, the new leaves copied back.  -> (cache, hidden)."""
    cache = _copy(state)
    t = functools.partial(torch.as_tensor, dtype=torch.int64)
    new, hidden, _ = exe.model.recompute_pipelined(
        exe.params, t(toks_b)[None], t(miss_b), t(io_pos_b), dict(cache), N,
        lambda l: {k: torch.from_numpy(a) for k, a in fed[l].items()},
        want_density=False)
    for n, v in new.items():
        if v is not cache[n]:
            cache[n].copy_(v)
    return cache, hidden


def _reference(jmodel, jparams, state, toks_b, miss_b, io_pos_b, fed):
    """The reference's jitted ``recompute_pipelined`` on the same state
    and rows.  -> (cache, hidden)."""
    layout = "mixed" if "quant_mask" in state else "window"
    jc = dict(jmodel.init_cache(1, state["k"].shape[2], layout=layout))
    for n, v in state.items():
        if n != "pos":
            jc[n] = jnp.asarray(to_np(v)).astype(jc[n].dtype)
    fn = jax.jit(functools.partial(jmodel.recompute_pipelined,
                                   fetch=lambda l: fed[int(l)]))
    out, x, _ = fn(jparams, jnp.asarray(toks_b)[None], jnp.asarray(miss_b),
                   jnp.asarray(io_pos_b), jc, jnp.int32(N))
    return out, x


def _close(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


@pytest.mark.parametrize("name,quant", CASES,
                         ids=[f"{n}-{'mixed' if q else 'bf16'}"
                              for n, q in CASES])
def test_graphed_restore_equals_the_old_loop_and_the_reference(
        name, quant, tmp_path):
    exe, jmodel, jparams = _executor(name, quant)
    for k, (where, re_idx, io) in enumerate(RESTORES):
        slot = 0 if where == "decode" else exe.scratch_slot
        paths = [_chunk_file(str(tmp_path / f"{k}_{i}"), exe, bits, 100 * k + i)
                 for i, bits in io]
        toks_b, miss_b, io_pos_b, pad = _plan(exe, re_idx, io)
        state = _state(exe, N, seed=7 + k)
        old_feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers, CS,
                             exe.leaf_dims, pad_chunks=pad)
        fed = [old_feed.fetch(l) for l in range(exe.n_layers)]
        old_feed.close()
        want, h_want = _old_restore(exe, state, toks_b, miss_b, io_pos_b, fed)

        cache = _load(exe.fresh_cache(0, slot), state)
        calls = exe.graphs.calls
        feed = exe.layer_feed(paths, pad)
        got, hidden = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b,
                                        cache, N)
        feed.close()
        key = ("pipelined", (len(toks_b), len(io_pos_b) // CS), quant, slot)
        assert exe.graphs.calls == calls + 1 and key in exe.graphs.keys()
        assert key[1] in exe._pipelined_pairs(slot)
        assert got is cache and exe.slot_of(cache) == slot
        assert torch.equal(hidden, h_want)
        _assert_same_cache(cache, want)
        assert exe.last_pipelined["wall_s"] >= \
            exe.last_pipelined["feed_wait_s"] >= 0

        if name != "llama2-7b" or k % 2:
            continue                     # a jitted reference per shape
        jout, jx = _reference(jmodel, jparams, state, toks_b, miss_b,
                              io_pos_b, fed)
        real = len(exe.chunk_positions(re_idx))
        _close(jx[:, :real], hidden[:, :real])
        io_real = exe.chunk_positions([i for i, _ in io])
        for n in exe.codec.leaves:
            a = np.asarray(jout[n]).astype(np.float32)
            _close(a[:, :, :N], to_np(cache[n])[:, :, :N])
            np.testing.assert_array_equal(a[:, :, io_real],
                                          to_np(cache[n])[:, :, io_real])
        if quant:
            np.testing.assert_array_equal(np.asarray(jout["quant_mask"]),
                                          cache["quant_mask"].numpy())


def test_slot_pairs_and_entries_ahead():
    """The pairs a decode slot captures ahead fit the context (24 at
    ``max_ctx_len`` 256: all but (256, 16)); the scratch slot's are
    those ``profile_pipeline`` times; a policy that does not pipeline
    captures none."""
    exe, _, _ = _executor("llama2-7b", False)
    assert exe._pipelined_pairs(0) == [(16, 1), (16, 2), (16, 4), (32, 1),
                                       (32, 2), (64, 1)]
    assert exe._pipelined_pairs(exe.scratch_slot) == [(16, 1), (32, 1),
                                                      (64, 1)]
    big = TExecutor(exe.model, exe.params, TConfig(
        paged_pool=False, max_ctx_len=256, chunk_tokens=CS), "cpu")
    pairs = big._pipelined_pairs(0)
    assert len(pairs) == 24 and (256, 16) not in pairs
    assert set(pairs) | {(256, 16)} == {(t, n) for t in big.tok_buckets
                                        for n in big.io_buckets}
    nopipe = TExecutor(exe.model, exe.params, TConfig(
        policy="llms_nopipe", paged_pool=False, max_ctx_len=MAX_CTX,
        chunk_tokens=CS), "cpu")
    assert not nopipe.pipelines
    assert all(e != "pipelined" for e, _ in nopipe._slot_ahead(0))


def test_feed_publishes_every_layer_at_its_generation_in_order(tmp_path):
    exe, _, _ = _executor("llama2-7b", False)
    paths = [_chunk_file(str(tmp_path / f"c{i}"), exe, 8, i)
             for i in range(2)]
    sink = exe.feed_sink()
    seen = []

    def publish(layer, word):
        seen.append((layer, word))
        sink.publish(layer, word)
    feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers, CS,
                     exe.leaf_dims, pad_chunks=2,
                     sink=dataclasses.replace(sink, publish=publish))
    rows = [feed.fetch(l) for l in range(exe.n_layers)]
    feed.close()
    assert seen == [(l, sink.gen) for l in range(exe.n_layers)]
    assert (sink.flags == sink.gen).all()
    assert exe.feed_sink().gen == sink.gen + 1
    # the rows went into the sink, the pad chunks zeroed
    for l, got in enumerate(rows):
        for n, a in got.items():
            assert a.shape == (4 * CS, *exe.leaf_dims[n])
            assert np.shares_memory(a, sink.bufs[n])
            assert not a[2 * CS:].any()


def _flip_in_layer(path, layer):
    """Flip the first byte of ``layer``'s segment (the header still
    validates)."""
    with open(path, "rb") as f:
        header, base = restore._read_header(f)
    off = base + layer * restore._segment_size(header)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x40]))


def test_flipped_layer_publishes_failure_and_keeps_the_quant_mask(tmp_path):
    exe, _, _ = _executor("llama2-7b", True)
    L = exe.n_layers
    bad = L // 2
    io = [(0, 8), (3, 4)]
    paths = [_chunk_file(str(tmp_path / f"c{i}"), exe, bits, i)
             for i, bits in io]
    _flip_in_layer(paths[1], bad)
    toks_b, miss_b, io_pos_b, pad = _plan(exe, [2], io)
    cache = _load(exe.fresh_cache(0, 0), _state(exe, N, seed=3))
    mask = cache["quant_mask"].clone()
    assert mask.any()
    feed = exe.layer_feed(paths, pad)
    with pytest.raises(RuntimeError, match="LayerFeed I/O failed") as err:
        exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, cache, N)
    assert isinstance(err.value.__cause__, ChunkCorruptError)
    assert feed.done() and not exe._pipelining
    gen = feed.sink.gen
    assert feed.sink.flags.tolist() == [gen] * bad + [-gen] * (L - bad)
    assert torch.equal(cache["quant_mask"], mask)


def test_feed_that_never_publishes_times_out(tmp_path):
    """The feed queued behind a job that holds the pool's one worker (an
    ahead-of-time write, say) publishes nothing: the gate gives up at
    the deadline, the restore raises ``SwapTimeoutError`` instead of
    hanging, and once the worker is free the next restore runs."""
    exe, _, _ = _executor("llama2-7b", False)
    io = [(1, 8)]
    paths = [_chunk_file(str(tmp_path / "c1"), exe, 8, 1)]
    toks_b, miss_b, io_pos_b, pad = _plan(exe, [0], io)
    state = _state(exe, N, seed=5)
    pool, held = ThreadPoolExecutor(max_workers=1), threading.Event()
    pool.submit(held.wait)
    exe.cfg.swap_deadline_s = 0.3
    try:
        feed = exe.layer_feed(paths, pad, pool=pool)
        cache = _load(exe.fresh_cache(0, 0), state)
        t0 = time.perf_counter()
        with pytest.raises(SwapTimeoutError):
            exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, cache, N)
        assert time.perf_counter() - t0 < 5.0
        assert not exe._pipelining and not feed.done()
        held.set()
        again = exe.layer_feed(paths, pad, pool=pool)   # waits for it
        assert feed.done()
        exe.run_pipelined(again, toks_b, miss_b, io_pos_b,
                          _load(cache, state), N)
        again.close()
        assert again.sink.gen == feed.sink.gen + 1
    finally:
        held.set()
        exe.cfg.swap_deadline_s = None
        pool.shutdown(wait=True)


@pytest.mark.parametrize("relayed", [False, True], ids=["sink", "relay"])
def test_feed_thread_calls_nothing_of_torch(relayed, tmp_path, monkeypatch):
    """With a sink (and through a relay into one) no torch entry point is
    called from any thread but the one that runs the restore."""
    exe, _, _ = _executor("llama2-7b", True)
    io = [(0, 8), (1, 16), (3, 4)]
    paths = [_chunk_file(str(tmp_path / f"c{i}"), exe, bits, i)
             for i, bits in io]
    toks_b, miss_b, io_pos_b, pad = _plan(exe, [2], io)
    main, foreign = threading.current_thread(), []

    def watch(owner, attr):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def spy(*a, **k):
            if threading.current_thread() is not main:
                foreign.append((attr, threading.current_thread().name))
            return fn(*a, **k)
        monkeypatch.setattr(owner, attr, spy)
    for attr in ("zeros", "empty", "from_numpy", "as_tensor", "tensor",
                 "full", "cat", "stack"):
        watch(torch, attr)
    for attr in ("to", "copy_", "pin_memory", "numpy", "cpu", "__setitem__"):
        watch(torch.Tensor, attr)
    for attr in ("synchronize", "current_stream", "is_available"):
        watch(torch.cuda, attr)
    cache = _load(exe.fresh_cache(0, 0), _state(exe, N, seed=9))
    if relayed:
        feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers, CS,
                         exe.leaf_dims, pad_chunks=pad,
                         alloc=exe.host_alloc)
    else:
        feed = exe.layer_feed(paths, pad)
    exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, cache, N)
    feed.close()
    assert not foreign, foreign


@pytest.mark.parametrize("word,gen,status0,want", [
    (5, 5, 0, 0), (-5, 5, 0, 1), (4, 5, 0, 2), (0, 0, 0, 0), (4, 5, 1, 1)],
    ids=["published", "failed", "older-generation", "warm-up", "status-set"])
def test_plain_gate_statuses(word, gen, status0, want):
    """``feed_gate_plain`` on one word: its generation passes, its
    negative sets status 1, another generation status 2 after the
    deadline (having waited that long), and a status already set passes
    without waiting; the wait lands in ``wait_ns[layer]`` only."""
    from repro_torch.kernels.ref import feed_gate_plain
    flags = torch.zeros(4, dtype=torch.int32)
    flags[2] = word
    status = torch.full((1,), status0, dtype=torch.int32)
    wait = torch.zeros(4, dtype=torch.int64)
    deadline_ns = 20_000_000
    feed_gate_plain(flags, 2, torch.tensor(gen, dtype=torch.int32),
                    torch.tensor(deadline_ns), status, wait)
    assert int(status[0]) == want
    assert wait[[0, 1, 3]].eq(0).all()
    if want == 2:
        assert int(wait[2]) > deadline_ns
    if status0:
        assert int(wait[2]) == 0
