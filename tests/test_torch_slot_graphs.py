"""The executor's compile layer for the slot engine (``core/graphs.py``
over the static slot caches of ``ModelExecutor.init_slots``) on the
CPU, where every slot entry's body runs eagerly on the slot's own
buffers, as the card replays its graph.

* Every slot entry (``extend``, ``extend_nod``, ``decode``) at every
  token bucket, on each of the ``decode_slots`` decode slots and the
  scratch slot, bf16 window and mixed (quant-resident) caches, for the
  reduced llama2-7b, ``bench_model``'s size, the reduced
  deepseek-v2-lite-16b (MLA + MoE) and llama4-maverick (MoE), and the
  reduced rwkv6-1.6b at two exact lengths: from a random state, two
  calls in a row give the logits, the density or mass (an
  ``extend_nod``'s hidden rows) and every slot-cache byte (``pos`` and
  ``quant_mask`` included) of the entry as it ran before the compile
  layer (``_old_*``: the model's entry on a private copy, a Python
  ``seq_len``, the head product of ``hidden[:, M - 1]``), bit for bit;
  and the reference's jitted ``ModelExecutor`` entry on the same state
  within the tolerances of ``test_torch_models.py`` /
  ``test_torch_mla.py`` / ``test_torch_moe.py`` / ``test_torch_rwkv6.py``
  (logits and float leaves 2% of the largest value, density and mass
  1e-4 or one bf16 ulp of the largest; the MLA and MoE families
  teacher-forced at expert near-ties by ``_forced_experts``).
* A slot reclaimed by another context carries no byte of its former
  one.  ``init_slots`` is reached only before the service's threads or
  on the serialized surface.  The analyzer flags a slot body that reads
  a tensor on the host.
"""
import ast
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np  # noqa: F401
from repro.core.executor import ModelExecutor as JExecutor
from repro.core.service import LLMSConfig as JConfig
from repro_torch.analysis.runner import analyze_source
from repro_torch.core.executor import ModelExecutor as TExecutor
from repro_torch.core.service import LLMSConfig as TConfig
from test_torch_graphs import _models as _bench_models
from test_torch_moe import _forced_experts

CS, MAX_CTX, DECODE_BATCH = 16, 64, 2
MLA, MOE, RWKV = ("deepseek-v2-lite-16b", "llama4-maverick-400b-a17b",
                  "rwkv6-1.6b")
# (family case, quant-resident)
CASES = [("llama2-7b", False), ("llama2-7b", True), ("bench", False),
         ("bench", True), (MLA, False), (MLA, True), (MOE, False),
         (MOE, True)]
# the families whose FFN routes tokens to experts: held to the reference
# teacher-forced at expert near-ties, on a private copy of the state
ROUTED = (MLA, MOE)
BUCKETS = (16, 32, 64)
RWKV_LENGTHS = (5, 11)
_EXES = {}


def _executors(name, quant):
    """-> (jax executor, torch executor, jax params) of a case, built
    once (the reference's jitted entries compile once)."""
    if (name, quant) not in _EXES:
        if name == "bench":
            jmodel, jparams, tmodel, tparams = _bench_models("bench")
        else:
            _, jmodel, jparams, _, tmodel, tparams = tiny_pair(name)
        kw = dict(policy="llms", paged_pool=False, decode_batch=DECODE_BATCH,
                  max_ctx_len=MAX_CTX, chunk_tokens=CS, quant_resident=quant)
        _EXES[name, quant] = (JExecutor(jmodel, jparams, JConfig(**kw)),
                              TExecutor(tmodel, tparams, TConfig(**kw),
                                        "cpu"))
    return _EXES[name, quant]


def _state(texe, n0, seed):
    """A random slot state at ``pos = n0``: sequence leaves N(0, 1) in
    bf16 on [0, n0) and zero beyond (as a switch-in leaves them); in the
    mixed layout int8 codes on chunk 0 with scales in [0.01, 0.017]
    (about the bf16 values' magnitude) and the quant mask there; a state
    family's leaves N(0, 1) whole.  -> {leaf: tensor} (private)."""
    rng = np.random.default_rng(seed)
    state = texe.fresh_cache(n0)
    seq = texe.chunked_cache
    for n, t in state.items():
        if n == "pos":
            continue
        if n == "quant_mask":
            t[..., :CS] = True
        elif t.dtype == torch.int8:
            t[:, :, :CS] = torch.from_numpy(rng.integers(
                -127, 128, t[:, :, :CS].shape).astype(np.int8))
        elif n.endswith("_scale"):
            t[:, :, :CS] = torch.from_numpy((rng.random(
                t[:, :, :CS].shape) * 0.007 + 0.01).astype(np.float32))
        elif seq:
            t[:, :, :n0] = torch.from_numpy(rng.standard_normal(
                t[:, :, :n0].shape).astype(np.float32)).to(t.dtype)
        else:
            t.copy_(torch.from_numpy(rng.standard_normal(
                t.shape).astype(np.float32)).to(t.dtype))
    return state


def _load(slot_cache, state):
    """``state`` into the slot's own tensors (its addresses kept)."""
    for n, t in slot_cache.items():
        t.copy_(state[n])
    return slot_cache


def _copy(cache):
    return {n: t.clone() for n, t in cache.items()}


def _same_bytes(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def _assert_same_cache(got, want):
    assert got.keys() == want.keys()
    bad = [n for n in got if not _same_bytes(got[n], want[n])]
    assert not bad, bad


def _assert_same_out(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


# --- the entries as the executor ran them before its slot graphs ----- #
def _old_extend(exe, cache, prompt, n0):
    M = len(prompt)
    pos_b, toks_b = exe.exact_or_padded(
        np.arange(n0, n0 + M, dtype=np.int32), prompt)
    cache, hidden, dens = exe.model.recompute(
        exe.params, _t(toks_b)[None], _t(pos_b), cache, int(n0 + M),
        want_density=True, **exe._cw)
    logits = (hidden[:, M - 1] @ exe.model.head_weight(exe.params)
              ).to(torch.float32).numpy()[0]
    cache["pos"] = torch.tensor(n0 + M, dtype=torch.int64)
    return cache, logits, dens[0].numpy().astype(np.float64)


def _old_extend_nod(exe, cache, toks_b, pos_b, seq_len):
    cache, hidden, _ = exe.model.recompute(
        exe.params, _t(toks_b)[None], _t(pos_b), cache, int(seq_len),
        want_density=False, **exe._cw)
    return cache, hidden


def _old_decode(exe, cache, tok):
    out, mass = exe.model.decode_step(exe.params, _t([[tok]]), cache,
                                      want_density=True, **exe._cw)
    return (dict(out.cache), out.logits[0].numpy(),
            mass[0].numpy().astype(np.float64))


# --- the reference ------------------------------------------------------ #
def _jcache(cache):
    """A port cache as the reference's (bf16 bits kept)."""
    out = {}
    for n, t in cache.items():
        if n == "pos":
            out[n] = jnp.int32(int(t))
        elif t.dtype == torch.bfloat16:
            out[n] = jnp.asarray(to_np(t)).astype(jnp.bfloat16)
        else:
            out[n] = jnp.asarray(t.numpy())
    return out


def _close(ref, got, frac=0.02):
    ref = np.asarray(ref, np.float32)
    got = to_np(got) if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=frac, atol=frac * scale)


def _close_density(ref, got):
    ref = np.asarray(ref, np.float64)
    top = float(np.max(np.abs(ref))) if ref.size else 0.0
    tol = max(1e-4, float(np.spacing(np.float32(top))) * 2 ** 16)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, atol=tol,
                               rtol=0)


def _close_cache(jc, tc):
    """Every leaf of the port's cache against the reference's: int8 codes,
    the quant mask and pos exactly, float leaves 2% of their range."""
    for n, t in tc.items():
        ref = np.asarray(jc[n])
        if n == "pos":
            assert int(t) == int(ref)
        elif t.dtype in (torch.int8, torch.bool):
            np.testing.assert_array_equal(t.numpy(), ref)
        else:
            _close(ref.astype(np.float32), t)


def _reference_ctx(name):
    return _forced_experts() if name in ROUTED else contextlib.nullcontext()


# --- the cases ------------------------------------------------------------ #
def _extend_calls(texe, bucket):
    """Two extends at ``bucket`` one after the other: (n0, prompt) each,
    the second from the first's end."""
    rng = np.random.default_rng(bucket)
    M1, M2 = bucket - 3, bucket // 2 + 1
    n0 = min(20, texe.pad_slot - M1 - M2)
    p1 = rng.integers(1, 200, M1).astype(np.int32)
    p2 = rng.integers(1, 200, M2).astype(np.int32)
    return [(n0, p1), (n0 + M1, p2)]


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("name,quant", CASES)
def test_slot_extend_matches_eager_entry_and_reference(name, quant, bucket):
    jexe, texe = _executors(name, quant)
    slots = texe.init_slots()
    assert sorted(slots) == list(range(DECODE_BATCH + 1))
    calls = _extend_calls(texe, bucket)
    eager = texe.eager_calls
    for slot, cache in slots.items():
        state = _state(texe, calls[0][0], seed=slot)
        _load(cache, state)
        old = _copy(state)
        for n0, prompt in calls:
            got = texe.extend(cache, prompt, n0)
            assert got[0] is cache and texe.slot_of(cache) == slot
            old, *want = _old_extend(texe, old, prompt, n0)
            _assert_same_out(got[1:], want)
            _assert_same_cache(cache, old)
            assert texe.graphs.entry(("extend", bucket, quant, slot))
    assert texe.eager_calls == eager
    # the reference's jitted executor from the same state
    jc = _jcache(state)
    tc = _copy(state)
    with _reference_ctx(name):
        for n0, prompt in calls:
            jc, jl, jd = jexe.extend(jc, prompt, n0)
            if name in ROUTED:     # the port after the reference, forced
                _, tl, td = texe.extend(tc, prompt, n0)
            else:
                _load(cache, tc)
                _, tl, td = texe.extend(cache, prompt, n0)
                tc = _copy(cache)
            _close(jl, tl)
            _close_density(jd, td)
    _close_cache(jc, tc)


def _nod_calls(texe, bucket):
    """Two restores' recompute at ``bucket``: (positions, tokens,
    seq_len) of the chunks' rows at the end of a full window, then of
    the first rows."""
    rng = np.random.default_rng(100 + bucket)
    n = texe.n_slots
    M1, M2 = bucket - 3, bucket // 2 + 1
    out = []
    for pos in (np.arange(n - M1, n, dtype=np.int32),
                np.arange(0, M2, dtype=np.int32)):
        toks = rng.integers(1, 200, len(pos)).astype(np.int32)
        out.append((texe.bucket_pad(pos, texe.pad_slot),
                    texe.bucket_pad(toks, 0), n))
    return out


@pytest.mark.parametrize("bucket", BUCKETS)
@pytest.mark.parametrize("name,quant", CASES)
def test_slot_extend_nod_matches_eager_entry_and_reference(name, quant,
                                                           bucket):
    jexe, texe = _executors(name, quant)
    slots = texe.init_slots()
    calls = _nod_calls(texe, bucket)
    for slot, cache in slots.items():
        state = _state(texe, texe.n_slots, seed=10 + slot)
        _load(cache, state)
        old = _copy(state)
        for pos_b, toks_b, n in calls:
            got_cache, hidden, dens = texe.extend_nod(toks_b, pos_b, cache, n)
            assert got_cache is cache and dens is None
            old, want = _old_extend_nod(texe, old, toks_b, pos_b, n)
            assert _same_bytes(hidden, want)
            _assert_same_cache(cache, old)
    jc, tc = _jcache(state), _copy(state)
    with _reference_ctx(name):
        for pos_b, toks_b, n in calls:
            jc, jh, _ = jexe.extend_nod_fn(
                jexe.params, jnp.asarray(toks_b)[None], jnp.asarray(pos_b),
                jc, jnp.int32(n))
            if name in ROUTED:
                _, th, _ = texe.extend_nod(toks_b, pos_b, tc, n)
            else:
                _load(cache, tc)
                _, th, _ = texe.extend_nod(toks_b, pos_b, cache, n)
                tc = _copy(cache)
            _close(np.asarray(jh).astype(np.float32), th)
    _close_cache(jc, tc)


@pytest.mark.parametrize("name,quant", CASES)
def test_slot_decode_matches_eager_entry_and_reference(name, quant):
    """Two decode steps a slot, on every slot (the scratch slot's
    captured at its first call on the card: it never decodes while
    serving)."""
    jexe, texe = _executors(name, quant)
    slots = texe.init_slots()
    toks = (7, 91)
    for slot, cache in slots.items():
        state = _state(texe, 37, seed=20 + slot)
        _load(cache, state)
        old = _copy(state)
        for tok in toks:
            got = texe.decode(cache, tok)
            assert got[0] is cache
            old, *want = _old_decode(texe, old, tok)
            _assert_same_out(got[1:], want)
            _assert_same_cache(cache, old)
        assert int(cache["pos"]) == 39
    jc, tc = _jcache(state), _copy(state)
    with _reference_ctx(name):
        for tok in toks:
            jc, jl, jm = jexe.decode(jc, tok)
            if name in ROUTED:
                _, tl, tm = texe.decode(tc, tok)
            else:
                _load(cache, tc)
                _, tl, tm = texe.decode(cache, tok)
                tc = _copy(cache)
            _close(jl, tl)
            _close_density(jm, tm)
    _close_cache(jc, tc)


@pytest.mark.parametrize("entry", ["extend", "extend_nod", "decode"])
def test_rwkv6_slot_entries_at_exact_lengths(entry):
    """RWKV6 (not ``pad_safe``) at two exact lengths: each length its own
    entry (the reference retraces per length), bit for bit against the
    eager entry and near the reference's (the state leaves 2% of their
    range), on every slot."""
    jexe, texe = _executors(RWKV, False)
    slots = texe.init_slots()
    rng = np.random.default_rng(4)
    calls = [(7, rng.integers(1, 200, L).astype(np.int32))
             for L in RWKV_LENGTHS]
    calls[1] = (7 + RWKV_LENGTHS[0], calls[1][1])
    for slot, cache in slots.items():
        state = _state(texe, 7, seed=30 + slot)
        _load(cache, state)
        old = _copy(state)
        for n0, prompt in calls:
            if entry == "extend":
                got = texe.extend(cache, prompt, n0)
                old, *want = _old_extend(texe, old, prompt, n0)
                _assert_same_out(got[1:], want)
                assert texe.graphs.entry(("extend", len(prompt), False,
                                          slot))
            elif entry == "extend_nod":
                pos = np.arange(n0, n0 + len(prompt), dtype=np.int32)
                _, h, _ = texe.extend_nod(prompt, pos, cache,
                                          n0 + len(prompt))
                old, want = _old_extend_nod(texe, old, prompt, pos,
                                            n0 + len(prompt))
                assert _same_bytes(h, want)
            else:
                for tok in prompt[:2]:
                    got = texe.decode(cache, int(tok))
                    old, *want = _old_decode(texe, old, int(tok))
                    _assert_same_out(got[1:], want)
            _assert_same_cache(cache, old)
    jc = _jcache(state)
    _load(cache, state)
    for n0, prompt in calls:
        if entry == "extend":
            jc, jl, _ = jexe.extend(jc, prompt, n0)
            _, tl, td = texe.extend(cache, prompt, n0)
            _close(jl, tl)
            assert not td.any() and td.shape == (len(prompt),)
        elif entry == "extend_nod":
            pos = np.arange(n0, n0 + len(prompt), dtype=np.int32)
            jc, jh, _ = jexe.extend_nod_fn(
                jexe.params, jnp.asarray(prompt)[None], jnp.asarray(pos), jc,
                jnp.int32(n0 + len(prompt)))
            _, th, _ = texe.extend_nod(prompt, pos, cache, n0 + len(prompt))
            _close(np.asarray(jh).astype(np.float32), th)
        else:
            for tok in prompt[:2]:
                jc, jl, _ = jexe.decode(jc, int(tok))
                _, tl, tm = texe.decode(cache, int(tok))
                _close(jl, tl)
                assert not tm.any()
    _close_cache(jc, cache)


def test_rwkv6_lengths_are_separate_entries():
    """Each exact length is an entry of its own, per slot (the
    reference's retrace per length)."""
    _, texe = _executors(RWKV, False)
    texe.init_slots()
    cache = texe.fresh_cache(0, 0)
    for L in RWKV_LENGTHS:
        texe.extend(cache, np.arange(1, L + 1, dtype=np.int32), 0)
    keys = {k for k in texe.graphs.keys() if k[0] == "extend"}
    assert {("extend", L, False, 0) for L in RWKV_LENGTHS} <= keys


def test_slot_ahead_entries():
    """What the card captures ahead over each slot: decode (not on the
    scratch slot), extend at every bucket, extend_nod where restores
    recompute, the pipelined restore at the slot's (token bucket, I/O
    bucket) pairs where the policy pipelines; a family that is not
    ``pad_safe`` decode only."""
    _, texe = _executors("llama2-7b", False)
    nb = len(texe.tok_buckets)
    assert texe.tok_buckets == list(BUCKETS)
    pairs = texe._pipelined_pairs(0)
    assert len(texe._slot_ahead(0)) == 1 + 2 * nb + len(pairs)
    assert texe._slot_ahead(texe.scratch_slot) == (
        [("extend", b) for b in BUCKETS] + [("extend_nod", b)
                                            for b in BUCKETS]
        + [("pipelined", (b, 1)) for b in BUCKETS])
    _, moe = _executors(MOE, False)
    assert ("extend_nod", 16) not in moe._slot_ahead(0)
    _, rwkv = _executors(RWKV, False)
    assert rwkv._slot_ahead(0) == [("decode", 1)]
    assert rwkv._slot_ahead(rwkv.scratch_slot) == []


def test_private_cache_runs_eagerly_and_slot_calls_are_counted():
    """A cache that is no slot's runs the same bodies eagerly, counted in
    ``eager_calls``; a slot's calls go through the graph cache."""
    _, texe = _executors("llama2-7b", True)
    texe.init_slots()
    e0, c0 = texe.eager_calls, texe.graphs.calls
    private = texe.fresh_cache(0)
    assert texe.slot_of(private) is None
    texe.extend(private, np.arange(1, 9, dtype=np.int32), 0)
    texe.decode(private, 3)
    assert texe.eager_calls == e0 + 2 and texe.graphs.calls == c0
    slot = texe.fresh_cache(0, 1)
    texe.extend(slot, np.arange(1, 9, dtype=np.int32), 0)
    texe.decode(slot, 3)
    assert texe.eager_calls == e0 + 2 and texe.graphs.calls == c0 + 2


def test_fresh_cache_zeroes_the_slot_in_place():
    """``fresh_cache(n, slot)`` hands back the slot's own dict and
    tensors, zeroed, with ``pos`` written in place."""
    _, texe = _executors("llama2-7b", True)
    slots = texe.init_slots()
    cache = slots[1]
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    _load(cache, _state(texe, 40, seed=3))
    got = texe.fresh_cache(12, 1)
    assert got is cache and {n: t.data_ptr() for n, t in got.items()} == ptrs
    assert int(got["pos"]) == 12
    assert all(not t.any() for n, t in got.items() if n != "pos")


@pytest.mark.parametrize("name,quant", [("llama2-7b", False),
                                        ("llama2-7b", True), (MLA, False),
                                        (RWKV, False)])
def test_reclaimed_slot_carries_nothing_of_its_former_context(name, quant):
    """``decode_batch`` 1: context a fills the one decode slot and parks;
    b's switch-in reclaims it (a's parked slot dropped) and finds it
    zeroed in place: every switch-in into the slot leaves the bytes of
    the same switch-in into a fresh private cache, so nothing of a
    survives in b's (sequence leaves past b's last chunk are zero)."""
    from _torch_parity import services
    _, svc, cfg = services(name=name, policy="llms", paged_pool=False,
                           decode_batch=1, quant_resident=quant,
                           port_only=True, budget=1 << 30)
    seen = []
    with svc:
        switch_in = svc.res.switch_in

        def logged(ctx, slot=None):
            want, _ = switch_in(ctx)                  # a private cache
            cache, t = switch_in(ctx, slot)
            _assert_same_cache(cache, want)
            seen.append((ctx.cid, ctx.n_tokens, slot, _copy(cache),
                         {n: t.data_ptr() for n, t in cache.items()}))
            return cache, t
        svc.res.switch_in = logged
        a, b = svc.newLLMCtx(), svc.newLLMCtx()
        rng = np.random.default_rng(1)
        svc.callLLM(b, rng.integers(1, cfg.vocab, 9).tolist(), 2)
        svc.callLLM(a, rng.integers(1, cfg.vocab, 30).tolist(), 4)
        svc.callLLM(b, rng.integers(1, cfg.vocab, 5).tolist(), 2)
    (_, _, s0, _, p0), (_, _, s1, _, p1), (cid, n, s2, cache, p2) = seen
    assert cid == b.ctx_id and n == 11
    assert s0 == s1 == s2 == 0 and p0 == p1 == p2
    if svc.exe.chunked_cache:
        end = -(-n // CS) * CS
        for leaf, t in cache.items():
            if leaf != "pos":
                assert not t[..., end:svc.exe.pad_slot].any() \
                    if leaf == "quant_mask" else \
                    not t[:, :, end:svc.exe.pad_slot].any(), leaf
    assert int(cache["pos"]) == n


def _call_sites(attr):
    """The functions of the port's tree that call ``<x>.attr(...)``."""
    from repro_torch.analysis.runner import build_program
    found = set()
    for mod in build_program().modules:
        for fn in mod.all_functions:
            for node in ast.walk(fn.node):
                if isinstance(node, ast.Call) and \
                        isinstance(node.func, ast.Attribute) and \
                        node.func.attr == attr:
                    found.add(fn.qualname)
    return found


def test_slots_are_made_before_threads_or_on_the_serialized_surface():
    """The analyzer's allowlist entry for ``ModelExecutor._slots``:
    ``init_slots`` is called by ``ResidencyEngine.__init__`` (before any
    service thread) and by ``fresh_cache`` (whose callers are all
    ``@requires_serialized``) only."""
    assert _call_sites("init_slots") == {"ResidencyEngine.__init__",
                                         "ModelExecutor.fresh_cache"}


def test_analyzer_flags_a_host_read_in_a_slot_body():
    """The slot bodies pass J1 / J2; an ``int()`` of a tensor in one (the
    extend's ``pos``, written from the host value) is flagged."""
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1]
           / "src/repro_torch/core/executor.py").read_text()
    assert [f for f in analyze_source(src) if f.checker == "jit"] == []
    bad = src.replace('bufs["pos"].copy_(inp["seq_len"])',
                      'bufs["pos"].fill_(int(inp["seq_len"]))')
    assert bad != src
    found = [f for f in analyze_source(bad) if f.checker == "jit"]
    assert [f.rule for f in found] == ["host-call-in-jit"]
    assert "int()" in found[0].message
