"""The executor's compile layer for the paged pool (``core/graphs.py``)
on the CPU, at the reduced llama2-7b and at the size of the reference's
``benchmarks/common.py:bench_model`` (6 layers, d 256, 8 heads over 4,
hd 32, vocab 4096), the port's weights converted from the reference's.

* Every token bucket of ``paged_extend`` and every batch bucket of
  ``paged_decode``, with the bf16 pool and quant-resident: the body fed
  through the static buffers gives the logits, the density or mass and
  the arenas of the eager entry as it ran before the compile layer
  (``_eager_extend`` / ``_eager_decode``), bit for bit, at two calls of
  a bucket (the buffers restaged); and the reference's executor entry
  on the same arenas within the tolerances of
  ``tests/test_torch_models.py`` (logits and K/V pages 2% of the
  largest value, density and mass 1e-4).
* ``seq_len`` as a 0-d tensor gives the bytes of the Python int in
  ``ref.attn_density_plain`` and ``ops.attn_density``.
* The counterparts of ``tests/test_executor_cache.py``: an executor
  never sees another's graphs, also after GC; the cache stays bounded in
  LRU order; rebuilding the arenas drops the graphs.
* The launch-count helpers a replay credits through.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, to_np, to_torch  # noqa: F401
from conftest import tiny_model
from repro.configs import get_config as jget_config
from repro.core.executor import ModelExecutor as JExecutor
from repro.core.service import LLMSConfig as JConfig
from repro.models.registry import build_model as jbuild_model
from repro_torch import kernels
from repro_torch.configs import get_config, reduced
from repro_torch.core import graphs
from repro_torch.core.executor import ModelExecutor as TExecutor
from repro_torch.core.service import LLMSConfig as TConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model

CS, MAX_CTX, DECODE_BATCH, P16, P8 = 16, 64, 4, 40, 12
# benchmarks/common.py bench_model's overrides of llama2-7b
BENCH = dict(name="llama2-7b-bench", n_layers=6, d_model=256, n_heads=8,
             n_kv_heads=4, head_dim=32, d_ff=1024, vocab=4096, max_seq=1024)
_MODELS, _EXES = {}, {}


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def _models(size):
    """-> (jax model, jax params, torch model, torch params) on the same
    weights: the reduced llama2-7b or bench_model's size."""
    if size not in _MODELS:
        if size == "reduced":
            _, jmodel, jparams = tiny_model("llama2-7b")
            tcfg = reduced(get_config("llama2-7b"))
        else:
            jcfg = jget_config("llama2-7b").with_overrides(**BENCH)
            jmodel = jbuild_model(jcfg)
            jparams = jmodel.init(jax.random.PRNGKey(0))
            tcfg = get_config("llama2-7b").with_overrides(**BENCH)
        tmodel = build_model(tcfg, device="cpu")
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
        _MODELS[size] = (jmodel, jparams, tmodel, tparams)
    return _MODELS[size]


def _cfg(cls, quant):
    return cls(policy="llms", paged_pool=True, decode_batch=DECODE_BATCH,
               max_ctx_len=MAX_CTX, chunk_tokens=CS, quant_resident=quant,
               pool_pages_16=P16, pool_pages_8=P8)


def _executors(size, quant):
    """-> (jax executor, torch executor), built once per size and
    quant-resident (the reference's jitted entries compile once)."""
    if (size, quant) not in _EXES:
        jmodel, jparams, tmodel, tparams = _models(size)
        _EXES[size, quant] = (JExecutor(jmodel, jparams, _cfg(JConfig, quant)),
                              TExecutor(tmodel, tparams, _cfg(TConfig, quant),
                                        "cpu"))
    return _EXES[size, quant]


def _arenas(texe, seed):
    """Random arena contents -> (a maker of torch arena sets, the
    reference's arenas): bf16 K/V pages N(0, 1), int8 codes uniform over
    [-127, 127] and fp32 scales in [0.01, 0.017], so that a quant page
    dequantizes to about the bf16 pages' magnitude (std ~1)."""
    rng = np.random.default_rng(seed)
    base = texe.init_arenas()
    host = {}
    for n, t in base.items():
        if t.dtype == torch.bfloat16:
            host[n] = np.asarray(jnp.asarray(rng.standard_normal(
                t.shape).astype(np.float32)).astype(jnp.bfloat16))
        elif t.dtype == torch.int8:
            host[n] = rng.integers(-127, 128, t.shape).astype(np.int8)
        else:
            host[n] = (rng.random(t.shape) * 0.007 + 0.01).astype(
                np.float32)

    def fresh():
        return {n: to_torch(a) for n, a in host.items()}
    return fresh, {n: jnp.asarray(a) for n, a in host.items()}


def _rows(texe, n_rows, top, quant, seed):
    """Page-table rows of ``n_rows`` contexts whose chunks up to position
    ``top[i]`` hold distinct bf16 pages; under quant-resident, chunk 0 of
    every row is also an int8 page marked in the quant mask.
    -> (pt16, pt8 | None, qmask | None), (n_rows, C) each."""
    rng = np.random.default_rng(seed)
    C = texe.pages_per_ctx
    pages16 = rng.permutation(np.arange(1, P16))
    pages8 = rng.permutation(np.arange(1, P8))
    pt16 = np.zeros((n_rows, C), np.int32)
    pt8 = np.zeros((n_rows, C), np.int32)
    qmask = np.zeros((n_rows, C), bool)
    k = 0
    for i in range(n_rows):
        n_chunks = top[i] // CS + 1
        pt16[i, :n_chunks] = pages16[k:k + n_chunks]
        k += n_chunks
        pt8[i, 0] = pages8[i]
        qmask[i, 0] = True
    return (pt16, pt8, qmask) if quant else (pt16, None, None)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _quant_kw(pt8, qmask):
    return ({} if pt8 is None else
            dict(pt8=_t(pt8), quant_chunks=_t(qmask, torch.bool)))


def _eager_extend(exe, arenas, prompt, n0, pt16, pt8, qmask):
    """``paged_extend`` as the executor ran it before its graphs: the
    model's entry on tensors made per call, a Python ``seq_len``, the
    head product of ``hidden[:, M - 1]``."""
    M = len(prompt)
    pos_b = exe.bucket_pad(np.arange(n0, n0 + M, dtype=np.int32),
                           exe.pad_slot)
    toks_b = exe.bucket_pad(np.asarray(prompt, np.int32), 0)
    arenas, hidden, dens = exe.model.extend_paged(
        exe.params, _t(toks_b)[None], _t(pos_b), arenas, _t(pt16), n0 + M,
        want_density=True, **_quant_kw(pt8, qmask), **exe._cw)
    logits = (hidden[:, M - 1] @ exe.model.head_weight(exe.params)
              ).to(torch.float32).numpy()[0]
    return arenas, logits, dens[0].numpy().astype(np.float64)


def _eager_decode(exe, arenas, toks, pos, pt16, pt8, qmask):
    """``paged_decode`` as the executor ran it before its graphs."""
    n = len(toks)
    nb = next(b for b in exe.batch_buckets if b >= n)
    C = pt16.shape[1]
    toks_b = np.zeros((nb, 1), np.int32)
    toks_b[:n, 0] = toks
    pos_b = np.zeros(nb, np.int32)
    pos_b[:n] = pos
    pt16_b = np.zeros((nb, C), np.int32)
    pt16_b[:n] = pt16
    kw = {}
    if pt8 is not None:
        pt8_b = np.zeros((nb, C), np.int32)
        pt8_b[:n] = pt8
        qmask_b = np.zeros((nb, C), bool)
        qmask_b[:n] = qmask
        kw = _quant_kw(pt8_b, qmask_b)
    arenas, logits, mass = exe.model.decode_paged(
        exe.params, _t(toks_b), arenas, _t(pt16_b), _t(pos_b),
        want_density=True, **kw, **exe._cw)
    return (arenas, logits[:n].numpy(),
            mass[:n].numpy().astype(np.float64))


def _assert_same(a, b):
    """(arenas, logits, density | mass) of two runs, bit for bit."""
    assert a[0].keys() == b[0].keys()
    for n in a[0]:
        assert torch.equal(a[0][n], b[0][n]), n
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _assert_near_reference(jout, tout):
    ja, jl, jd = jout
    ta, tl, td = tout
    _close_bf16(np.asarray(jl, np.float32), tl)
    np.testing.assert_allclose(td, np.asarray(jd, np.float64), atol=1e-4)
    for n in ("k16", "v16"):
        _close_bf16(np.asarray(ja[n]).astype(np.float32), ta[n])


@pytest.mark.parametrize("size", ["reduced", "bench"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bucket", [16, 32, 64])
def test_paged_extend_bucket_matches_eager_entry_and_reference(size, quant,
                                                               bucket):
    jexe, texe = _executors(size, quant)
    assert texe.tok_buckets == [16, 32, 64]
    vocab = texe.model.cfg.vocab
    rng = np.random.default_rng(bucket + 7 * quant)
    fresh, jarenas = _arenas(texe, bucket)
    for M in (bucket - 3, bucket // 2 + 1):        # two calls, one bucket
        n0 = min(20, MAX_CTX - M)
        assert texe.bucket_len(M) == bucket
        prompt = rng.integers(1, vocab, M).astype(np.int32)
        pt16, pt8, qmask = _rows(texe, 1, [n0 + M - 1], quant, M)
        got = texe.paged_extend(fresh(), prompt, n0, pt16, pt8, qmask)
        want = _eager_extend(texe, fresh(), prompt, n0, pt16, pt8, qmask)
        _assert_same(got, want)
        jout = jexe.paged_extend(jarenas, prompt, n0, pt16, pt8, qmask)
        _assert_near_reference(jout, got)
    entry = texe.graphs.entry(("extend", bucket, quant))
    assert entry is not None and entry.graph is None      # the CPU: eager
    assert int(entry.inputs["seq_len"]) == n0 + M
    assert int(entry.inputs["last"][0]) == M - 1


@pytest.mark.parametrize("size", ["reduced", "bench"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("bucket,n", [(1, 1), (2, 2), (4, 3)])
def test_paged_decode_bucket_matches_eager_entry_and_reference(size, quant,
                                                               bucket, n):
    jexe, texe = _executors(size, quant)
    assert texe.batch_buckets == [1, 2, 4]
    vocab = texe.model.cfg.vocab
    rng = np.random.default_rng(bucket + 11 * quant)
    fresh, jarenas = _arenas(texe, 100 + bucket)
    for step in range(2):                          # two rounds, one bucket
        pos = [20 + 7 * i + step for i in range(n)]
        toks = rng.integers(1, vocab, n).tolist()
        pt16, pt8, qmask = _rows(texe, n, pos, quant, step)
        got = texe.paged_decode(fresh(), toks, pos, pt16, pt8, qmask)
        want = _eager_decode(texe, fresh(), toks, pos, pt16, pt8, qmask)
        _assert_same(got, want)
        assert got[1].shape == (n, vocab)
        jout = jexe.paged_decode(jarenas, toks, pos, pt16, pt8, qmask)
        _assert_near_reference(jout, got)
    entry = texe.graphs.entry(("decode", bucket, quant))
    assert entry is not None
    assert entry.inputs["toks"].shape == (bucket, 1)
    # pad rows take the all-zero page-table row (the scratch page)
    assert not entry.inputs["pt16"][n:].any()


@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("seq_len", [1, 37, 64, 80])
def test_seq_len_tensor_gives_the_bytes_of_the_int(form, seq_len):
    rng = np.random.default_rng(seq_len)
    B, Sq, Sk, H, KV, hd = 1, 16, 80, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).to(torch.bfloat16)
               for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    q_pos = torch.from_numpy(np.r_[np.arange(24, 24 + 12), [79] * 4])
    for fn in (ref.attn_density_plain, ops.attn_density):
        by_int = fn(q, k, v, q_pos, seq_len, 0, 0, True, form)
        by_tensor = fn(q, k, v, q_pos, torch.tensor(seq_len,
                                                    dtype=torch.int32),
                       0, 0, True, form)
        for a, b in zip(by_int, by_tensor):
            assert a.dtype == b.dtype
            assert a.view(torch.int16 if a.dtype == torch.bfloat16
                          else torch.int32).equal(
                b.view(torch.int16 if b.dtype == torch.bfloat16
                       else torch.int32))


def _extend_once(exe, arenas, seed=0):
    n0, M = 4, 10
    prompt = np.random.default_rng(seed).integers(1, exe.model.cfg.vocab,
                                                  M)
    pt16, pt8, qmask = _rows(exe, 1, [n0 + M - 1], exe.quant_resident,
                             seed)
    return exe.paged_extend(arenas, prompt, n0, pt16, pt8, qmask)


def test_no_cross_executor_graphs_after_gc():
    """A second executor (the first garbage-collected, so it may take its
    id()) holds graphs of its own only, and the first's entries die with
    it: no process-wide cache outlives an executor."""
    _, _, tmodel, tparams = _models("reduced")
    exe_a = TExecutor(tmodel, tparams, _cfg(TConfig, False), "cpu")
    _extend_once(exe_a, exe_a.init_arenas())
    (key,) = exe_a.graphs.keys()
    dead = weakref.ref(exe_a.graphs.entry(key))
    del exe_a
    gc.collect()
    assert dead() is None
    exe_b = TExecutor(tmodel, tparams, _cfg(TConfig, False), "cpu")
    assert len(exe_b.graphs) == 0 and exe_b.graphs.calls == 0
    _extend_once(exe_b, exe_b.init_arenas())
    assert exe_b.graphs.keys() == [key] and exe_b.graphs.calls == 1


def _fake_body(scale):
    def body(inp):
        return (inp["x"] * scale,)
    return graphs.capturable(body)


def test_graph_cache_is_bounded_lru():
    """At most GRAPH_CACHE_MAX entries (the reference's _JIT_CACHE_MAX),
    the least recently used dropped first."""
    n = graphs.GRAPH_CACHE_MAX
    assert n == 64
    cache = graphs.GraphCache("cpu")
    arenas = {"k16": torch.zeros(1)}
    spec = {"x": ((2,), torch.int64)}

    def call(i, x):
        return cache.run(arenas, ("decode", i, False), spec,
                         lambda: _fake_body(i), {"x": np.array(x)})[0]

    for i in range(n + 2):
        assert call(i, [i, 1]).tolist() == [i * i, i]
    assert cache.keys() == [("decode", i, False) for i in range(2, n + 2)]
    # a hit moves its entry to the end (its body kept): the oldest goes
    assert call(2, [3, 3]).tolist() == [6, 6]
    call(n + 2, [1, 1])
    assert cache.keys() == [("decode", i, False)
                            for i in [*range(4, n + 2), 2, n + 2]]
    assert cache.calls == n + 4 and cache.drops == 0


def test_graph_cache_refuses_an_unmarked_body():
    cache = graphs.GraphCache("cpu")
    with pytest.raises(TypeError):
        cache.run({"k16": torch.zeros(1)}, ("extend", 16, False),
                  {"x": ((1,), torch.int64)}, lambda: (lambda inp: ()),
                  {"x": np.array([1])})


@pytest.mark.parametrize("quant", [False, True])
def test_rebuilt_arenas_drop_the_graphs(quant):
    _, _, tmodel, tparams = _models("reduced")
    exe = TExecutor(tmodel, tparams, _cfg(TConfig, quant), "cpu")
    arenas = exe.init_arenas()
    _extend_once(exe, arenas)
    assert len(exe.graphs) == 1
    rebuilt = exe.init_arenas()
    assert len(exe.graphs) == 0 and exe.graphs.drops == 1
    # a call over arenas other than the bound ones drops what it holds
    _extend_once(exe, rebuilt)
    _extend_once(exe, arenas)
    assert len(exe.graphs) == 1 and exe.graphs.drops == 2
    assert exe.graphs.calls == 3


def test_launch_count_credit_round_trip():
    before = kernels.launch_counts()
    try:
        kernels.reset_launch_counts()
        kernels.add_launch_counts({"attn_density": 3,
                                   "attn_density_with_density": 3})
        kernels.add_launch_counts({"decode_mqattn": 2})
        got = kernels.launch_counts()
        assert got["attn_density"] == 3 and got["decode_mqattn"] == 2
        assert sum(got.values()) == 8
        kernels.set_launch_counts(before)
        assert kernels.launch_counts() == before
    finally:
        kernels.set_launch_counts(before)
