"""Port's dense model vs the JAX package's, on the reduced llama2-7b.

The ``models/common`` functions one by one, then the serving entries
teacher-forced: ``recompute`` (the prefill-append), ``extend_paged``
and ``decode_paged`` on the same weights, tokens and page tables.

Tolerances.  Functions computed in fp32 end to end (RoPE tables,
masks, softmax densities of fp32 scores) agree to 1e-5: the two
frameworks sum in different orders.  Anything that passes through a
bf16 matmul or a bf16 cast agrees to bf16 level: XLA on the CPU may
keep fp32 between fused bf16 elementwise ops where PyTorch rounds each
one, so values differ by a few bf16 ulps (2^-8 relative each) and the
difference grows through the layers (measured: hidden states 2 bf16
ulps apart, logits 0.7% of their range).  Logits and hidden states are
compared with atol = 0.02 * max|ref| + rtol 0.02; densities (fp32
softmax mass of bf16-derived scores, measured 2e-6 apart) with 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from _torch_parity import bf16_pair, tiny_pair, to_np, to_torch
from repro.models import common as JC
from repro_torch.models import common as TC


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


# --------------------------------------------------------------------- #
# common functions
# --------------------------------------------------------------------- #
def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair(rng.standard_normal((2, 5, 64)).astype(np.float32))
    sc = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    out_j = JC.rms_norm(xj, jnp.asarray(sc), 1e-6)
    out_t = TC.rms_norm(xt, torch.from_numpy(sc), 1e-6)
    assert out_t.dtype == torch.bfloat16
    # one bf16 rounding of an fp32 value: at most 1 ulp apart
    np.testing.assert_allclose(to_np(out_t), to_np(out_j), rtol=2 ** -7)


@pytest.mark.parametrize("positions", [np.arange(9), np.array([[3], [40]])])
def test_rope(positions):
    rng = np.random.default_rng(1)
    cj, sj = JC.rope_angles(jnp.asarray(positions, jnp.int32), 16, 10000.0)
    ct, st = TC.rope_angles(torch.from_numpy(positions), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    shape = positions.shape + (4, 16) if positions.ndim == 1 else \
        (2, 1, 4, 16)
    xj, xt = bf16_pair(rng.standard_normal(shape).astype(np.float32))
    out_j = JC.apply_rope(xj, cj, sj)
    out_t = TC.apply_rope(xt, ct, st)
    np.testing.assert_allclose(to_np(out_t), to_np(out_j), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("window,n_sinks", [(0, 0), (5, 2)])
def test_causal_window_mask(window, n_sinks):
    q = np.array([0, 3, 7, 20, 31])
    k = np.arange(32)
    mj = JC.causal_window_mask(jnp.asarray(q), jnp.asarray(k), window,
                               n_sinks)
    mt = TC.causal_window_mask(torch.from_numpy(q), torch.from_numpy(k),
                               window, n_sinks)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_gqa_attention_with_density():
    rng = np.random.default_rng(2)
    B, Sq, Sk, H, KV, hd = 1, 8, 24, 4, 2, 16
    qj, qt = bf16_pair(rng.standard_normal((B, Sq, H, hd)).astype(np.float32))
    kj, kt = bf16_pair(rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))
    vj, vt = bf16_pair(rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))
    q_pos = np.array([10, 11, 12, 13, 14, 15, 23, 23])    # with bucket pads
    k_pos = np.arange(Sk)
    mj = JC.causal_window_mask(jnp.asarray(q_pos), jnp.asarray(k_pos))
    mj = mj & (jnp.asarray(k_pos) < 16)[None, :]
    mt = TC.causal_window_mask(torch.from_numpy(q_pos),
                               torch.from_numpy(k_pos))
    mt = mt & (torch.from_numpy(k_pos) < 16)[None, :]
    aj = JC.gqa_attention(qj, kj, vj, mj, want_density=True)
    at = TC.gqa_attention(qt, kt, vt, mt, want_density=True)
    _close_bf16(aj.out, at.out, 0.02)
    np.testing.assert_allclose(at.key_density.numpy(),
                               np.asarray(aj.key_density), atol=1e-5)


@pytest.mark.parametrize("cur_pos", [np.int64(13), np.array([5, 17])])
def test_decode_attention_with_mass(cur_pos):
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 32, 4, 2, 16
    qj, qt = bf16_pair(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    kj, kt = bf16_pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    vj, vt = bf16_pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32))
    oj, mj = JC.decode_attention(qj, kj, vj, jnp.asarray(cur_pos),
                                 want_density=True)
    ot, mt = TC.decode_attention(qt, kt, vt, torch.as_tensor(cur_pos),
                                 want_density=True)
    _close_bf16(oj, ot, 0.02)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)


def test_swiglu():
    rng = np.random.default_rng(4)
    xj, xt = bf16_pair(rng.standard_normal((2, 3, 64)).astype(np.float32))
    ws = [bf16_pair((0.1 * rng.standard_normal(s)).astype(np.float32))
          for s in ((64, 128), (64, 128), (128, 64))]
    oj = JC.swiglu(xj, *(w[0] for w in ws))
    ot = TC.swiglu(xt, *(w[1] for w in ws))
    _close_bf16(oj, ot, 0.03)


@pytest.mark.parametrize("pos", [np.int64(5), np.array([2, 9])])
def test_ring_update(pos):
    rng = np.random.default_rng(5)
    cj, ct = bf16_pair(rng.standard_normal((2, 12, 2, 4)).astype(np.float32))
    nj, nt = bf16_pair(rng.standard_normal((2, 1, 2, 4)).astype(np.float32))
    out_j = JC.ring_update(cj, nj, jnp.asarray(pos))
    out_t = TC.ring_update(ct, nt, torch.as_tensor(pos))
    np.testing.assert_array_equal(to_np(out_t), to_np(out_j))


def test_paged_cache_view():
    rng = np.random.default_rng(6)
    arena = rng.standard_normal((3, 6, 4, 2, 8)).astype(np.float32)
    pt = np.array([[1, 4, 0], [5, 2, 3]], np.int32)
    aj, at = bf16_pair(arena)
    vj = JC.paged_cache_view({"k16": aj}, ("k",), jnp.asarray(pt))
    vt = TC.paged_cache_view({"k16": at}, ("k",), torch.from_numpy(pt).long())
    np.testing.assert_array_equal(to_np(vt["k"]), to_np(vj["k"]))


# --------------------------------------------------------------------- #
# model entries, teacher-forced
# --------------------------------------------------------------------- #
def test_converted_weights_are_bit_identical():
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair()
    np.testing.assert_array_equal(
        tparams["embed"].view(torch.int16).numpy(),
        np.asarray(jparams["embed"]).view(np.int16))
    np.testing.assert_array_equal(
        tparams["layers"]["w_down"].view(torch.int16).numpy(),
        np.asarray(jparams["layers"]["w_down"]).view(np.int16))


def test_recompute_prefill_append_matches():
    """Prefill 24 tokens (bucket-padded to 32 at the pad position, as the
    executor does), then append 8 more at [24, 32): hidden states,
    logits, densities and cache rows agree."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair()
    S, pad = 64, 63
    rng = np.random.default_rng(7)
    toks = rng.integers(1, jcfg.vocab, 32).astype(np.int32)
    jc = jmodel.init_cache(1, S)
    tc = tmodel.init_cache(1, S)
    for lo, hi, bucket in ((0, 24, 32), (24, 32, 16)):
        M = hi - lo
        pos = np.concatenate([np.arange(lo, hi), np.full(bucket - M, pad)]
                             ).astype(np.int32)
        tk = np.concatenate([toks[lo:hi], np.zeros(bucket - M, np.int32)])
        jc, jx, jd = jmodel.recompute(jparams, jnp.asarray(tk)[None],
                                      jnp.asarray(pos), jc, hi,
                                      want_density=True)
        tc, tx, td = tmodel.recompute(tparams, torch.from_numpy(tk).long()[None],
                                      torch.from_numpy(pos).long(), tc, hi,
                                      want_density=True)
        _close_bf16(jx[:, :M], tx[:, :M])
        jl = np.asarray((jx[:, M - 1] @ jmodel.head_weight(jparams)
                         ).astype(jnp.float32))
        tl = (tx[:, M - 1] @ tmodel.head_weight(tparams)).float().numpy()
        _close_bf16(jl, tl)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
        for n in ("k", "v"):
            _close_bf16(np.asarray(jc[n])[:, :, :hi].astype(np.float32),
                        to_np(tc[n])[:, :, :hi])


def _paged_setup(jcfg, n_pages=10, cs=16):
    L, KV, hd = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
    return np.zeros((L, n_pages, cs, KV, hd), np.float32)


def test_extend_then_decode_paged_teacher_forced():
    """extend_paged a 20-token prompt into pages [3, 7, ...], then five
    decode_paged rounds fed the SAME tokens in both packages (teacher
    forcing: greedy picks are not compared).  Logits, per-key mass and
    the arena pages agree at bf16 level after every step."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair()
    cs, C = 16, 4                        # 4 chunks per row: S = 64
    arena0 = _paged_setup(jcfg)
    aj = {"k16": jnp.asarray(arena0).astype(jnp.bfloat16),
          "v16": jnp.asarray(arena0).astype(jnp.bfloat16)}
    at = {"k16": to_torch(np.asarray(aj["k16"])),
          "v16": to_torch(np.asarray(aj["v16"]))}
    pt = np.array([[3, 7, 0, 0]], np.int32)
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, jcfg.vocab, 20).astype(np.int32)
    pos = np.concatenate([np.arange(20), np.full(12, 63)]).astype(np.int32)
    tk = np.concatenate([prompt, np.zeros(12, np.int32)])
    aj, jx, jd = jmodel.extend_paged(jparams, jnp.asarray(tk)[None],
                                     jnp.asarray(pos), aj, jnp.asarray(pt),
                                     None, None, 20, want_density=True)
    at, tx, td = tmodel.extend_paged(tparams, torch.from_numpy(tk).long()[None],
                                     torch.from_numpy(pos).long(), at,
                                     torch.from_numpy(pt).long(), 20,
                                     want_density=True)
    _close_bf16(jx[:, :20], tx[:, :20])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    feed = rng.integers(1, jcfg.vocab, 5)
    for step, tok in enumerate(feed):
        p = 20 + step
        aj, jl, jm = jmodel.decode_paged(
            jparams, jnp.asarray([[tok]], jnp.int32), aj, jnp.asarray(pt),
            None, None, jnp.asarray([p], jnp.int32), want_density=True)
        at, tl, tm = tmodel.decode_paged(
            tparams, torch.tensor([[int(tok)]]), at,
            torch.from_numpy(pt).long(), torch.tensor([p]),
            want_density=True)
        _close_bf16(jl, tl)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)
    for n in ("k16", "v16"):
        for page in (3, 7):
            _close_bf16(np.asarray(aj[n])[:, page].astype(np.float32),
                        to_np(at[n])[:, page])
        # pages no row owns stay untouched (zero) in both
        np.testing.assert_array_equal(to_np(at[n])[:, 5], 0)
