"""Port's chunk codec vs the JAX package's codec.

The plain PyTorch ``quantize_ref``/``dequantize_ref`` of
``repro_torch.kernels.ref`` against ``repro.kernels.ref`` and the
interpret-mode Pallas kernels of ``repro.kernels.chunk_quant``, over
the sweep of tests/test_kernels.py.

Tolerance: none against the codec as the reference serves it.  Its
``ChunkCodec`` runs the oracle under ``jax.jit``, and there XLA turns
``max|x| / qmax`` into ``max|x| * fl32(1/qmax)`` (the interpret-mode
Pallas kernel, also jitted, does the same).  The port computes that
product, so codes, scales and dequantized values are bit-identical in
fp32 and bf16 to the jitted oracle and to the interpret kernel.  The
un-jitted oracle divides, and its scales differ from its own jitted
form by up to 1 ulp: against it the port holds to 1 ulp in scales and
one code step in values.  The CUDA kernels are held against the plain
PyTorch versions on the card (``chip_smoke.py`` and
tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.kernels import chunk_quant as jcq
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SHAPES = [(16, 128), (16, 384), (32, 100), (8, 512), (4, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, bits, dtype_name):
    """Same values in both frameworks: numpy fp32 from a seed, cast to
    the working dtype by JAX, bits carried to torch unchanged."""
    T, F = shape
    rng = np.random.default_rng(T * F + bits)
    x32 = (rng.standard_normal(shape) * 3).astype(np.float32)
    jdt, tdt = DTYPES[dtype_name]
    xj = jnp.asarray(x32).astype(jdt)
    xn = np.asarray(xj)
    if dtype_name == "bfloat16":
        xt = torch.from_numpy(xn.view(np.int16).copy()).view(torch.bfloat16)
    else:
        xt = torch.from_numpy(xn.copy())
    return xj, xt


def _bits_of(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits_of(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


_JIT_QUANT = jax.jit(jref.quantize_ref, static_argnums=1)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_matches_jax_ref(bits, shape, dtype):
    """Bit-exact against the oracle as the reference's codec runs it
    (jitted)."""
    xj, xt = _inputs(shape, bits, dtype)
    p_j, s_j = _JIT_QUANT(xj, bits)
    p_t, s_t = tref.quantize_ref(xt, bits)
    np.testing.assert_array_equal(np.asarray(s_j), s_t.numpy())
    np.testing.assert_array_equal(np.asarray(p_j), p_t.numpy())


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_near_eager_oracle(bits, shape, dtype):
    """The un-jitted oracle divides by qmax: scales within 1 ulp,
    dequantized values within one code step."""
    T, _ = shape
    xj, xt = _inputs(shape, bits, dtype)
    p_j, s_j = jref.quantize_ref(xj, bits)
    p_t, s_t = tref.quantize_ref(xt, bits)
    np.testing.assert_array_max_ulp(np.asarray(s_j), s_t.numpy(), maxulp=1)
    d_j = np.asarray(jref.dequantize_ref(p_j, s_j, bits, T, jnp.float32))
    d_t = tref.dequantize_ref(p_t, s_t, bits, T, torch.float32).numpy()
    assert np.all(np.abs(d_j - d_t) <= s_t.numpy()[None, :] * 1.01 + 1e-7)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_matches_pallas_interpret(bits, shape, dtype):
    """Bit-exact against the interpret-mode Pallas kernel."""
    xj, xt = _inputs(shape, bits, dtype)
    p_k, s_k = jcq.quantize(xj, bits, interpret=True)
    p_t, s_t = tref.quantize_ref(xt, bits)
    np.testing.assert_array_equal(np.asarray(s_k), s_t.numpy())
    np.testing.assert_array_equal(np.asarray(p_k), p_t.numpy())


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("out", list(DTYPES))
def test_dequantize_matches_jax(bits, shape, out):
    """Same packed bytes + scales in -> identical bits out, against the
    jnp oracle and the interpret-mode Pallas kernel."""
    T, _ = shape
    xj, _ = _inputs(shape, bits, "float32")
    p_j, s_j = jref.quantize_ref(xj, bits)
    jdt, tdt = DTYPES[out]
    d_ref = jref.dequantize_ref(p_j, s_j, bits, T, jdt)
    d_k = jcq.dequantize(p_j, s_j, bits, T, jdt, interpret=True)
    d_t = tref.dequantize_ref(torch.from_numpy(np.asarray(p_j).copy()),
                              torch.from_numpy(np.asarray(s_j).copy()),
                              bits, T, tdt)
    np.testing.assert_array_equal(_jbits_of(d_ref), _bits_of(d_t))
    np.testing.assert_array_equal(_jbits_of(d_k), _bits_of(d_t))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_ops_route_cpu_tensors_to_plain_version(bits):
    """On the CPU the dispatch takes the plain version (and counts no
    kernel launch); round trip keeps the codes."""
    from repro_torch.kernels import chunk_quant
    _, xt = _inputs((16, 256), bits, "bfloat16")
    before = (chunk_quant.quantize.launches, chunk_quant.dequantize.launches)
    p, s = tops.chunk_quantize(xt, bits)
    p2, s2 = tref.quantize_ref(xt, bits)
    assert torch.equal(p, p2) and torch.equal(s, s2)
    d = tops.chunk_dequantize(p, s, bits, 16)
    assert d.dtype == torch.bfloat16 and d.shape == (16, 256)
    assert torch.equal(d, tref.dequantize_ref(p, s, bits, 16))
    after = (chunk_quant.quantize.launches, chunk_quant.dequantize.launches)
    assert before == after


def test_codec_refuses_bad_bits():
    x = torch.zeros(16, 8)
    with pytest.raises(ValueError):
        tref.quantize_ref(x, 3)
    with pytest.raises(ValueError):
        tref.quantize_ref(torch.zeros(3, 8), 2)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; they never run the
    plain version themselves."""
    from repro_torch.kernels import chunk_quant
    with pytest.raises(ValueError):
        chunk_quant.quantize(torch.zeros(16, 8), 8)
    with pytest.raises(ValueError):
        chunk_quant.dequantize(torch.zeros(16, 8, dtype=torch.int8),
                               torch.ones(8), 8, 16)


def test_quantize_leaves_refuses_cpu_tensors_and_bad_leaves():
    """The multi-leaf wrapper takes CUDA leaves only, and checks them
    before it builds or launches anything."""
    from repro_torch.kernels import chunk_quant
    before = chunk_quant.quantize.launches
    with pytest.raises(ValueError):
        chunk_quant.quantize_leaves([torch.zeros(16, 8)], 8)
    with pytest.raises(ValueError):
        chunk_quant.quantize_leaves([], 8)
    assert chunk_quant.quantize.launches == before


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_leaf_buffer_layout(bits):
    """``leaf_buffer`` lays every leaf's codes and scales out in one
    buffer, 256-byte aligned and disjoint (the kernel's vector stores
    need 16 bytes)."""
    from repro_torch.kernels import chunk_quant
    Fs = (131072, 384, 100)
    buf, outs = chunk_quant.leaf_buffer(16, Fs, bits, "cpu")
    spans = []
    for F, (p, s) in zip(Fs, outs):
        assert p.shape == (16 * bits // 8, F) and s.shape == (F,)
        for t in (p, s):
            lo = t.data_ptr() - buf.data_ptr()
            assert lo % 256 == 0
            spans.append((lo, lo + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= buf.numel()


# --------------------------------------------------------------------- #
# decode_mqattn and mixed-cache decode attention
#
# Tolerances: out (bf16) within 2^-7 * max|out_ref| — two bf16 ulps of
# the largest value: the two frameworks sum the fp32 dot products and
# the PV product in different orders (and XLA's exp is not torch's), so
# a value near a bf16 rounding boundary can round the other way.  The
# per-key mass (fp32 probabilities <= 1) within 1e-6.
# --------------------------------------------------------------------- #
from _torch_parity import bf16_pair, to_torch
from repro.kernels import decode_qattn as jdq
from repro.models import common as JC
from repro_torch.models import common as TC


def _mixed_inputs(B, S, H, KV, hd, seed, quant_share=0.5, cs=16):
    """The same mixed cache in both frameworks: bf16 K/V, their
    decode-grid int8 codes and scales, and a quant mask set on whole
    16-token chunks.  -> (jax tuple, torch tuple, n_valid numpy)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q32, k32, v32 = f32(B, H, hd), f32(B, S, KV, hd), f32(B, S, KV, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16)
                  for a in (q32, k32, v32))
    jkq, jks = jref.quantize_token_head_ref(f32(B, S, KV, hd) * 2)
    jvq, jvs = jref.quantize_token_head_ref(f32(B, S, KV, hd) * 2)
    chunks = rng.random((B, -(-S // cs))) < quant_share
    qm = np.repeat(chunks, cs, axis=1)[:, :S]
    j = (jq, jk, jv, jkq, jvq, jks, jvs, jnp.asarray(qm))
    t = tuple(to_torch(np.asarray(a)) for a in j)
    return j, t


def _n_valid(B, S, seed):
    rng = np.random.default_rng(seed + 100)
    nv = rng.integers(1, S + 1, B)
    nv[0] = S
    if B > 1:
        nv[1] = 1
    return nv


def _assert_out_close(ref, got):
    ref = np.asarray(ref, np.float32) if not isinstance(ref, torch.Tensor) \
        else ref.float().numpy()
    got = got.float().numpy()
    assert np.abs(got - ref).max() <= 2 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("window,n_sinks", [(0, 0), (24, 4)])
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 64, 4, 2, 16),
                                         (3, 300, 4, 4, 16)])
def test_decode_mqattn_ref_matches_reference(B, S, H, KV, hd, window,
                                             n_sinks):
    """The port's oracle against the reference's, and its plain kernel
    version (fused form) against the reference's interpret-mode Pallas
    kernel: same inputs, n_valid per row in [1, S]."""
    j, t = _mixed_inputs(B, S, H, KV, hd, seed=S + H)
    nv = _n_valid(B, S, seed=S)
    o_ref = jref.decode_mqattn_ref(*j, jnp.asarray(nv), window, n_sinks)
    o_pal = jdq.decode_mqattn(*j, jnp.asarray(nv), window, n_sinks,
                              interpret=True)
    o_t = tref.decode_mqattn_ref(*t, torch.from_numpy(nv), window, n_sinks)
    _assert_out_close(o_ref, o_t)
    o_plain = tops.decode_mqattn(*t, torch.from_numpy(nv), window, n_sinks)
    _assert_out_close(o_pal, o_plain)
    _assert_out_close(o_ref, o_plain)


@pytest.mark.parametrize("want_density", [False, True])
@pytest.mark.parametrize("S,cur", [(512, "rows"), (512, "scalar"),
                                   (4096, "rows")])
def test_mixed_decode_attention_matches_reference(S, cur, want_density):
    """The port's CPU dispatch (plain select below 4096 positions, the
    blocked scan from 4096 on) against the reference's, with and
    without the per-key mass."""
    B, H, KV, hd = 2, 4, 2, 16
    (jq, *jrest), (tq, *trest) = _mixed_inputs(B, S, H, KV, hd, seed=S)
    nv = _n_valid(B, S, seed=S) if cur == "rows" else np.int64(S // 3)
    for window, n_sinks in ((0, 0), (256, 4)):
        rj = JC.mixed_decode_attention(jq[:, None], *jrest,
                                       jnp.asarray(nv, jnp.int32), window,
                                       n_sinks, want_density)
        rt = TC.mixed_decode_attention(tq[:, None], *trest,
                                       torch.as_tensor(nv), window, n_sinks,
                                       want_density)
        if want_density:
            (rj, mj), (rt, mt) = rj, rt
            assert mt.dtype == torch.float32 and mt.shape == (B, S)
            np.testing.assert_allclose(mt.numpy(), np.asarray(mj),
                                       rtol=0, atol=1e-6)
        assert rt.shape == (B, 1, H, hd) and rt.dtype == torch.bfloat16
        _assert_out_close(rj, rt)


@pytest.mark.parametrize("select", [False, True])
def test_decode_mqattn_plain_forms_match_reference_paths(select):
    """The plain kernel version's two forms, each against the reference
    path it stands for: the select form against ``dequant_select`` +
    ``decode_attention``, the fused form against the blocked scan."""
    B, S, H, KV, hd = 2, 512, 8, 2, 16
    (jq, *jrest), t = _mixed_inputs(B, S, H, KV, hd, seed=7)
    nv = _n_valid(B, S, seed=7)
    if select:
        k = JC.dequant_select(jrest[0], jrest[2], jrest[4], jrest[6])
        v = JC.dequant_select(jrest[1], jrest[3], jrest[5], jrest[6])
        oj, mj = JC.decode_attention(jq[:, None], k, v,
                                     jnp.asarray(nv, jnp.int32),
                                     want_density=True)
    else:
        oj, mj = JC.mixed_decode_attention_blocked(
            jq[:, None], *jrest, jnp.asarray(nv, jnp.int32),
            want_density=True, block=128)
    ot, mt = tref.decode_mqattn_plain(*t, torch.from_numpy(nv),
                                      want_mass=True, select=select)
    _assert_out_close(np.asarray(oj)[:, 0], ot)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)


def test_decode_mqattn_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import decode_mqattn as kmq
    _, t = _mixed_inputs(1, 16, 4, 2, 16, seed=1)
    before = kmq.decode_mqattn.launches
    with pytest.raises(ValueError):
        kmq.decode_mqattn(*t, torch.ones(1, dtype=torch.int32))
    assert kmq.decode_mqattn.launches == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_token_head_quantizer_byte_equal_to_served_codec(dtype):
    """The decode-grid quantizer equals, byte for byte, the reference's
    served ``ChunkCodec.quantize_resident_blocks`` (its oracle under
    ``jax.jit``, where ``max|x| / 127`` becomes ``max|x| * fl32(1/127)``),
    and the dequantized blocks are bit-identical too."""
    from repro.core import chunks as jchunks
    from repro_torch.core import chunks as tchunks
    jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(11)
    bj, bt = {}, {}
    for n in ("k", "v"):
        x = jnp.asarray((rng.standard_normal((16, 4 * 2 * 16)) * 3
                         ).astype(np.float32)).astype(jdt)
        x = x.at[:, :16].set(0)                  # the 1e-8 scale floor
        bj[n], bt[n] = x, to_torch(np.asarray(x))
    hd = {"k": 16, "v": 16}
    qj = jchunks.ChunkCodec(("k", "v"), 16).quantize_resident_blocks(bj, hd)
    tc = tchunks.ChunkCodec(("k", "v"), 16, "cpu")
    qt = tc.quantize_resident_blocks(bt, hd)
    assert qj.shapes == qt.shapes and qj.n_tokens == qt.n_tokens
    for n in qj.data:
        for a, b in zip(qj.data[n], qt.data[n]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    dj = jchunks.ChunkCodec(("k", "v"), 16).dequantize_resident(qj)
    dt = tc.dequantize_resident(qt)
    for n in dj:
        np.testing.assert_array_equal(np.asarray(dj[n]).view(np.int16),
                                      dt[n].view(torch.int16).numpy())


# --------------------------------------------------------------------- #
# attn_density: extend attention with the Eq.-1 density
#
# Tolerances.  Flash form against the reference's oracle and its
# interpret-mode Pallas kernel on fp32 inputs: those of the reference's
# own test (tests/test_kernels.py): out rtol 2e-3 / atol 2e-3, density
# atol 2e-4.  Served form against the JAX ``gqa_attention`` on bf16
# inputs: out within two bf16 ulps of the largest value (sums in another
# order), density within 1e-5 (fp32 probabilities); against the port's
# own ``gqa_attention`` bit-identical (the CPU serving path before the
# kernel existed).
# --------------------------------------------------------------------- #
from repro.kernels import attn_density as kad

AD_FLASH_CASES = [
    dict(B=2, Sq=64, Sk=64, H=4, KV=2, hd=32, window=0, n_sinks=0),
    dict(B=1, Sq=100, Sk=100, H=8, KV=8, hd=64, window=0, n_sinks=0),
    dict(B=1, Sq=128, Sk=128, H=4, KV=1, hd=16, window=48, n_sinks=8),
    dict(B=2, Sq=48, Sk=48, H=6, KV=3, hd=8, window=0, n_sinks=0),
]


@pytest.mark.parametrize("case", AD_FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_attn_density_plain_flash_matches_reference(case):
    """The flash form with q_pos = arange(Sq), seq_len = Sk against the
    reference's oracle and its interpret-mode Pallas kernel (bq = bk =
    32), on the reference test's four cases, fp32 inputs."""
    c = case
    rng = np.random.default_rng(sum(c.values()))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f32(c["B"], c["Sq"], c["H"], c["hd"])
    k, v = (f32(c["B"], c["Sk"], c["KV"], c["hd"]) for _ in range(2))
    o_ref, d_ref = jref.attn_density_ref(q, k, v, c["window"], c["n_sinks"])
    o_pal, d_pal = kad.attn_density(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), c["window"], c["n_sinks"],
                                    interpret=True, bq=32, bk=32)
    o_t, d_t = tref.attn_density_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=c["window"], n_sinks=c["n_sinks"], form="flash")
    assert o_t.dtype == torch.float32 and d_t.shape == (c["B"], c["Sk"])
    for o_j, d_j in ((o_ref, d_ref), (o_pal, d_pal)):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=2e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=2e-3,
                                   atol=2e-4)


AD_SERVED_CASES = [
    # (B, Sq, Sk, H, KV, hd, q_pos, seq_len, window, n_sinks)
    (1, 16, 64, 4, 4, 16, list(range(30, 42)) + [63] * 4, 42, 0, 0),
    (2, 16, 64, 8, 2, 16, list(range(30, 42)) + [63] * 4, 42, 16, 2),
    (1, 12, 48, 8, 1, 32, [3, 9, 17, 18, 30, 31, 32, 40, 41, 47, 47, 47],
     44, 0, 0),
    # window 8, no sinks: the pad rows at 63 see no key (uniform p)
    (1, 16, 64, 4, 2, 16, list(range(30, 42)) + [63] * 4, 42, 8, 0),
]


@pytest.mark.parametrize("case", AD_SERVED_CASES, ids=lambda c: str(c[:8]))
def test_attn_density_plain_served_matches_gqa_attention(case):
    """The served form against the JAX ``gqa_attention`` under
    ``causal_window_mask(q_pos, k) & (k < seq_len)`` (what the
    reference's ``recompute`` serves): repeated pad positions, windows
    with and without sinks, G up to 8, rows that see no key; and
    bit-identical to the port's ``gqa_attention`` under that mask."""
    B, Sq, Sk, H, KV, hd, q_pos, seq_len, window, n_sinks = case
    rng = np.random.default_rng(Sq + Sk + H)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    (qj, qt), (kj, kt), (vj, vt) = (
        bf16_pair(f32(*s)) for s in ((B, Sq, H, hd), (B, Sk, KV, hd),
                                     (B, Sk, KV, hd)))
    qp = np.asarray(q_pos)
    kp = np.arange(Sk)
    mj = JC.causal_window_mask(jnp.asarray(qp), jnp.asarray(kp), window,
                               n_sinks) & (jnp.asarray(kp) < seq_len)[None]
    aj = JC.gqa_attention(qj, kj, vj, mj, want_density=True)
    o_t, d_t = tref.attn_density_plain(qt, kt, vt, torch.from_numpy(qp),
                                       seq_len, window, n_sinks, True,
                                       "served")
    _assert_out_close(np.asarray(aj.out).astype(np.float32), o_t)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(aj.key_density),
                               rtol=0, atol=1e-5)
    mt = TC.causal_window_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                               window, n_sinks)
    at = TC.gqa_attention(qt, kt, vt, mt & (torch.from_numpy(kp)
                                            < seq_len)[None],
                          want_density=True)
    assert torch.equal(o_t, at.out) and torch.equal(d_t, at.key_density)
    e = TC.extend_attention(qt, kt, vt, torch.from_numpy(qp), seq_len,
                            window, n_sinks, want_density=True)
    assert torch.equal(e.out, o_t) and torch.equal(e.key_density, d_t)


# --------------------------------------------------------------------- #
# decode_qattn: one-token attention over an all-int8 cache
#
# Tolerances.  Fused form against the reference's oracle and its
# interpret-mode Pallas kernel on fp32 q: those of the reference's own
# test, rtol 2e-4 / atol 2e-5.  Select form against the JAX
# ``decode_attention`` with scales on bf16 q: out within two bf16 ulps
# of the largest value, mass within 1e-6 (as decode_mqattn above).
# --------------------------------------------------------------------- #
DQ_CASES = [
    dict(B=2, S=96, H=8, KV=2, hd=32, nv=50, window=0, n_sinks=0),
    dict(B=1, S=200, H=4, KV=4, hd=64, nv=200, window=0, n_sinks=0),
    dict(B=3, S=128, H=8, KV=1, hd=16, nv=100, window=40, n_sinks=4),
]


def _int8_cache(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (B, S, KV, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.02, (B, S, KV)).astype(np.float32)
              for _ in range(2))
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("case", DQ_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_decode_qattn_plain_fused_matches_reference(case):
    """The fused form against the reference's oracle and its
    interpret-mode Pallas kernel (bs = 32) on the reference test's three
    cases."""
    c = case
    q, kq, vq, ks, vs = _int8_cache(c["B"], c["S"], c["H"], c["KV"],
                                    c["hd"], seed=c["S"] + c["H"])
    o_ref = jref.decode_qattn_ref(q, kq, vq, ks, vs, c["nv"], c["window"],
                                  c["n_sinks"])
    o_pal = jdq.decode_qattn(*(jnp.asarray(a) for a in (q, kq, vq, ks, vs)),
                             c["nv"], c["window"], c["n_sinks"],
                             interpret=True, bs=32)
    o_t = tref.decode_qattn_plain(
        *(torch.from_numpy(a) for a in (q, kq, vq, ks, vs)),
        torch.tensor(c["nv"]), c["window"], c["n_sinks"])
    assert o_t.dtype == torch.float32
    for o_j in (o_ref, o_pal):
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=2e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("cur,window,n_sinks", [("scalar", 0, 0),
                                                ("rows", 0, 0),
                                                ("rows", 24, 4)])
def test_decode_qattn_plain_select_matches_decode_attention(cur, window,
                                                            n_sinks):
    """The select form with the mass against the JAX ``decode_attention``
    with scales (the reference's all-int8 ``decode_step`` attention), and
    the port's ``decode_attention`` with scales routes to it."""
    B, S, H, KV, hd = 2, 64, 8, 2, 16
    q, kq, vq, ks, vs = _int8_cache(B, S, H, KV, hd, seed=3)
    qj, qt = bf16_pair(q)
    nv = _n_valid(B, S, seed=3) if cur == "rows" else np.int64(S // 3)
    oj, mj = JC.decode_attention(qj[:, None], jnp.asarray(kq),
                                 jnp.asarray(vq), jnp.asarray(nv, jnp.int32),
                                 k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs), window=window,
                                 n_sinks=n_sinks, want_density=True)
    t8 = [torch.from_numpy(a) for a in (kq, vq, ks, vs)]
    ot, mt = tref.decode_qattn_plain(qt, *t8, torch.as_tensor(nv), window,
                                     n_sinks, want_mass=True, select=True)
    _assert_out_close(np.asarray(oj)[:, 0], ot)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-6)
    od, md = TC.decode_attention(qt[:, None], t8[0], t8[1],
                                 torch.as_tensor(nv), k_scale=t8[2],
                                 v_scale=t8[3], window=window,
                                 n_sinks=n_sinks, want_density=True)
    assert torch.equal(od[:, 0], ot) and torch.equal(md, mt)


def test_new_ops_route_cpu_tensors_to_plain_versions():
    """``ops.attn_density`` and ``ops.decode_qattn`` take the plain
    versions for CPU tensors and count no kernel launch."""
    from repro_torch.kernels import attn_density as kad_t
    from repro_torch.kernels import decode_qattn as kdq_t
    before = (kad_t.attn_density.launches, kdq_t.decode_qattn.launches)
    rng = np.random.default_rng(4)
    _, q = bf16_pair(rng.standard_normal((1, 8, 4, 16)).astype(np.float32))
    _, k = bf16_pair(rng.standard_normal((1, 32, 2, 16)).astype(np.float32))
    qp = torch.arange(8, 16)
    for form in ("served", "flash"):
        o, d = tops.attn_density(q, k, k, qp, 16, form=form)
        o2, d2 = tref.attn_density_plain(q, k, k, qp, 16, form=form)
        assert torch.equal(o, o2) and torch.equal(d, d2)
    q8, kq, vq, ks, vs = _int8_cache(1, 32, 4, 2, 16, seed=5)
    t = [torch.from_numpy(a) for a in (kq, vq, ks, vs)]
    _, qb = bf16_pair(q8)
    o, m = tops.decode_qattn(qb, *t, 20, want_mass=True, select=True)
    o2, m2 = tref.decode_qattn_plain(qb, *t, 20, want_mass=True, select=True)
    assert torch.equal(o, o2) and torch.equal(m, m2)
    assert before == (kad_t.attn_density.launches,
                      kdq_t.decode_qattn.launches)


def test_new_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import attn_density as kad_t
    from repro_torch.kernels import decode_qattn as kdq_t
    q = torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(1, 32, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kad_t.attn_density(q, k, k, torch.arange(8, dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        kad_t.attn_density(q, k, k, torch.arange(8, dtype=torch.int32), 8,
                           form="blocked")
    kq = torch.zeros(1, 32, 2, 16, dtype=torch.int8)
    sc = torch.ones(1, 32, 2)
    with pytest.raises(ValueError):
        kdq_t.decode_qattn(q[:, 0], kq, kq, sc, sc,
                           torch.ones(1, dtype=torch.int32))
    assert kad_t.attn_density.launches == kdq_t.decode_qattn.launches == 0
