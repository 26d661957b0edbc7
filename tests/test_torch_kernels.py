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
