"""The port's VLM family (llama-3.2-vision-90b) against the JAX package.

Both packages run the reduced llama-3.2-vision (10 layers: two blocks of
4 self-attention layers + 1 gated cross-attention layer; d 64, 4 heads
over 2 KV heads, 16 image tokens of width 48) from the SAME weights:
the reference's ``init(PRNGKey(0))`` carried across bit for bit.  A
fresh model's tanh gates are zero, which would make every cross layer
add nothing; the parity tests open them (the same fp32 values in both
packages) so that the cross-attention and its FFN count.

* ``prefill`` with patches, in the reference's full-product branch and
  its blocked branch (a window, with the density): logits, the self
  layers' K/V, the image K/V ``xk`` / ``xv`` at bf16 level (atol 0.02 x
  max|ref|, rtol 0.02), the density within 1e-4 or one bf16 ulp of its
  largest value.
* 24 ``decode_step``s over the window cache carrying each package's own
  ``xk`` / ``xv``, teacher-forced: logits at bf16 level each step, the
  zero density row; then the reference's prefill/decode agreement on the
  port (last decode logits against the prefill's at 5e-2).
* The servable gate: ``build_model`` builds the family, its KVSpec is
  the reference's, and ``LLMService`` refuses it as the reference's
  executor does.
* The int8 cache (``init_cache(dtype=int8)``, which the dry run's int8
  decode cells build: no scales): ``decode_step`` over it against the
  reference's jitted one, from a zero cache at position 0 and from a
  cache of random codes at a later position, 6 steps each: every int8
  leaf byte-equal each step, logits at the bf16 decode's level (atol
  0.02 x max|ref|, rtol 0.02).  Under it, ``common.to_int8`` against
  jnp's bf16 / fp32 -> int8 conversion (toward zero, saturating, NaN to
  0) and ``common.pv_product`` against jnp's int8 einsum (wrapped mod
  256) across its key chunks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from conftest import make_batch
from repro_torch.models.convert import params_from_jax

NAME = "llama-3.2-vision-90b"
GATES = {"gate_attn": [0.5, -0.75], "gate_ffn": [0.25, 1.0]}
_OPEN = {}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def _open_pair():
    """``tiny_pair(NAME)`` with the cross layers' gates set to GATES in
    both packages' weights."""
    if not _OPEN:
        jcfg, jmodel, jparams, tcfg, tmodel, _ = tiny_pair(NAME)
        jparams = dict(jparams)
        jparams["cross_layers"] = dict(jparams["cross_layers"])
        for k, v in GATES.items():
            jparams["cross_layers"][k] = jnp.asarray(v, jnp.float32)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
        _OPEN["pair"] = (jcfg, jmodel, jparams, tcfg, tmodel, tparams)
    return _OPEN["pair"]


def _batch(jcfg, B, S):
    b = make_batch(jcfg, B, S)
    return ({"tokens": b["tokens"], "patches": b["patches"]},
            {"tokens": to_torch(np.asarray(b["tokens"])).long(),
             "patches": to_torch(np.asarray(b["patches"]))})


def test_reduced_config_weights_and_spec_match_reference():
    """The port's configs are the reference's; the converted weights are
    the reference's bit for bit, the self layers stacked over 8 and the
    cross layers over 2; the KVSpec is the reference's (not servable,
    image K/V as state leaves)."""
    import dataclasses
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    assert tmodel._counts() == jmodel._counts() == (8, 2, 4)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n_t = sum(len(v) if isinstance(v, dict) else 1 for v in tparams.values())
    assert len(flat_j) == n_t
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        np.testing.assert_array_equal(to_np(t), np.asarray(leaf).astype(
            np.float32))
    assert tuple(tparams["cross_layers"]["gate_attn"].shape) == (2,)
    assert tmodel.kv_spec().__dict__ == jmodel.kv_spec().__dict__
    with pytest.raises(ValueError, match="stacked"):
        bad = jax.tree.map(np.asarray, jparams)
        bad["cross_layers"] = dict(bad["cross_layers"],
                                   wq=bad["cross_layers"]["wq"][:1])
        params_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("window,dens", [(0, True), (8, True), (8, False)],
                         ids=["full", "blocked", "flash"])
def test_prefill_matches_reference(window, dens):
    """A 24-token prefill of two rows with 16 image tokens each: logits,
    k / v (8 self layers), xk / xv (2 cross layers) at bf16 level, the
    density averaged over the self layers as stated above."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _open_pair()
    jb, tb = _batch(jcfg, 2, 24)
    jout = jax.jit(lambda p, b: jmodel.prefill(
        p, b, want_density=dens, window=window, n_sinks=2))(jparams, jb)
    tout = tmodel.prefill(tparams, tb, want_density=dens, window=window,
                          n_sinks=2)
    _close_bf16(jout.logits, tout.logits)
    assert int(tout.cache["pos"]) == 24
    for n in ("k", "v", "xk", "xv"):
        assert tout.cache[n].shape == jout.cache[n].shape, n
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])
    if dens:
        jd = np.asarray(jout.density)
        tol = max(1e-4, _bf16_ulp(float(np.max(np.abs(jd)))))
        np.testing.assert_allclose(tout.density.numpy(), jd, atol=tol,
                                   rtol=0)
    else:
        assert tout.density is None


def test_decode_matches_reference_and_agrees_with_prefill():
    """24 teacher-forced decode steps of two rows over the window cache,
    each package carrying its own prefill's image K/V: logits at bf16
    level every step, new K/V written in place, the (B, 1) zero density
    row; the last step's logits agree with the port's prefill of the
    same 24 tokens within 5e-2 (the reference's own agreement test)."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _open_pair()
    B, S = 2, 24
    jb, tb = _batch(jcfg, B, S)
    jpf = jax.jit(lambda p, b: jmodel.prefill(p, b))(jparams, jb)
    tpf = tmodel.prefill(tparams, tb)
    jc = jmodel.init_cache(B, S)
    jc["xk"], jc["xv"] = jpf.cache["xk"], jpf.cache["xv"]
    tc = tmodel.init_cache(B, S)
    tc["xk"], tc["xv"] = tpf.cache["xk"], tpf.cache["xv"]
    dec = jax.jit(jmodel.decode_step)
    for i in range(S):
        jout = dec(jparams, jb["tokens"][:, i:i + 1], jc)
        tout, mass = tmodel.decode_step(tparams, tb["tokens"][:, i:i + 1],
                                        tc, want_density=True)
        _close_bf16(jout.logits, tout.logits)
        assert tout.cache["k"] is tc["k"] and mass.shape == (B, 1)
        assert not mass.any()
        jc, tc = jout.cache, tout.cache
    assert int(tc["pos"]) == S
    for n in ("k", "v"):
        _close_bf16(np.asarray(jc[n]), tc[n])
    np.testing.assert_allclose(tout.logits.numpy(), tpf.logits.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_servable_gate(tmp_path):
    """``build_model`` builds the VLM (the registry's family) on the CPU;
    its window cache has the image K/V leaves and no mixed layout; the
    port's ``LLMService`` refuses it with the reference executor's
    ``not servable`` error, and so does the reference's."""
    from repro.core.service import LLMSConfig as JConfig
    from repro.core.service import LLMService as JService
    from repro_torch.core.service import LLMSConfig, LLMService
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    cache = tmodel.init_cache(1, 32)
    assert set(cache) == {"k", "v", "xk", "xv", "pos"}
    assert tuple(cache["xk"].shape) == (2, 1, 16, 2, 16)
    with pytest.raises(ValueError, match="does not support cache layout"):
        tmodel.init_cache(1, 32, layout="mixed")
    with pytest.raises(ValueError, match="not servable"):
        LLMService(tmodel, tparams, LLMSConfig(swap_dir=str(tmp_path)),
                   device="cpu")
    with pytest.raises(ValueError, match="not servable"):
        JService(jmodel, jparams, JConfig(swap_dir=str(tmp_path)))


# --------------------------------------------------------------------- #
# the int8 cache without scales: the reference's dtype flow
# --------------------------------------------------------------------- #
INT8_LEAVES = ("k", "v", "xk", "xv")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_to_int8_converts_as_the_reference(dtype):
    """``C.to_int8`` against ``jnp.asarray(x, dtype).astype(jnp.int8)``
    over +-300 in steps of 1/8, fractions of +-1, the edges of the int8
    range, +-0, +-inf and NaN; ``.to(torch.int8)`` would wrap 300."""
    from repro_torch.models import common as C
    x = np.concatenate([
        np.arange(-300, 300.125, 0.125), np.linspace(-1, 1, 41),
        [0.7, -1.6, 127.4, 127.9, 128.0, 128.5, -128.4, -128.9, -129.0,
         0.0, -0.0, np.inf, -np.inf, np.nan]]).astype(np.float32)
    want = np.asarray(jnp.asarray(x, dtype).astype(jnp.int8))
    got = C.to_int8(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_pv_product_wraps_as_the_reference():
    """``C.pv_product`` over an int8 v against the reference's
    ``einsum(p.astype(int8), v)``: p of whole values up to +-127 (which
    truncate to themselves) and fractions, 2,500 keys over three key
    chunks, so the exact sum passes int8's range and wraps mod 256; a
    bf16 v gives ``einsum(p.to(v.dtype), v)`` unchanged."""
    from repro_torch.models import common as C
    rng = np.random.default_rng(11)
    B, KV, G, Sq, Sk, vd = 2, 2, 3, 1, 2500, 8
    p = rng.integers(-127, 128, (B, KV, G, Sq, Sk)).astype(np.float32)
    p[..., ::7] = rng.random(p[..., ::7].shape, dtype=np.float32)
    v = rng.integers(-128, 128, (B, Sk, KV, vd), dtype=np.int8)
    want = np.asarray(jnp.einsum("bngqk,bknd->bqngd",
                                 jnp.asarray(p).astype(jnp.int8),
                                 jnp.asarray(v)))
    got = C.pv_product(torch.from_numpy(p), torch.from_numpy(v))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.einsum("bngqk,bknd->bqngd", np.trunc(p).astype(np.int64),
                      v.astype(np.int64))
    assert np.abs(exact).max() > 127            # the sum did wrap
    vb = torch.from_numpy(rng.standard_normal((B, Sk, KV, vd),
                                              dtype=np.float32)).bfloat16()
    pt = torch.softmax(torch.from_numpy(p), dim=-1)
    assert torch.equal(C.pv_product(pt, vb), torch.einsum(
        "bngqk,bknd->bqngd", pt.to(torch.bfloat16), vb))


@pytest.mark.parametrize("filled", [False, True], ids=["zero", "codes"])
def test_int8_decode_matches_reference(filled):
    """``decode_step`` over ``init_cache(dtype=int8)`` (no scales) of two
    rows, 40 deep, against the reference's jitted one on the same
    weights (gates opened), 6 steps: from a zero cache at position 0,
    and from a cache of random codes in [-127, 127] (numpy seed 5, as
    the dry run's ``_fill_cache`` fills it) at position 30.  Each step:
    k / v / xk / xv byte-equal, logits at the bf16 decode's level."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _open_pair()
    B, S, steps = 2, 40, 6
    rng = np.random.default_rng(5)
    tc = tmodel.init_cache(B, S, dtype=torch.int8)
    jc = jmodel.init_cache(B, S, dtype=jnp.int8)
    assert set(tc) == set(jc) == {*INT8_LEAVES, "pos"}
    pos = 0
    if filled:
        pos = 30
        for n in INT8_LEAVES:
            codes = rng.integers(-127, 128, tc[n].shape, dtype=np.int8)
            tc[n].copy_(torch.from_numpy(codes))
            jc[n] = jnp.asarray(codes)
    tc["pos"].fill_(pos)
    jc["pos"] = jnp.asarray(pos, jnp.int32)
    tokens = rng.integers(1, jcfg.vocab, (B, steps))
    dec = jax.jit(jmodel.decode_step)
    for i in range(steps):
        jout = dec(jparams, jnp.asarray(tokens[:, i:i + 1], jnp.int32), jc)
        tout = tmodel.decode_step(
            tparams, torch.from_numpy(tokens[:, i:i + 1]).long(), tc)
        for n in INT8_LEAVES:
            assert tout.cache[n].dtype == torch.int8
            np.testing.assert_array_equal(tout.cache[n].numpy(),
                                          np.asarray(jout.cache[n]),
                                          err_msg=f"{n}, step {i}")
        assert np.isfinite(np.asarray(jout.logits)).all()
        _close_bf16(jout.logits, tout.logits)
        jc, tc = jout.cache, tout.cache
    assert int(tc["pos"]) == pos + steps
