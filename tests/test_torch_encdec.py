"""The port's encoder-decoder family (whisper-base) against the JAX package.

Both packages run the reduced whisper (2 encoder + 2 decoder layers, d
64, 4 heads of 16, 32 audio frames, 256 learned decoder positions) from
the SAME weights: the reference's ``init(PRNGKey(0))`` carried across
bit for bit.  A fresh model's biases are zero; the parity tests set
them to the same random fp32 values in both packages so that every
bias counts.

Tolerances: the encoder output, logits and K/V (self and cross) at bf16
level (atol 0.02 x max|ref|, rtol 0.02: both packages round each bf16
op, but matmuls and fp32 sums run in other orders); the density within
1e-4 or one bf16 ulp of its largest value.  The reference's own
prefill/decode agreement (``tests/test_models.py``) at 5e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from conftest import make_batch
from repro_torch.models.convert import params_from_jax

NAME = "whisper-base"
_BIASED = {}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def _biased_pair():
    """``tiny_pair(NAME)`` with every bias and layer-norm bias drawn
    N(0, 0.1^2) in fp32 (numpy, seed 7), the same in both packages."""
    if not _BIASED:
        jcfg, jmodel, jparams, tcfg, tmodel, _ = tiny_pair(NAME)
        rng = np.random.default_rng(7)

        def fill(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, dict):
                    out[k] = fill(v)
                elif k.startswith("b") or k.endswith("_b"):
                    out[k] = jnp.asarray(rng.normal(0, 0.1, v.shape),
                                         jnp.float32)
                else:
                    out[k] = v
            return out
        jparams = fill(jparams)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
        _BIASED["pair"] = (jcfg, jmodel, jparams, tcfg, tmodel, tparams)
    return _BIASED["pair"]


def _batch(jcfg, B, S):
    b = make_batch(jcfg, B, S)
    return ({"tokens": b["tokens"], "frames": b["frames"]},
            {"tokens": to_torch(np.asarray(b["tokens"])).long(),
             "frames": to_torch(np.asarray(b["frames"]))})


def test_reduced_config_weights_and_spec_match_reference():
    """The port's configs are the reference's; the converted weights are
    the reference's bit for bit (``enc`` stacked over 2 encoder layers,
    ``dec`` over 2 decoder layers, biases fp32); the KVSpec is the
    reference's (not servable, not recomputable, the 448 cap)."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    n_t = 0
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        n_t += 1
        assert t.dtype == (torch.float32 if leaf.dtype == jnp.float32
                           else torch.bfloat16)
        np.testing.assert_array_equal(to_np(t), np.asarray(leaf).astype(
            np.float32))
    assert n_t == len(flat_j) and tparams["dec"]["cross"]["bq"].dtype == \
        torch.float32
    assert tmodel.kv_spec().__dict__ == jmodel.kv_spec().__dict__
    with pytest.raises(ValueError, match="stacked"):
        bad = jax.tree.map(np.asarray, jparams)
        bad["dec"] = dict(bad["dec"], mlp=dict(bad["dec"]["mlp"],
                                               w1=bad["dec"]["mlp"]["w1"][:1]))
        params_from_jax(bad, tcfg, "cpu")


def test_sinusoidal_positions_match_reference():
    """The encoder's fixed positions (fp32, from iota) at the full
    width's 1500 x 512 and the reduced 32 x 64: within two fp32 ulps of
    the largest angle, 2^(floor(log2 n) - 22) (XLA's and PyTorch's fp32 exp differ
    in the last bit of a frequency, which the position multiplies;
    measured 1.2e-4 at n = 1500, some 30 times below a bf16 ulp of the
    values, which the encoder adds in bf16)."""
    from repro.models import common as JC
    from repro_torch.models import common as TC
    for n, d in ((1500, 512), (32, 64)):
        ref = np.asarray(JC.sinusoidal_positions(n, d))
        out = TC.sinusoidal_positions(n, d)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        tol = 2.0 ** (np.floor(np.log2(n)) - 22)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)


def test_encode_matches_reference():
    """The encoder over 32 frames of two rows at bf16 level."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _biased_pair()
    jb, tb = _batch(jcfg, 2, 8)
    ref = jax.jit(jmodel.encode)(jparams, jb["frames"])
    out = tmodel.encode(tparams, tb["frames"])
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _close_bf16(np.asarray(ref), out)


@pytest.mark.parametrize("dens", [True, False], ids=["density", "plain"])
def test_prefill_matches_reference(dens):
    """A 24-token prefill of two rows: logits, the decoder's K/V and the
    cross K/V (``xk`` / ``xv``, 32 frames) at bf16 level, the density
    averaged over the decoder layers as stated above."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _biased_pair()
    jb, tb = _batch(jcfg, 2, 24)
    jout = jax.jit(lambda p, b: jmodel.prefill(p, b, want_density=dens))(
        jparams, jb)
    tout = tmodel.prefill(tparams, tb, want_density=dens)
    assert tout.logits.dtype == torch.float32
    _close_bf16(jout.logits, tout.logits)
    assert int(tout.cache["pos"]) == 24
    for n in ("k", "v", "xk", "xv"):
        assert tout.cache[n].shape == jout.cache[n].shape, n
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])
    if dens:
        jd = np.asarray(jout.density)
        tol = max(1e-4, _bf16_ulp(float(np.max(np.abs(jd)))))
        assert tout.density.shape == (2, 24)
        np.testing.assert_allclose(tout.density.numpy(), jd, atol=tol,
                                   rtol=0)
    else:
        assert tout.density is None


def test_decode_matches_reference_and_agrees_with_prefill():
    """24 teacher-forced decode steps of two rows, each package carrying
    its own prefill's cross K/V: logits at bf16 level every step, the
    new K/V written in place, the (B, 1) zero density row; then the
    reference's prefill/decode agreement on the port (last decode
    logits against the prefill's at 5e-2)."""
    jcfg, jmodel, jparams, _, tmodel, tparams = _biased_pair()
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


def test_learned_positions_cap_the_cache():
    """``init_cache`` clamps the decoder's length to ``max_seq`` (256 in
    the reduced config, 448 at full width) in both packages; the cross
    K/V hold the encoder's frames."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    jcfg, jmodel, _, tcfg, tmodel, _ = tiny_pair(NAME)
    for seq in (100, 1000):
        tc, jc = tmodel.init_cache(1, seq), jmodel.init_cache(1, seq)
        want = min(seq, tcfg.max_seq)
        assert tuple(tc["k"].shape) == tuple(jc["k"].shape) == \
            (2, 1, want, 4, 16)
        assert tuple(tc["xk"].shape) == tuple(jc["xk"].shape) == \
            (2, 1, 32, 4, 16)
    full = build_model(get_config(NAME), device="cpu")
    assert full.kv_spec().clamp_to_max_seq and full.cfg.max_seq == 448


def test_servable_gate(tmp_path):
    """``build_model`` builds the family on the CPU; its window cache has
    the cross K/V leaves and no mixed layout; the port's ``LLMService``
    refuses it with the reference executor's ``not servable`` error,
    and so does the reference's."""
    from repro.core.service import LLMSConfig as JConfig
    from repro.core.service import LLMService as JService
    from repro_torch.core.service import LLMSConfig, LLMService
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    cache = tmodel.init_cache(1, 32)
    assert set(cache) == {"k", "v", "xk", "xv", "pos"}
    with pytest.raises(ValueError, match="does not support cache layout"):
        tmodel.init_cache(1, 32, layout="mixed")
    with pytest.raises(ValueError, match="not servable"):
        LLMService(tmodel, tparams, LLMSConfig(swap_dir=str(tmp_path)),
                   device="cpu")
    with pytest.raises(ValueError, match="not servable"):
        JService(jmodel, jparams, JConfig(swap_dir=str(tmp_path)))
