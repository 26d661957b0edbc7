"""The port's RG-LRU hybrid family (recurrentgemma-2b) against the JAX package.

Both packages run the reduced recurrentgemma (5 layers: rec, rec, attn,
rec, rec; d 64, 4 query heads over 1 KV head of 32, lru width 64 in 4
gate blocks, window 64) from the SAME weights: the reference's
``init(PRNGKey(0))`` carried across bit for bit.

Tolerances.
* The gates and the scan are fp32 in both packages: the block-diagonal
  products and the gates within rtol 1e-5 (sums in another order); the
  scan (the reference's ``associative_scan`` and a sequential loop
  against the port's Hillis-Steele doubling) within rtol 1e-5 + atol
  1e-6 x max|h| (each combines the same products in another order:
  max |diff| measured at 1.1e-7 of max|h| at S = 4096).
* The attention's flash form over 2,100 tokens against the reference's
  ``blocked_causal_attention`` on the same bf16 inputs: out within two
  bf16 ulps of its largest value, the density within 1e-6 of its
  largest value (as ``tests/test_torch_prefill.py``).
* Whole models: logits, K/V and the conv state at bf16 level (atol 0.02
  x max|ref|, rtol 0.02), the lru state (fp32, from bf16 activations)
  likewise, the density within 1e-4 or one bf16 ulp of its largest
  value.  The reference's own prefill/decode agreement
  (``tests/test_models.py``) at 5e-2.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from conftest import make_batch
from repro.models import common as JC
from repro.models import rglru as JR
from repro_torch.kernels import ref as kref
from repro_torch.models import rglru as TR
from repro_torch.models.convert import params_from_jax

NAME = "recurrentgemma-2b"
STATE = ("k", "v", "conv", "lru")


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def _close_density(jd, td):
    jd = np.asarray(jd)
    tol = max(1e-4, _bf16_ulp(float(np.max(np.abs(jd)))))
    np.testing.assert_allclose(to_np(td), jd, atol=tol, rtol=0)


def _tokens(jcfg, B, S):
    t = make_batch(jcfg, B, S)["tokens"]
    return t, to_torch(np.asarray(t)).long()


def test_reduced_config_weights_and_spec_match_reference():
    """The port's configs are the reference's; the converted weights are
    the reference's bit for bit (``rec`` stacked over 4 recurrent
    layers with the gate blocks (4, 16, 16), ``attn`` over 1, ``mlp``
    over 5); the KVSpec is the reference's (not servable, not pad-safe,
    16-bit floor)."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tget(NAME)) == dataclasses.asdict(jget(NAME))
    assert TR._block_counts(tcfg) == JR._block_counts(jcfg) == (4, 1, 1, 2)
    assert TR._block_counts(tget(NAME)) == (18, 8, 8, 2)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        t = tparams
        for p in path:
            t = t[p.key]
        assert t.dtype == (torch.float32 if leaf.dtype == jnp.float32
                           else torch.bfloat16)
        np.testing.assert_array_equal(to_np(t), np.asarray(leaf).astype(
            np.float32))
    assert sum(len(v) if isinstance(v, dict) else 1
               for v in tparams.values()) == len(flat_j)
    assert tuple(tparams["rec"]["gate_a_w"].shape) == (4, 4, 16, 16)
    assert tmodel.kv_spec().__dict__ == jmodel.kv_spec().__dict__
    with pytest.raises(ValueError, match="stacked"):
        bad = jax.tree.map(np.asarray, jparams)
        bad["rec"] = dict(bad["rec"], lam=bad["rec"]["lam"][:3])
        params_from_jax(bad, tcfg, "cpu")


def test_block_diag_and_gates_match_reference():
    """``block_diag_apply`` and ``_rglru_gates`` of the reduced model's
    first recurrent layer on fp32 and bf16 inputs (3, 7, 64), fp32
    results within rtol 1e-5."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["rec"])
    tp = {k: v[0] for k, v in tparams["rec"].items()}
    out = TR.block_diag_apply(torch.from_numpy(x), tp["gate_a_w"],
                              tp["gate_a_b"])
    ref = JR.block_diag_apply(jnp.asarray(x), jp["gate_a_w"], jp["gate_a_b"])
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt)
        jl, jb = jax.jit(jmodel._rglru_gates)(jp, xj)
        tl, tb = tmodel._rglru_gates(tp, to_torch(np.asarray(xj)))
        for a, b in ((jl, tl), (jb, tb)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("S", [24, 97, 4096])
def test_scan_matches_reference_and_a_loop(S):
    """The fp32 linear recurrence over (2, S, 8) with a in (1.5e-4, 1)
    (the range the gates give: exp(-8 softplus(0.7) r)) and a carried
    h0: the port's scan against the reference's ``associative_scan``
    (through ``_rec_block_full``'s operator) and against a sequential
    loop, as stated above."""
    rng = np.random.default_rng(S)
    a = np.exp(-8.0 * np.log1p(np.exp(0.7)) * rng.uniform(
        0, 1, (2, S, 8))).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    assert a.min() < 2e-4 and a.max() < 1

    def op(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    ja, jh = jax.jit(lambda a, b: jax.lax.associative_scan(
        op, (a, b), axis=1))(a, b)
    ref = np.asarray(jh) + np.asarray(ja) * h0[:, None]
    ta, th = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    out = (th + ta * torch.from_numpy(h0)[:, None]).numpy()
    loop = np.empty_like(b)
    h = h0.copy()
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        loop[:, t] = h
    for want in (ref, loop):
        np.testing.assert_allclose(out, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("S", [24, 96], ids=["inside", "window"])
def test_prefill_matches_reference(S):
    """A prefill of two rows with the density; at S = 96 the window of
    64 bites.  Logits, K/V, conv and lru state, the density, as stated
    above."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    jt, tt = _tokens(jcfg, 2, S)
    jout = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, want_density=True))(jparams, jt)
    tout = tmodel.prefill(tparams, {"tokens": tt}, want_density=True)
    assert tout.logits.dtype == torch.float32
    _close_bf16(jout.logits, tout.logits)
    assert int(tout.cache["pos"]) == S
    for n in STATE:
        assert tout.cache[n].shape == jout.cache[n].shape, n
        assert tout.cache[n].dtype == (torch.float32 if n == "lru"
                                       else torch.bfloat16)
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])
    assert tout.density.shape == (2, S)
    _close_density(jout.density, tout.density)


def test_flash_form_matches_reference_blocked():
    """The attention block's form above 2048 tokens: the plain flash
    form under the window over 2,100 tokens (G = 4 over one KV head of
    32) against the reference's ``blocked_causal_attention`` (blocks of
    1024 keys), which its ``_attn_block`` takes there with the density,
    and ``flash_attention``, which it takes without: as stated above."""
    S, window = 2100, 64
    rng = np.random.default_rng(S)
    jq, jk, jv = (jnp.asarray(rng.standard_normal((1, S, h, 32)).astype(
        np.float32)).astype(jnp.bfloat16) for h in (4, 1, 1))
    blocked = JC.blocked_causal_attention(jq, jk, jv, window=window,
                                          want_density=True)
    flash = JC.flash_attention(jq, jk, jv, 0, 1024, window, 0)
    out, dens = kref.attn_density_plain(
        *(to_torch(np.asarray(a)) for a in (jq, jk, jv)), torch.arange(S),
        S, window, 0, True, "flash")
    for ref in (blocked.out, flash):
        ref = to_np(ref)
        np.testing.assert_allclose(to_np(out), ref, rtol=0,
                                   atol=2 ** -7 * float(np.abs(ref).max()))
    jd = np.asarray(blocked.key_density)
    np.testing.assert_allclose(dens.numpy(), jd, rtol=0,
                               atol=1e-6 * float(np.max(jd)))


def test_attention_takes_the_reference_branch(monkeypatch):
    """``_attn_block`` sends the served form under the window up to 2048
    tokens and the flash form above, with or without the density: the
    reference's rule, not dense's (which goes flash for any window)."""
    from repro_torch.kernels import ops as kops
    _, _, _, tcfg, tmodel, tparams = tiny_pair(NAME)
    seen = []

    def spy(q, k, v, q_pos, seq_len, window, n_sinks, want_density, form):
        seen.append((q.shape[1], window, n_sinks, want_density, form))
        return torch.zeros_like(q), None
    monkeypatch.setattr(kops, "attn_density", spy)
    pa = {k: v[0] for k, v in tparams["attn"].items()}
    for S, dens in ((2048, True), (2049, False), (2049, True)):
        x = torch.zeros((1, S, tcfg.d_model), dtype=torch.bfloat16)
        tmodel._attn_block(pa, x, torch.arange(S), dens)
    assert seen == [(2048, 64, 0, True, "served"),
                    (2049, 64, 0, False, "flash"),
                    (2049, 64, 0, True, "flash")]


def test_long_prefill_matches_reference():
    """2,100 tokens with the density: the reference's blocked branch
    against the port's flash form, the whole model as stated above."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    jt, tt = _tokens(jcfg, 1, 2100)
    jout = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, want_density=True))(jparams, jt)
    tout = tmodel.prefill(tparams, {"tokens": tt}, want_density=True)
    _close_bf16(jout.logits, tout.logits)
    for n in STATE:
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])
    _close_density(jout.density, tout.density)


def test_decode_matches_reference_with_the_window():
    """Each package prefills 80 tokens of two rows, copies its K/V and
    state into a cache of 104, then 24 teacher-forced decode steps at
    positions 80..103, where the window of 64 drops the oldest keys:
    logits at bf16 level every step, K/V written in place, the (B, 1)
    zero density row; the state and K/V after the last step."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    B, P, N = 2, 80, 24
    jt, tt = _tokens(jcfg, B, P + N)
    jpf = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))(
        jparams, jt[:, :P])
    tpf = tmodel.prefill(tparams, {"tokens": tt[:, :P]})
    jc, tc = jmodel.init_cache(B, P + N), tmodel.init_cache(B, P + N)
    for n in ("k", "v"):
        jc[n] = jc[n].at[:, :, :P].set(jpf.cache[n])
        tc[n][:, :, :P] = tpf.cache[n]
    for n in ("conv", "lru"):
        jc[n], tc[n] = jpf.cache[n], tpf.cache[n]
    jc["pos"], tc["pos"] = jnp.int32(P), torch.tensor(P)
    dec = jax.jit(jmodel.decode_step)
    for i in range(P, P + N):
        jout = dec(jparams, jt[:, i:i + 1], jc)
        tout, mass = tmodel.decode_step(tparams, tt[:, i:i + 1], tc,
                                        want_density=True)
        _close_bf16(jout.logits, tout.logits)
        assert tout.cache["k"] is tc["k"] and mass.shape == (B, 1)
        assert not mass.any()
        jc, tc = jout.cache, tout.cache
    assert int(tc["pos"]) == P + N
    for n in STATE:
        _close_bf16(np.asarray(jc[n]), tc[n])


def test_prefill_from_a_carried_state():
    """The snapshot path: ``_forward_full`` of the last 12 of 24 tokens
    from the conv / lru state the first 12 left (each package its own),
    against the reference's from its own; x, conv and lru as stated
    above."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(NAME)
    jt, tt = _tokens(jcfg, 2, 24)
    fwd = jax.jit(lambda p, t, s: jmodel._forward_full(p, t, state=s))
    j1 = jax.jit(lambda p, t: jmodel._forward_full(p, t))(jparams, jt[:, :12])
    t1 = tmodel._forward_full(tparams, tt[:, :12])
    j2 = fwd(jparams, jt[:, 12:], (j1["conv"], j1["lru"]))
    t2 = tmodel._forward_full(tparams, tt[:, 12:],
                              state=(t1["conv"], t1["lru"]))
    for n in ("x", "conv", "lru"):
        _close_bf16(np.asarray(j2[n]), t2[n])
    fresh = tmodel._forward_full(tparams, tt[:, 12:])
    assert not torch.equal(fresh["lru"], t2["lru"])


def test_prefill_decode_agreement():
    """The reference's own prefill/decode agreement on the port: 24
    decode steps of two rows from an empty cache give the last-position
    logits of a 24-token prefill within 5e-2."""
    jcfg, _, _, _, tmodel, tparams = tiny_pair(NAME)
    _, tt = _tokens(jcfg, 2, 24)
    pf = tmodel.prefill(tparams, {"tokens": tt}, want_density=True)
    cache = tmodel.init_cache(2, 24)
    for i in range(24):
        out = tmodel.decode_step(tparams, tt[:, i:i + 1], cache)
        cache = out.cache
    np.testing.assert_allclose(out.logits.numpy(), pf.logits.numpy(),
                               rtol=5e-2, atol=5e-2)


def test_servable_gate(tmp_path):
    """``build_model`` builds the family on the CPU; its cache holds the
    attention layers' K/V (n_attn leading) and the recurrent state;
    the port's ``LLMService`` refuses it with the reference executor's
    ``not servable`` error, and so does the reference's."""
    from repro.core.service import LLMSConfig as JConfig
    from repro.core.service import LLMService as JService
    from repro_torch.core.service import LLMSConfig, LLMService
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(NAME)
    cache, jcache = tmodel.init_cache(1, 32), jmodel.init_cache(1, 32)
    assert set(cache) == set(jcache) == {"k", "v", "conv", "lru", "pos"}
    for n in STATE:
        assert tuple(cache[n].shape) == tuple(jcache[n].shape), n
    assert cache["lru"].dtype == torch.float32
    with pytest.raises(ValueError, match="not servable"):
        LLMService(tmodel, tparams, LLMSConfig(swap_dir=str(tmp_path)),
                   device="cpu")
    with pytest.raises(ValueError, match="not servable"):
        JService(jmodel, jparams, JConfig(swap_dir=str(tmp_path)))
