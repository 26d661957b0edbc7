"""The port's full-sequence ``prefill`` (dense and MLA) against the JAX package.

Both packages run the reduced configs from the SAME weights (the
reference's ``init(PRNGKey(0))`` carried across bit for bit).  The
reference attends a prefill three ways (``dense.py:_layer_full``):
``gqa_attention`` under the causal mask (S <= 2048, no window),
``flash_attention`` (S > 2048 or a window, no density) and
``blocked_causal_attention`` (the same with the density).  The port
sends all three through ``attn_density`` (``C.prefill_attention``): the
served form for the first, the flash form for the other two.

Tolerances.
* The flash form against the reference's flash and blocked functions on
  the same bf16 inputs: the reference rounds the unnormalised p to bf16
  before PV, the port keeps PV in fp32, so outputs differ by at most
  one bf16 ulp of their largest value (measured 1.0); the test allows
  two (2^-7 x max|out|).  The density (fp32 in both) within 1e-6 of its
  largest value (measured 1.8e-7).
* Whole models: logits and K/V (latents for MLA) at bf16 level, atol =
  0.02 x max|ref| + rtol 0.02 (measured up to 1.0%); the density within
  1e-4 or one bf16 ulp of its largest value (scores of bf16-level
  different activations; measured up to 1.7e-4 with qk-norm).
* The reference's ``test_recompute_exact`` and
  ``test_extend_is_prefill_append`` on the port alone, with the
  reference's own tolerances (2e-2, 3e-2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from conftest import make_batch
from repro.models import common as JC
from repro_torch.kernels import ref as kref
from repro_torch.models import common as TC

LEAVES = {"deepseek-v2-lite-16b": ("ckv", "kpe")}
# (S, window, n_sinks, want_density) of the reference's three branches
BRANCHES = {"full": (40, 0, 0, True), "flash": (40, 12, 2, False),
            "blocked": (40, 12, 2, True)}


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


@pytest.mark.parametrize("S,window,n_sinks", [(2100, 0, 0), (300, 64, 4)],
                         ids=["long", "windowed"])
def test_flash_form_matches_reference_flash_and_blocked(S, window, n_sinks):
    """The plain flash form (what the kernel computes on the card) over
    a causal prefill of S tokens, G = 2, against the reference's
    ``flash_attention`` and ``blocked_causal_attention`` (blocks of
    1024 keys: three at S = 2100): out within two bf16 ulps of its
    largest value, the density within 1e-6 of its largest value."""
    rng = np.random.default_rng(S)
    jq, jk, jv = (jnp.asarray(rng.standard_normal((1, S, h, 16)).astype(
        np.float32)).astype(jnp.bfloat16) for h in (4, 2, 2))
    flash = JC.flash_attention(jq, jk, jv, 0, 1024, window, n_sinks)
    blocked = JC.blocked_causal_attention(jq, jk, jv, 0, 1024, window,
                                          n_sinks, want_density=True)
    out, dens = kref.attn_density_plain(
        *(to_torch(np.asarray(a)) for a in (jq, jk, jv)), torch.arange(S),
        S, window, n_sinks, True, "flash")
    for ref in (flash, blocked.out):
        ref = to_np(ref)
        tol = 2 ** -7 * float(np.max(np.abs(ref)))
        np.testing.assert_allclose(to_np(out), ref, atol=tol, rtol=0)
    jd = np.asarray(blocked.key_density)
    np.testing.assert_allclose(dens.numpy(), jd, rtol=0,
                               atol=1e-6 * float(np.max(jd)))


@pytest.mark.parametrize("S,window,form", [
    (40, 0, "served"), (2049, 0, "flash"), (40, 8, "flash"),
    (2048, 0, "served")])
def test_prefill_attention_takes_the_reference_branch(S, window, form,
                                                      monkeypatch):
    """``prefill_attention`` sends a prefill to the form of the branch
    the reference takes: served up to 2048 tokens without a window,
    flash beyond or with a window; query positions arange(S) over
    seq_len S."""
    from repro_torch.kernels import ops as kops
    seen = []

    def spy(q, k, v, q_pos, seq_len, window, n_sinks, want_density, form):
        seen.append((form, int(seq_len), torch.equal(
            q_pos, torch.arange(q.shape[1]))))
        return q, None
    monkeypatch.setattr(kops, "attn_density", spy)
    x = torch.zeros((1, S, 2, 8), dtype=torch.bfloat16)
    TC.prefill_attention(x, x, x, torch.arange(S), window, 0, False)
    assert seen == [(form, S, True)]


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("name", ["llama2-7b", "qwen3-32b", "qwen2.5-14b",
                                  "deepseek-v2-lite-16b"],
                         ids=["dense", "qk_norm", "qkv_bias", "mla"])
def test_prefill_matches_reference(name, branch):
    """A 40-token prefill of the reduced model in each of the
    reference's branches: last-position logits and every layer's K/V
    (MLA: ckv / kpe) at bf16 level, the layer-averaged density as
    above, ``pos`` = S."""
    S, window, n_sinks, dens = BRANCHES[branch]
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair(name)
    toks = make_batch(jcfg, 1, S)["tokens"]
    jout = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, want_density=dens, window=window,
        n_sinks=n_sinks))(jparams, toks)
    tout = tmodel.prefill(tparams, {"tokens": to_torch(np.asarray(toks))
                                    .long()}, want_density=dens,
                          window=window, n_sinks=n_sinks)
    assert tout.logits.dtype == torch.float32
    _close_bf16(jout.logits, tout.logits)
    leaves = LEAVES.get(name, ("k", "v"))
    assert set(tout.cache) == {*leaves, "pos"} and int(tout.cache["pos"]) == S
    for n in leaves:
        assert tout.cache[n].shape == jout.cache[n].shape
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])
    if dens:
        assert tout.density.shape == (1, S)
        _close_density(jout.density, tout.density)
    else:
        assert tout.density is None


def test_long_prefill_matches_reference():
    """2,100 tokens, past the reference's 2048-token full product: its
    flash branch against the port's flash form, logits and K/V at bf16
    level."""
    jcfg, jmodel, jparams, _, tmodel, tparams = tiny_pair("llama2-7b")
    toks = make_batch(jcfg, 1, 2100)["tokens"]
    jout = jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}))(
        jparams, toks)
    tout = tmodel.prefill(tparams, {"tokens": to_torch(np.asarray(toks))
                                    .long()})
    _close_bf16(jout.logits, tout.logits)
    for n in ("k", "v"):
        _close_bf16(np.asarray(jout.cache[n]), tout.cache[n])


@pytest.mark.parametrize("name", ["smollm-360m", "llama2-7b",
                                  "deepseek-v2-lite-16b"])
def test_recompute_exact(name):
    """The reference's test on the port: holes punched into the port's
    own prefill are recomputed (paper Fig. 7) to the prefill's values
    within 2e-2; the density is finite."""
    jcfg, _, _, _, tmodel, tparams = tiny_pair(name)
    S = 32
    toks = to_torch(np.asarray(make_batch(jcfg, 1, S)["tokens"])).long()
    pf = tmodel.prefill(tparams, {"tokens": toks})
    leaves = LEAVES.get(name, ("k", "v"))
    miss = torch.tensor([3, 4, 10, 11, 20, 21])
    holey = {k: v.clone() for k, v in pf.cache.items()}
    for n in leaves:
        holey[n][:, :, miss] = 0
    cache, hidden, dens = tmodel.recompute(tparams, toks[:, miss], miss,
                                           holey, S, want_density=True)
    for n in leaves:
        np.testing.assert_allclose(to_np(cache[n]), to_np(pf.cache[n]),
                                   rtol=2e-2, atol=2e-2)
    assert hidden.shape[1] == len(miss)
    assert torch.isfinite(dens).all()


def test_extend_is_prefill_append():
    """The reference's test on the port: recompute with a contiguous
    suffix (the chunked prefill-append) over the port's prefill of the
    first 16 tokens gives the port's prefill of all 24, logits within
    3e-2."""
    jcfg, _, _, _, tmodel, tparams = tiny_pair("smollm-360m")
    S0, T = 16, 8
    toks = to_torch(np.asarray(make_batch(jcfg, 1, S0 + T)["tokens"])).long()
    full = tmodel.prefill(tparams, {"tokens": toks})
    half = tmodel.prefill(tparams, {"tokens": toks[:, :S0]})
    cache = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, T))
                 if k != "pos" else v) for k, v in half.cache.items()}
    _, hidden, _ = tmodel.recompute(tparams, toks[:, S0:],
                                    torch.arange(S0, S0 + T), cache, S0 + T)
    logits = (hidden[:, -1] @ tmodel.head_weight(tparams)).float()
    np.testing.assert_allclose(logits.numpy(), full.logits.numpy(),
                               rtol=3e-2, atol=3e-2)
