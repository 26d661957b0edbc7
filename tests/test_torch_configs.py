"""The port's dense configurations against the JAX package's.

* Every dense config of the reference's registry is in the port's, with
  equal fields, and ``reduced`` gives equal configs.
* For each of the five configs added beside llama2-7b, the reduced
  model built from the SAME weights teacher-forces a prompt through
  ``recompute`` (the prefill-append) and then four ``decode_step``
  rounds over the window cache in both packages: hidden states, logits
  and densities agree.  Before the comparison the biases (``bq``,
  ``bk``, ``bv``) are moved away from 0 and the qk-norm scales away
  from 1 (init leaves them at zeros and ones, which would leave the
  branches unchecked).  Logits and hidden states are held to the
  tolerance of tests/test_torch_models.py: atol = 0.02 * max|ref| +
  rtol 0.02 (bf16 matmuls round differently in the two frameworks).
  Densities and per-key masses are held to 1e-4 as there (measured
  here: 3.1e-6 for smollm-360m and deepseek-67b, 4.3e-6 for opt-6.7b,
  1.1e-5 for qwen2.5-14b), except qwen3-32b's, which are held to one
  bf16 ulp of the largest mass at each step (2^-8 * max|ref|): with
  qk-norm, q and k have unit RMS, the scores span several units and the
  softmax is sharp, so the deeper layers' bf16-level K differences
  (layer 0's K is bit-equal) move its masses by 0.9e-4 to 2.2e-4 over
  the five steps, where max|ref| is 0.120, 0.095, 0.069, 0.069 and
  0.067, which gives limits of 4.7e-4, 3.7e-4, 2.7e-4, 2.7e-4 and
  2.6e-4 (measured on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import (  # noqa: F401 (autouse fixture)
    STRUCT_FIELDS, one_torch_thread, tiny_pair, to_np)
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import reduced as jreduced
from repro_torch.configs import REGISTRY, get_config, reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model

NEW_CONFIGS = ("smollm-360m", "opt-6.7b", "qwen2.5-14b", "qwen3-32b",
               "deepseek-67b")


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


def test_registry_holds_every_dense_config_of_the_reference():
    dense = sorted(n for n, c in JREGISTRY.items() if c.family == "dense")
    assert sorted(REGISTRY) == dense
    assert set(NEW_CONFIGS) | {"llama2-7b"} == set(dense)


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_config_fields_equal_reference(name):
    """Every field of the full config and of its reduced config."""
    for mine, ref in ((get_config(name), JREGISTRY[name]),
                      (reduced(get_config(name)), jreduced(JREGISTRY[name]))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name,branch", [
    ("smollm-360m", "tie_embeddings"), ("qwen2.5-14b", "qkv_bias"),
    ("qwen3-32b", "qk_norm")])
def test_branch_parameters_match_reference_layout(name, branch):
    """The branch's parameters exist with the reference's shapes and
    dtypes (a tied head has no ``head``), and the port's own ``init``
    makes the same tree."""
    jcfg, _, jparams, tcfg, tmodel, tparams = tiny_pair(name)
    assert getattr(tcfg, branch)
    own = tmodel.init(torch.Generator().manual_seed(0))
    for tree in (tparams, own):
        assert ("head" in tree) == ("head" in jparams)
        assert sorted(tree["layers"]) == sorted(jparams["layers"])
        for n, w in jparams["layers"].items():
            assert tuple(tree["layers"][n].shape) == tuple(w.shape), n
            assert str(tree["layers"][n].dtype).split(".")[-1] == \
                str(w.dtype), n
    if branch == "tie_embeddings":
        assert torch.equal(tmodel.head_weight(tparams), tparams["embed"].T)


def _close_mass(a, b, name):
    a = np.asarray(a)
    tol = 2 ** -8 * float(np.max(np.abs(a))) if name == "qwen3-32b" else 1e-4
    np.testing.assert_allclose(to_np(b), a, atol=tol)


def _perturbed(name):
    """Both packages' params with biases away from 0 and qk-norm scales
    away from 1, from one seeded draw."""
    jcfg, jmodel, jparams, tcfg, tmodel, _ = tiny_pair(name)
    rng = np.random.default_rng(11)
    np_params = jax.tree.map(np.asarray, jparams)
    layers = dict(np_params["layers"])
    moved = []
    for n in ("bq", "bk", "bv"):
        if n in layers:
            layers[n] = (0.5 * rng.standard_normal(layers[n].shape)
                         ).astype(layers[n].dtype)
            moved.append(n)
    for n in ("q_norm", "k_norm"):
        if n in layers:
            layers[n] = (1 + 0.3 * rng.standard_normal(layers[n].shape)
                         ).astype(layers[n].dtype)
            moved.append(n)
    np_params["layers"] = layers
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, tcfg, "cpu")
    return jcfg, jmodel, jp, tmodel, tp, moved


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_recompute_then_decode_step_teacher_forced(name):
    """Prefill 20 tokens (bucket-padded to 32 at the pad position, as
    the executor does), then four decode_step rounds fed the SAME tokens
    in both packages: hidden states, logits, densities and per-key
    masses agree after every step."""
    jcfg, jmodel, jp, tmodel, tp, moved = _perturbed(name)
    want = {"qwen2.5-14b": ["bq", "bk", "bv"],
            "qwen3-32b": ["q_norm", "k_norm"]}.get(name, [])
    assert moved == want
    S, pad, M, bucket = 64, 63, 20, 32
    rng = np.random.default_rng(12)
    toks = rng.integers(1, jcfg.vocab, M).astype(np.int32)
    pos = np.concatenate([np.arange(M), np.full(bucket - M, pad)]
                         ).astype(np.int32)
    tk = np.concatenate([toks, np.zeros(bucket - M, np.int32)])
    jc, jx, jd = jmodel.recompute(jp, jnp.asarray(tk)[None],
                                  jnp.asarray(pos), jmodel.init_cache(1, S),
                                  M, want_density=True)
    tc, tx, td = tmodel.recompute(tp, torch.from_numpy(tk).long()[None],
                                  torch.from_numpy(pos).long(),
                                  tmodel.init_cache(1, S), M,
                                  want_density=True)
    _close_bf16(jx[:, :M], tx[:, :M])
    jl = np.asarray((jx[:, M - 1] @ jmodel.head_weight(jp)
                     ).astype(jnp.float32))
    tl = (tx[:, M - 1] @ tmodel.head_weight(tp)).float().numpy()
    _close_bf16(jl, tl)
    _close_mass(jd, td, name)
    jc["pos"] = jnp.asarray(M, jnp.int32)
    tc["pos"] = torch.tensor(M)
    step = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c,
                                                      want_density=True))
    for tok in rng.integers(1, jcfg.vocab, 4):
        jo, jm = step(jp, jnp.asarray([[tok]], jnp.int32), jc)
        to, tm = tmodel.decode_step(tp, torch.tensor([[int(tok)]]), tc,
                                    want_density=True)
        jc, tc = jo.cache, to.cache
        _close_bf16(jo.logits, to.logits)
        _close_mass(jm, tm, name)
    assert int(tc["pos"]) == int(jc["pos"]) == M + 4


@pytest.mark.parametrize("name", ["qwen2.5-14b", "qwen3-32b"])
def test_perturbed_branch_changes_the_logits(name):
    """The perturbation reaches the output: the port's logits with the
    moved biases / norm scales differ from those at init, so the
    comparison above checks the branch."""
    _, _, _, tcfg, tmodel, tparams = tiny_pair(name)
    _, _, _, _, tp, _ = _perturbed(name)
    toks = torch.arange(1, 9)[None]
    pos = torch.arange(8)

    def last_logits(p):
        _, x, _ = tmodel.recompute(p, toks, pos, tmodel.init_cache(1, 16), 8)
        return (x[:, -1] @ tmodel.head_weight(p)).float()

    a, b = last_logits(tparams), last_logits(tp)
    assert float((a - b).abs().max()) > 0.01 * float(a.abs().max())


def test_full_width_configs_build_on_the_meta_shapes():
    """The port builds each full-width dense config's model object on
    the CPU without weights (the shapes only; weights at full width are
    made on the card)."""
    for name in NEW_CONFIGS:
        m = build_model(get_config(name), device="cpu")
        assert m.cfg.name == name and m.kv_spec().paged
