"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the reduced model of a dense config built by both packages from the
SAME weights (the reference's ``init(PRNGKey(0))``, carried across bit
for bit), and numpy <-> framework converters that keep bf16 bits."""
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_model
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import build_model

_PAIR = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while a module of many small steps runs: the
    suite runs several worker processes on one machine, and torch's
    spinning intra-op threads in each of them slowed such modules about
    sixfold.  Import it into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIR = {}
# the config fields that fix the two models' shapes and branches
STRUCT_FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                 "d_ff", "vocab", "head_dim", "rope_theta", "norm_eps",
                 "tie_embeddings", "qkv_bias", "qk_norm", "max_seq")


def tiny_pair(name: str = "llama2-7b"):
    """-> (jax cfg, jax model, jax params, torch cfg, torch model, torch
    params) for the reduced config of dense arch ``name``, on the CPU."""
    if name not in _PAIR:
        jcfg, jmodel, jparams = tiny_model(name)
        tcfg = reduced(get_config(name))
        for f in STRUCT_FIELDS:
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        tmodel = build_model(tcfg, device="cpu")
        np_params = jax.tree.map(np.asarray, jparams)
        tparams = params_from_jax(np_params, tcfg, "cpu")
        _PAIR[name] = (jcfg, jmodel, jparams, tcfg, tmodel, tparams)
    return _PAIR[name]


def scaled_head_pair(name: str, scale: float):
    """``tiny_pair(name)`` with the output head scaled by ``scale`` (a
    power of two: exact in bf16) in both packages' weights, which
    spreads the random-init logits so that greedy picks are far from a
    tie.  A tied head scales the embedding it shares.  -> (jax cfg, jax
    model, jax params, torch cfg, torch model, torch params)."""
    if (name, scale) not in _PAIR:
        jcfg, jmodel, jparams, tcfg, tmodel, _ = tiny_pair(name)
        jparams = dict(jparams)
        key = "embed" if jcfg.tie_embeddings else "head"
        jparams[key] = (jparams[key].astype(jnp.float32) * scale
                        ).astype(jnp.bfloat16)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                  "cpu")
        _PAIR[name, scale] = (jcfg, jmodel, jparams, tcfg, tmodel, tparams)
    return _PAIR[name, scale]


def to_torch(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def to_np(t) -> np.ndarray:
    """Tensor or jax array -> fp32/int numpy (bf16 widened exactly)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def bf16_pair(x32: np.ndarray):
    """fp32 numpy -> (jax bf16, torch bf16) with identical bits."""
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    return xj, to_torch(np.asarray(xj))


def services(name: str = "smollm-360m", head_scale: float = 16.0,
             budget: int = 10_000_000, max_ctx: int = 128,
             port_only: bool = False, **extra):
    """Both packages' ``LLMService`` over the SAME reduced weights (the
    head scaled by ``head_scale``, ``scaled_head_pair``), each with its
    own swap directory, the port's on the CPU.  ``extra`` goes to both
    configs (policy, decode_batch, quant_resident, ...).  -> (jax
    service, torch service, torch cfg); the jax service is None with
    ``port_only``."""
    from repro.core.service import LLMSConfig as JConfig
    from repro.core.service import LLMService as JService
    from repro_torch.core.service import LLMSConfig as TConfig
    from repro_torch.core.service import LLMService as TService
    _, jmodel, jparams, tcfg, tmodel, tparams = scaled_head_pair(
        name, head_scale)
    kw = dict(max_ctx_len=max_ctx, memory_budget=budget, **extra)
    js = None if port_only else JService(
        jmodel, jparams, JConfig(swap_dir=tempfile.mkdtemp(), **kw))
    ts = TService(tmodel, tparams, TConfig(swap_dir=tempfile.mkdtemp(), **kw),
                  device="cpu")
    return js, ts, tcfg


def run_scenario_in(pkg: str, spec, name: str, head_scale: float,
                    **kw):
    """One loadgen scenario through ``pkg``'s ("jax" or "torch")
    ``build_service`` + ``run_scenario`` over the reduced ``name`` with
    its head scaled (``scaled_head_pair``), the port on the CPU.  -> the
    report."""
    from repro import loadgen as jloadgen
    from repro_torch import loadgen as tloadgen
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = scaled_head_pair(
        name, head_scale)
    if pkg == "torch":
        svc = tloadgen.build_service(spec, tmodel, tparams, device="cpu")
        with svc:
            return tloadgen.run_scenario(spec, svc, tcfg.vocab, **kw)
    svc = jloadgen.build_service(spec, jmodel, jparams)
    with svc:
        return jloadgen.run_scenario(spec, svc, jcfg.vocab, **kw)
