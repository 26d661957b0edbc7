"""Shared helpers for the port's parity tests (tests/test_torch_*.py):
the reduced llama2-7b model built by both packages from the SAME
weights (the reference's ``init(PRNGKey(0))``, carried across bit for
bit), and numpy <-> framework converters that keep bf16 bits."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from conftest import tiny_model
from repro_torch.configs import get_config, reduced
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.registry import build_model

_PAIR = {}


def tiny_pair():
    """-> (jax cfg, jax model, jax params, torch cfg, torch model, torch
    params) for the reduced llama2-7b, on the CPU."""
    if "llama2" not in _PAIR:
        jcfg, jmodel, jparams = tiny_model("llama2-7b")
        tcfg = reduced(get_config("llama2-7b"))
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "norm_eps"):
            assert getattr(jcfg, f) == getattr(tcfg, f), f
        tmodel = build_model(tcfg, device="cpu")
        np_params = jax.tree.map(np.asarray, jparams)
        tparams = params_from_jax(np_params, tcfg, "cpu")
        _PAIR["llama2"] = (jcfg, jmodel, jparams, tcfg, tmodel, tparams)
    return _PAIR["llama2"]


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
