"""Weights carried across from the JAX package.

``params_from_jax`` takes the reference ``DenseModel.init`` pytree as
numpy arrays (nested dicts, layers stacked on axis 0, bf16 arrays as
``ml_dtypes.bfloat16``) and returns the port's parameter dict on
``device``, bit for bit, so both packages compute the same model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> tensor on ``device`` with identical bits.
    bfloat16 arrays are carried through their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_params: Dict[str, Any], cfg: ModelConfig,
                    device) -> Dict[str, Any]:
    """Reference dense params (numpy) -> port params on ``device``."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"weight conversion for family {cfg.family!r} is not ported "
            "(ROADMAP.md)")

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tensor_from_numpy(np.asarray(tree), device)

    out = conv(np_params)
    L = cfg.n_layers
    for name, w in out["layers"].items():
        if w.shape[0] != L:
            raise ValueError(f"layer param {name!r} is not stacked over "
                             f"{L} layers: {tuple(w.shape)}")
    return out
