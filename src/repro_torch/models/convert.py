"""Weights carried across from the JAX package.

``params_from_jax`` takes the reference ``init`` pytree of any family
as numpy arrays (nested dicts, layers stacked on axis 0, bf16 arrays as
``ml_dtypes.bfloat16``) and returns the port's parameter dict on
``device``, bit for bit, so both packages compute the same model.  For
``mla_moe`` and ``moe`` the router stays fp32 (L, d, E) and the expert
weights are (L, E, d, fe) and (L, E, fe, d); for ``rwkv6``
the norms, mixes and decay base stay fp32 and the projections bf16
(``_check_rwkv6``); ``vlm`` stacks its self layers and its cross layers
apart (``self_layers`` over the self-layer count, ``cross_layers`` over
the cross-layer count); ``encdec`` stacks ``enc`` over the encoder's
layers and ``dec`` over the decoder's, each with nested attention and
MLP blocks whose biases stay fp32; ``rglru_hybrid`` stacks ``rec`` over
its recurrent layers (the block-diagonal gates (n, nb, blk, blk),
``lam`` and the conv bias fp32), ``attn`` over its attention layers
and ``mlp`` over all of them.
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
    """Reference params of a ported family (numpy) -> port params on
    ``device``."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return tensor_from_numpy(np.asarray(tree), device)

    out = conv(np_params)
    stacks = {"layers": cfg.n_layers}
    if cfg.family == "vlm":
        n_cross = cfg.n_layers // cfg.vision.cross_attn_every
        stacks = {"self_layers": cfg.n_layers - n_cross,
                  "cross_layers": n_cross}
    if cfg.family == "encdec":
        stacks = {"enc": cfg.encoder.n_layers, "dec": cfg.n_layers}
    if cfg.family == "rglru_hybrid":
        from repro_torch.models.rglru import _block_counts
        n_rec, n_attn, _, _ = _block_counts(cfg)
        stacks = {"rec": n_rec, "attn": n_attn, "mlp": cfg.n_layers}
    for stack, L in stacks.items():
        _check_stacked(stack, out[stack], L)
    if cfg.family in ("mla_moe", "moe"):
        _check_moe(out["layers"], cfg)
    if cfg.family == "rwkv6":
        _check_rwkv6(out, cfg)
    return out


def _check_stacked(path: str, tree: Dict[str, Any], L: int) -> None:
    """Every leaf of ``tree`` (nested dicts) is stacked over L layers."""
    for name, w in tree.items():
        if isinstance(w, dict):
            _check_stacked(f"{path}.{name}", w, L)
        elif w.shape[0] != L:
            raise ValueError(f"{path} param {name!r} is not stacked over "
                             f"{L} layers: {tuple(w.shape)}")


def _check_moe(layers: Dict[str, torch.Tensor], cfg: ModelConfig) -> None:
    """The MoE leaves' layout: the router fp32 (L, d, E), the experts
    (L, E, d, fe) / (L, E, fe, d) in bf16."""
    L, d, moe = cfg.n_layers, cfg.d_model, cfg.moe
    E, fe = moe.n_experts, moe.d_expert
    want = {"router": ((L, d, E), torch.float32),
            "w_gate": ((L, E, d, fe), torch.bfloat16),
            "w_up": ((L, E, d, fe), torch.bfloat16),
            "w_down": ((L, E, fe, d), torch.bfloat16)}
    for name, (shape, dtype) in want.items():
        w = layers[name]
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"MoE param {name!r} is {tuple(w.shape)} "
                             f"{w.dtype}, not {shape} {dtype}")


def _check_rwkv6(params: Dict[str, Any], cfg: ModelConfig) -> None:
    """The RWKV6 leaves' layout: every leaf of ``RWKV6Model.init`` with
    its shape and dtype (norms, token-shift mixes and the decay base
    fp32; projections, LoRAs, ``u``, embedding and head bf16)."""
    L, d, ff, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    r, H = cfg.rwkv, cfg.n_heads
    f32, bf16 = torch.float32, torch.bfloat16
    want = {"ln1": (L, d), "ln1_b": (L, d), "ln2": (L, d), "ln2_b": (L, d),
            "mu_x": (L, d), "mu_rkvgw": (L, 5, d), "w0": (L, d),
            "lnx": (L, d), "lnx_b": (L, d), "mu_ck": (L, d), "mu_cr": (L, d)}
    want = {k: (s, f32) for k, s in want.items()}
    want.update({k: (s, bf16) for k, s in {
        "mix_w1": (L, d, 5 * r.mix_lora), "mix_w2": (L, 5, r.mix_lora, d),
        "w_a": (L, d, r.decay_lora), "w_b": (L, r.decay_lora, d),
        "u": (L, H, r.head_dim), "wr": (L, d, d), "wk": (L, d, d),
        "wv": (L, d, d), "wg": (L, d, d), "wo": (L, d, d),
        "wck": (L, d, ff), "wcv": (L, ff, d), "wcr": (L, d, d)}.items()})
    got = params["layers"]
    if set(got) != set(want):
        raise ValueError(f"RWKV6 layer params {sorted(got)} are not "
                         f"{sorted(want)}")
    top = {"embed": ((V, d), bf16), "head": ((d, V), bf16),
           "ln_f": ((d,), f32), "ln_f_b": ((d,), f32)}
    for name, (shape, dtype) in [*want.items(), *top.items()]:
        w = got[name] if name in want else params[name]
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"RWKV6 param {name!r} is {tuple(w.shape)} "
                             f"{w.dtype}, not {shape} {dtype}")
