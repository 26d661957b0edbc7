"""Plain PyTorch versions of the chunk codec (the semantics of record).

Mirrors the JAX package's ``kernels/ref.py`` (``qmax_for``,
``quantize_ref``, ``dequantize_ref``) operation for operation, so the
two agree bit for bit in fp32 and bf16:

  * canonical layout (T, F): T chunk tokens, F flattened channels
    (layers x kv-heads x head-dim);
  * symmetric per-channel scales over the token axis:
    ``s_f = max_t|x| * fl32(1/qmax)``, floored at 1e-8.  The product
    with the fp32 reciprocal is what the reference computes when it
    serves: its codec runs under ``jax.jit``, where XLA rewrites the
    division by the constant qmax (the un-jitted oracle divides, and
    differs from its own jitted form by 1 ulp in some scales);
  * codes ``round`` half-to-even (``torch.round``), clipped to
    ``[-qmax, qmax]`` with ``qmax = 2^(bits-1) - 1``;
  * 4- and 2-bit codes are packed along T, token ``r*per + j`` in bit
    group ``j`` of byte row ``r``.

The CUDA kernels (``kernels/chunk_quant.py``) are held against these
functions; ``kernels/ops.py`` sends CPU tensors here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def qmax_for(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize_ref(x: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, F) float -> (packed int8 (T*bits//8, F), scales fp32 (F,))."""
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, not {bits}")
    T, F = x.shape
    qm = qmax_for(bits)
    xf = x.to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(qm), device=x.device)
    scale = xf.abs().amax(dim=0) * inv                        # (F,)
    scale = torch.clamp_min(scale, 1e-8)
    codes = torch.clamp(torch.round(xf / scale), -qm, qm).to(torch.int32)
    if bits == 8:
        return codes.to(torch.int8), scale
    per = 8 // bits                                           # codes per byte
    if T % per:
        raise ValueError(f"T={T} is not a multiple of {per} at {bits} bits")
    u = (codes & ((1 << bits) - 1)).reshape(T // per, per, F)  # two's compl.
    packed = torch.zeros((T // per, F), dtype=torch.int32, device=x.device)
    for j in range(per):
        packed |= u[:, j] << (bits * j)
    return packed.to(torch.uint8).view(torch.int8), scale


def dequantize_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                   T: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_ref`` -> (T, F) in ``dtype``."""
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, not {bits}")
    if bits == 8:
        return (packed.to(torch.float32) * scale).to(dtype)
    per = 8 // bits
    rows, F = packed.shape
    if rows * per != T:
        raise ValueError(f"{rows} packed rows do not hold {T} tokens")
    # read the bytes as UNSIGNED: >> on int8 is arithmetic in torch
    u = packed.view(torch.uint8).to(torch.int32)
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    outs = []
    for j in range(per):
        c = (u >> (bits * j)) & mask
        outs.append(torch.where(c >= half, c - (1 << bits), c))  # sign-extend
    codes = torch.stack(outs, dim=1).reshape(T, F)
    return (codes.to(torch.float32) * scale).to(dtype)
