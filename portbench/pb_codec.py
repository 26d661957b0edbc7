"""Frozen plain copies of the service's semantics that the reference
works out again: the chunk codec (per-channel symmetric quantization of
a (T, F) chunk along T, 8 / 4 / 2 bits packed along T), the Eq.-1 chunk
density and the Eq.-3 bit plan (paper section 3.2; the port's
``kernels/ref.py`` ``quantize_ref`` / ``dequantize_ref`` and
``core/compression.py``).  Plain numpy and torch; nothing of the program.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

LEVELS: Tuple[Tuple[int, float], ...] = ((8, 1.0), (4, 0.5), (2, 0.25))
RATIO_GLOBAL = 0.5


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize(x: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, F) -> (codes (T, F) int32 in [-qmax, qmax], scales (F,) fp32):
    scale = max|x| over T times fl32(1 / qmax), at least 1e-8; codes
    rounded half to even."""
    xf = x.to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(qmax(bits)), device=x.device)
    scale = torch.clamp_min(xf.abs().amax(dim=0) * inv, 1e-8)
    q = qmax(bits)
    codes = torch.clamp(torch.round(xf / scale), -q, q).to(torch.int32)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def unpack(packed: np.ndarray, bits: int, T: int) -> np.ndarray:
    """A payload's packed codes (T * bits / 8, F) int8 -> (T, F) int32:
    code j of a byte sits in bits [bits j, bits (j + 1)), two's
    complement."""
    if bits == 8:
        return packed.astype(np.int32)
    per = 8 // bits
    u = packed.view(np.uint8).astype(np.int32)
    half, mask = 1 << (bits - 1), (1 << bits) - 1
    outs = []
    for j in range(per):
        c = (u >> (bits * j)) & mask
        outs.append(np.where(c >= half, c - (1 << bits), c))
    return np.stack(outs, axis=1).reshape(T, -1)


def chunk_density(dsum: np.ndarray, dcnt: np.ndarray, n_tokens: int,
                  cs: int) -> np.ndarray:
    """Per-chunk D_i: the mean over its tokens of (mass sum / passes);
    +inf where a token was never measured."""
    n = (n_tokens + cs - 1) // cs
    out = np.empty(n, np.float64)
    for i in range(n):
        lo, hi = i * cs, min((i + 1) * cs, n_tokens)
        cnt = dcnt[lo:hi]
        out[i] = (float(np.mean(dsum[lo:hi] / cnt)) if np.all(cnt > 0)
                  else float("inf"))
    return out


def _finite(d: np.ndarray) -> np.ndarray:
    fin = d[np.isfinite(d)]
    sub = (float(np.max(fin)) if fin.size else 0.0) + 1.0
    return np.where(np.isinf(d), sub, d)


def plan(d: np.ndarray, ratio_global: float = RATIO_GLOBAL, levels=LEVELS,
         min_bits: int = 2) -> np.ndarray:
    """Eq. 3: the bits per chunk that keep the most information at an
    average ratio of ``ratio_global``: the densest k1 chunks at the first
    level, the next k2 - k1 at the second, the rest at the third, (k1, k2)
    the best pair on the ratio's constraint.  Ties keep the first best."""
    n = len(d)
    if n == 0:
        return np.zeros(0, np.int64)
    (b1, r1), (b2, r2), (b3, r3) = levels
    order = np.argsort(-np.nan_to_num(d, posinf=np.inf))
    prefix = np.concatenate([[0.0], np.cumsum(_finite(d[order]))])
    best_info, best = -np.inf, None
    target = ratio_global * n
    for k1 in range(n + 1):
        k2f = (target - k1 * r1 + k1 * r2 - n * r3) / (r2 - r3)
        for k2 in {int(np.floor(k2f)), int(np.ceil(k2f))}:
            k2 = min(max(k2, k1), n)
            if (k1 * r1 + (k2 - k1) * r2 + (n - k2) * r3) / n \
                    > ratio_global + 1e-9:
                continue
            info = (r1 * prefix[k1] + r2 * (prefix[k2] - prefix[k1])
                    + r3 * (prefix[n] - prefix[k2]))
            if info > best_info + 1e-12:
                best_info, best = info, (k1, k2)
    k1, k2 = best
    srt = np.full(n, b3, np.int64)
    srt[:k2] = b2
    srt[:k1] = b1
    bits = np.empty(n, np.int64)
    bits[order] = srt
    return np.maximum(bits, min_bits)
