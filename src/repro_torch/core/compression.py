"""Tolerance-aware compression (paper §3.2, Eqs. 1–3).

``chunk_density`` reduces the per-token Eq.-1 statistic (computed inside
attention — ``models/common.gqa_attention``)
to per-chunk information densities.

``plan_buckets`` solves Eq. (3): assign each chunk a compression level
from ``levels`` so that the *retained* context information
``sum_w ratio_w * sum_{bucket w} D_i`` is maximized subject to the
OS-configured global average ratio ``sum_w ratio_w * |bucket w| =
ratio_global * n``.  (DESIGN.md §2 records why we maximize retained —
not 1/ratio-weighted — information: the printed Eq. 3 weight is inverted
relative to the paper's own prose.)

With the paper's default three levels {8/8, 4/8, 2/8} and ratio 1/2 the
constraint reduces to ``2*k1 + k2 = n`` over prefix counts of the
density-sorted chunks, solved exactly by an O(n) prefix-sum scan.  A
brute-force reference (`plan_buckets_brute`) exists for the property
tests.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple

import numpy as np

# (bits, ratio-of-baseline)
DEFAULT_LEVELS: Tuple[Tuple[int, float], ...] = ((8, 1.0), (4, 0.5), (2, 0.25))


def chunk_density(token_density: np.ndarray, token_count: np.ndarray,
                  n_tokens: int, cs: int) -> np.ndarray:
    """Per-chunk D_i from accumulated per-token (mass_sum, n_queries).

    token_density: (S,) accumulated Eq.-1 mass sums; token_count: (S,)
    number of measurement passes per token.  Unmeasured tokens get +inf
    (treated as maximally dense until measured)."""
    n_chunks = (n_tokens + cs - 1) // cs
    out = np.empty(n_chunks, np.float64)
    for i in range(n_chunks):
        lo, hi = i * cs, min((i + 1) * cs, n_tokens)
        cnt = token_count[lo:hi]
        if np.all(cnt > 0):
            out[i] = float(np.mean(token_density[lo:hi] / cnt))
        else:
            out[i] = float("inf")
    return out


def retained_info(density: np.ndarray, bits: np.ndarray,
                  levels: Sequence[Tuple[int, float]] = DEFAULT_LEVELS
                  ) -> float:
    ratio = {b: r for b, r in levels}
    fin = density[np.isfinite(density)]
    sub = (float(np.max(fin)) if fin.size else 0.0) + 1.0
    d = np.where(np.isinf(density), sub, density)
    return float(sum(ratio[int(b)] * di for b, di in zip(bits, d)))


def plan_buckets(density: np.ndarray,
                 ratio_global: float = 0.5,
                 levels: Sequence[Tuple[int, float]] = DEFAULT_LEVELS
                 ) -> np.ndarray:
    """-> per-chunk bit assignment (n,) int.  Exact for 3 levels."""
    n = len(density)
    if n == 0:
        return np.zeros(0, np.int64)
    assert len(levels) == 3, "planner expects 3 compression levels"
    (b1, r1), (b2, r2), (b3, r3) = levels
    assert r1 > r2 > r3
    # rank: densest first (inf = unmeasured counts as densest)
    order = np.argsort(-np.nan_to_num(density, posinf=np.inf))
    d_sorted = density[order]
    # unmeasured (inf) chunks substitute STRICTLY above the measured max so
    # they win high-precision slots even when measured densities tie at 0
    fin = d_sorted[np.isfinite(d_sorted)]
    sub = (float(np.max(fin)) if fin.size else 0.0) + 1.0
    d_finite = np.nan_to_num(d_sorted, posinf=sub)
    prefix = np.concatenate([[0.0], np.cumsum(d_finite)])

    best_info, best = -np.inf, None
    target = ratio_global * n
    for k1 in range(n + 1):
        # solve k2 from the ratio constraint
        denom = r2 - r3
        k2f = (target - k1 * r1 + k1 * r2 - n * r3) / denom
        for k2 in {int(np.floor(k2f)), int(np.ceil(k2f))}:
            k2 = min(max(k2, k1), n)
            ratio = (k1 * r1 + (k2 - k1) * r2 + (n - k2) * r3) / n
            if ratio > ratio_global + 1e-9:
                continue
            info = (r1 * prefix[k1] + r2 * (prefix[k2] - prefix[k1])
                    + r3 * (prefix[n] - prefix[k2]))
            if info > best_info + 1e-12:
                best_info, best = info, (k1, k2)
    assert best is not None
    k1, k2 = best
    bits_sorted = np.full(n, b3, np.int64)
    bits_sorted[:k2] = b2
    bits_sorted[:k1] = b1
    bits = np.empty(n, np.int64)
    bits[order] = bits_sorted
    return bits


def plan_buckets_brute(density: np.ndarray, ratio_global: float = 0.5,
                       levels: Sequence[Tuple[int, float]] = DEFAULT_LEVELS
                       ) -> Tuple[np.ndarray, float]:
    """Exhaustive reference for tests (n <= ~8)."""
    n = len(density)
    d = np.nan_to_num(density, posinf=(np.max(
        density[np.isfinite(density)]) if np.any(np.isfinite(density))
        else 1.0))
    best_info, best = -np.inf, None
    for combo in itertools.product(range(len(levels)), repeat=n):
        ratio = sum(levels[c][1] for c in combo) / n
        if ratio > ratio_global + 1e-9:
            continue
        info = sum(levels[c][1] * d[i] for i, c in enumerate(combo))
        if info > best_info + 1e-12:
            best_info = info
            best = np.array([levels[c][0] for c in combo], np.int64)
    return best, best_info
