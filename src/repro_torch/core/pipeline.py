"""Swapping-recompute pipeline planner (paper §3.3, Eq. 4).

The paper restores missing chunks through TWO channels at once: disk I/O
and recompute-from-text.  Profiling fits linear models

    T_re(x)  = re_base + re_per_chunk * x        (x = chunks recomputed)
    T_IO(m)  = io_base + io_per_byte  * m        (m = bytes read)

and the planner picks the recompute set minimizing
``max(T_re, T_IO)`` subject to "recompute only what is recomputable"
(Eq. 4).  Because T_re depends on the COUNT and T_IO on the BYTES, the
exact greedy is: recompute the heaviest chunks first (matches the
paper's principle ii — heavy chunks are the best pipeline candidates).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class PipelineProfile:
    re_base: float = 5e-3          # jit dispatch overhead
    re_per_chunk: float = 1e-3
    io_base: float = 2e-4
    io_per_byte: float = 1e-9      # ~1 GB/s default

    def t_re(self, n_chunks: int) -> float:
        return 0.0 if n_chunks == 0 else self.re_base + self.re_per_chunk * n_chunks

    def t_io(self, nbytes: int) -> float:
        return 0.0 if nbytes == 0 else self.io_base + self.io_per_byte * nbytes


def fit_linear(xs: Sequence[float], ts: Sequence[float]
               ) -> Tuple[float, float]:
    """least-squares (base, slope) with non-negative clamping."""
    A = np.stack([np.ones(len(xs)), np.asarray(xs, np.float64)], axis=1)
    coef, *_ = np.linalg.lstsq(A, np.asarray(ts, np.float64), rcond=None)
    base, slope = float(coef[0]), float(coef[1])
    return max(base, 0.0), max(slope, 1e-12)


def profile_io(store, swapper, sample_chunk, sizes=(1, 2, 4, 8)
               ) -> Tuple[float, float]:
    """One-shot installation-time measurement (paper §3.3.i)."""
    xs, ts = [], []
    for n in sizes:
        keys = [(-1, f"probe{j}") for j in range(n)]
        for k in keys:
            store.write(k, sample_chunk)
        t0 = time.perf_counter()
        for k in keys:
            store.read(k)
        ts.append(time.perf_counter() - t0)
        xs.append(sum(store.nbytes(k) for k in keys))
        for k in keys:
            store.delete(k)
    return fit_linear(xs, ts)


def plan_split(miss: List[Tuple[int, int, bool]], prof: PipelineProfile,
               enable_recompute: bool = True
               ) -> Tuple[List[int], List[int], float]:
    """miss: [(chunk_idx, io_bytes, recomputable)].

    Returns (recompute_idxs, io_idxs, predicted_delay).  Exact greedy on
    Eq. 4: move the largest-byte recomputable chunk from the I/O channel
    to the recompute channel while the pipeline delay improves.
    """
    io = sorted(miss, key=lambda t: -t[1])
    re: List[Tuple[int, int, bool]] = []
    io_bytes = sum(b for _, b, _ in io)

    def delay(n_re: int, m_io: int) -> float:
        return max(prof.t_re(n_re), prof.t_io(m_io))

    best = delay(0, io_bytes)
    if enable_recompute:
        i = 0
        while i < len(io):
            if not io[i][2]:
                i += 1
                continue
            cand = delay(len(re) + 1, io_bytes - io[i][1])
            if cand < best - 1e-12:
                c = io.pop(i)
                re.append(c)
                io_bytes -= c[1]
                best = cand
            else:
                i += 1
    return [c[0] for c in re], [c[0] for c in io], best
