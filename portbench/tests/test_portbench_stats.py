"""The percentile and rate arithmetic of a window."""
import math

import numpy as np
import pytest

import portbench_paths  # noqa: F401

import pb_stats


@pytest.mark.parametrize("q", [50, 90, 95])
def test_percentile_is_numpys_linear(q):
    xs = np.random.default_rng(1).exponential(size=101)
    assert pb_stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_a_stall_moves_the_tail_and_the_rate():
    # 100 calls, a token every 20 ms each; then one 2 s stall of the
    # service delays every token after it
    times = [[0.02 * i for i in range(1, 26)] for _ in range(100)]
    stalled = [[t + (2.0 if t > 0.25 else 0.0) for t in ts] for ts in times]
    gaps = [g for ts in times for g in pb_stats.gaps(ts)]
    gaps_s = [g for ts in stalled for g in pb_stats.gaps(ts)]
    assert pb_stats.percentile(gaps_s, 99.9) > 10 * pb_stats.percentile(
        gaps, 99.9)
    flat = [t for ts in times for t in ts]
    flat_s = [t for ts in stalled for t in ts]
    assert pb_stats.rate(flat_s, 0, 0.6) < pb_stats.rate(flat, 0, 0.6) / 2


def test_a_failed_call_is_beyond_every_limit():
    ttft = [0.1] * 9 + [math.inf]
    assert pb_stats.percentile(ttft, 50) == 0.1
    assert math.isinf(pb_stats.percentile(ttft, 95))
