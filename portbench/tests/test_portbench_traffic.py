"""The traffic generator: stratified lengths give every seed the same
work in another order and to other contexts."""
import json
from collections import Counter

import numpy as np
import pytest

from portbench_paths import BENCH

import pb_traffic

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("mix", MIXES)
def test_two_seeds_give_one_multiset_in_another_order(mix):
    m = _mix(mix)
    a = pb_traffic.make_plan(m, 1000, 12345)
    b = pb_traffic.make_plan(m, 1000, 2**33 + 7)
    ha = sorted(len(h) for h in a.histories)
    hb = sorted(len(h) for h in b.histories)
    assert ha == hb
    assert [len(h) for h in a.histories] != [len(h) for h in b.histories]
    for app in range(a.n_apps):
        for r0 in range(0, m["calls_per_app"], m["round"]):
            ra = a.calls[app][r0:r0 + m["round"]]
            rb = b.calls[app][r0:r0 + m["round"]]
            assert Counter(len(c.prompt) for c in ra) == \
                Counter(len(c.prompt) for c in rb)
            assert Counter(c.max_new for c in ra) == \
                Counter(c.max_new for c in rb)
    assert [c.ctx for c in a.calls[0]] != [c.ctx for c in b.calls[0]]


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_span_the_mix(mix):
    m = _mix(mix)
    p = pb_traffic.make_plan(m, 1000, 3)
    lens = [len(c.prompt) for cs in p.calls for c in cs]
    assert m["prompt"]["lo"] <= min(lens) and max(lens) <= m["prompt"]["hi"]
    outs = [c.max_new for cs in p.calls for c in cs]
    assert m["output"]["lo"] <= min(outs) and max(outs) <= m["output"]["hi"]
    # each app calls only its own contexts
    for a, cs in enumerate(p.calls):
        assert {p.ctx_app[c.ctx] for c in cs} == {a}


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_have_a_right_tail(mix):
    """Each length's strata climb steeply at the top: the mean lies
    above the median and the top stratum far above it."""
    m = _mix(mix)
    for key in ("history", "prompt", "output"):
        q = pb_traffic.quantiles(m[key], 16)
        assert list(q) == sorted(q)
        assert q.mean() > np.median(q)
        assert q[-1] - np.median(q) > 1.5 * (np.median(q) - q[0])


def test_same_seed_same_plan():
    m = _mix(MIXES[0])
    a = pb_traffic.make_plan(m, 1000, 99)
    b = pb_traffic.make_plan(m, 1000, 99)
    assert all(np.array_equal(x, y) for x, y in zip(a.histories, b.histories))
    assert all(np.array_equal(x.prompt, y.prompt)
               for xs, ys in zip(a.calls, b.calls) for x, y in zip(xs, ys))
