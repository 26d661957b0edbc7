"""The port's virtual-clock scenario driver against the JAX package's.

``run_scenario``'s ``deterministic_view`` (event-log hash, virtual-time
QoS, queue depth, pool, fault and I/O counters, token hash) is equal in
both packages for ``steady_poisson``, ``fg_burst_over_bg``,
``flaky_disk`` and ``disk_full_churn``, cut to fewer contexts and calls,
and for ``smoke_ci`` (where bursts preempt), on the reduced smollm-360m
of the router tests (tied head scaled 16x, as in
tests/test_torch_router.py).  One part of the view is held apart: the
bytes written include each chunk file's pickled header, which holds the
per-layer CRCs, and pickle writes a CRC at or above 2^31 in two more
bytes than one below; deeper layers' K/V (and so their CRCs) differ at
bf16 level between the packages (ROADMAP.md, Queue 3).  So the bytes
written are compared without the headers, whose sizes are counted in
each package.

On the reduced llama2-7b (head scaled 16x) the same comparison meets a
greedy near-tie: the test shows that at the first token the packages
disagree on, the reference's top-2 gap is below the two packages'
logit difference at that step (ROADMAP.md, Queue 3).
"""
import pickle
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, run_scenario_in  # noqa: F401
from repro import loadgen as jloadgen
from repro.core import restore as jrestore
from repro_torch import loadgen as tloadgen
from repro_torch.core import restore as trestore
from repro_torch.loadgen.metrics import deterministic_view

HEAD_SCALE = 16.0
# the scenarios' shapes, at fewer contexts and calls
_CUT = {
    "steady_poisson": dict(n_contexts=16, n_calls=64),
    "fg_burst_over_bg": dict(n_contexts=12, n_calls=64),
    "flaky_disk": dict(n_contexts=12, n_calls=64),
    "disk_full_churn": dict(n_contexts=12, n_calls=96),
    "smoke_ci": {},
}


def _run(pkg, name, model="smollm-360m"):
    lib = tloadgen if pkg == "torch" else jloadgen
    return run_scenario_in(pkg, lib.get_scenario(name, **_CUT[name]), model,
                           HEAD_SCALE)


@pytest.fixture
def header_bytes(monkeypatch):
    """Count the pickled chunk-file header bytes each package writes."""
    counts = {}
    for key, mod in (("jax", jrestore), ("torch", trestore)):
        counts[key] = 0

        def dumps(obj, protocol=None, _key=key):
            b = pickle.dumps(obj, protocol=protocol)
            counts[_key] += len(b)
            return b

        monkeypatch.setattr(mod, "pickle", types.SimpleNamespace(
            dumps=dumps, loads=pickle.loads,
            HIGHEST_PROTOCOL=pickle.HIGHEST_PROTOCOL))
    return counts


def _view_without_headers(rep, header):
    view = deterministic_view(rep)
    io = dict(view.pop("io"))
    io["disk_bytes_written"] -= header
    io.pop("bytes_moved_per_token")
    return view, io


@pytest.mark.parametrize("name", sorted(_CUT))
def test_deterministic_view_matches_reference(name, header_bytes):
    assert tloadgen.get_scenario(name, **_CUT[name]).to_dict() == \
        jloadgen.get_scenario(name, **_CUT[name]).to_dict()
    rep_t = _run("torch", name)
    rep_j = _run("jax", name)
    view_t, io_t = _view_without_headers(rep_t, header_bytes["torch"])
    view_j, io_j = _view_without_headers(rep_j, header_bytes["jax"])
    diff = {k: (view_j.get(k), view_t.get(k))
            for k in set(view_t) | set(view_j)
            if view_t.get(k) != view_j.get(k)}
    assert not diff, diff
    assert io_t == io_j
    assert header_bytes["torch"] > 0 and io_t["disk_bytes_read"] > 0
    assert rep_t["streams"]["stuck"] == 0
    r = rep_t["router"]
    assert r["decoded_tokens"] > 0
    if name == "smoke_ci":
        assert r["preemptions"] > 0
    if name == "flaky_disk":
        assert rep_t["faults"]["faults_injected_total"] > 0
    if name == "disk_full_churn":
        assert rep_t["faults"]["degraded_entries"] >= 1


def test_llama2_divergence_is_a_near_tie(monkeypatch):
    """steady_poisson (cut) on the reduced llama2-7b: record every
    prefill's and decode round's logits in both packages.  Either every
    greedy pick agrees, or at the first pick that differs the
    reference's top-2 gap is smaller than the packages' largest logit
    difference at that step: a near-tie, not a fault."""
    from repro.loadgen import driver as jdriver
    from repro_torch.loadgen import driver as tdriver
    picks = {}
    for key, drv in (("jax", jdriver), ("torch", tdriver)):
        real = drv.run_scenario

        def run(spec, svc, vocab, _real=real, _key=key, **kw):
            out = picks.setdefault(_key, [])
            exe = svc.exe
            for entry in ("paged_extend", "paged_decode"):
                fn = getattr(exe, entry)

                def rec(*a, _fn=fn, **k):
                    res = _fn(*a, **k)
                    lg = np.asarray(res[1], np.float32)
                    out.append(lg.reshape(-1, lg.shape[-1]))
                    return res

                setattr(exe, entry, rec)
            return _real(spec, svc, vocab, **kw)

        monkeypatch.setattr(drv, "run_scenario", run)
    monkeypatch.setattr(tloadgen, "run_scenario", tdriver.run_scenario)
    monkeypatch.setattr(jloadgen, "run_scenario", jdriver.run_scenario)
    _run("torch", "steady_poisson", "llama2-7b")
    _run("jax", "steady_poisson", "llama2-7b")
    assert len(picks["torch"]) == len(picks["jax"]) > 0
    for lj, lt in zip(picks["jax"], picks["torch"]):
        if lj.shape == lt.shape and (lj.argmax(-1) == lt.argmax(-1)).all():
            continue
        row = int(np.flatnonzero(lj.argmax(-1) != lt.argmax(-1))[0])
        top2 = np.sort(lj[row])[-2:]
        gap = float(top2[1] - top2[0])
        err = float(np.abs(lj[row] - lt[row]).max())
        assert gap < err, (gap, err)
        break
