"""The port's trace synthesizer and scale harness against the JAX
package's.

* ``trace.synth``: ``synthesize`` (every pattern) and
  ``synthesize_mixed`` (every arrival kind and context pattern, with
  per-app length overrides) give byte-equal events in both packages,
  for two seeds each; so do ``arrival_times`` and ``sample_lengths``.
* ``loadgen``: the cases of tests/test_loadgen.py that need no
  ``benchmarks`` module, on the port (spec library and loader, the
  virtual-clock driver's determinism, an end-to-end mixed scenario,
  preemption under bursts, the wall-clock replay in both modes).
  ``run_scenario`` against the reference: tests/test_torch_scenarios.py.
* ``mixed_zoo`` needs the multi-family ZooService, which the port
  refuses by name until it is ported.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread, run_scenario_in, scaled_head_pair)
from repro import loadgen as jloadgen
from repro.trace import synth as jsynth
from repro_torch import loadgen as tloadgen
from repro_torch.loadgen.metrics import (EventLog, deterministic_view,
                                         gate_metrics)
from repro_torch.trace import synth as tsynth

HEAD_SCALE = 16.0


def _events_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.time, x.ctx_id, x.dataset, x.priority, x.max_new,
                x.app) == (y.time, y.ctx_id, y.dataset, y.priority,
                           y.max_new, y.app)
        for f in ("prompt", "ground_truth"):
            u, v = getattr(x, f), getattr(y, f)
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


# --------------------------------------------------------------------- #
# trace synthesis: byte-equal to the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("pattern", tsynth.PATTERNS)
def test_synthesize_byte_equal(pattern, seed):
    assert tsynth.PATTERNS == jsynth.PATTERNS
    kw = dict(pattern=pattern, scale=0.1, seed=seed)
    _events_equal(tsynth.synthesize(5, 24, 512, **kw),
                  jsynth.synthesize(5, 24, 512, **kw))


_ARRIVAL_PARAMS = {
    "poisson": {"rate_per_s": 2.0},
    "uniform": {"rate_per_s": 4.0},
    "bursty": {"rate_per_s": 1.0, "burst_every_s": 10.0, "burst_size": 6,
               "burst_rate_per_s": 30.0, "burst_frac": 0.4},
    "diurnal": {"rate_per_s": 1.0, "period_s": 60.0, "amplitude": 0.9},
    "herd": {"rate_per_s": 0.1, "herd_every_s": 10.0, "herd_size": 5},
}
_APPS = ({"name": "chat", "priority": "foreground", "weight": 1.0,
          "output_len": {"dist": "uniform", "lo": 2, "hi": 4}},
         {"name": "agent", "priority": "background", "weight": 2.0,
          "prompt_len": {"dist": "lognormal", "median": 10, "sigma": 0.5,
                         "lo": 2, "hi": 40}})


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("kind", tsynth.ARRIVALS)
def test_synthesize_mixed_byte_equal_per_arrival(kind, seed):
    assert tsynth.ARRIVALS == jsynth.ARRIVALS
    kw = dict(arrival={"kind": kind, **_ARRIVAL_PARAMS[kind]},
              ctx_pattern="markov",
              prompt_len={"dist": "bimodal", "short": (3, 6),
                          "long": (20, 30), "p_long": 0.3},
              output_len={"dist": "fixed", "n": 3}, apps=_APPS, seed=seed)
    _events_equal(tsynth.synthesize_mixed(8, 40, 512, **kw),
                  jsynth.synthesize_mixed(8, 40, 512, **kw))


@pytest.mark.parametrize("seed", [3, 17])
@pytest.mark.parametrize("ctx_pattern", tsynth.CTX_PATTERNS)
@pytest.mark.parametrize("source", ["markov", "uniform"])
def test_synthesize_mixed_byte_equal_per_pattern(ctx_pattern, source, seed):
    assert tsynth.CTX_PATTERNS == jsynth.CTX_PATTERNS
    kw = dict(arrival={"kind": "poisson", "rate_per_s": 2.0},
              ctx_pattern=ctx_pattern, prompt_source=source,
              prompt_len={"dist": "uniform", "lo": 3, "hi": 9},
              output_len={"dist": "lognormal", "median": 4}, apps=_APPS,
              seed=seed)
    _events_equal(tsynth.synthesize_mixed(7, 30, 512, **kw),
                  jsynth.synthesize_mixed(7, 30, 512, **kw))


def test_arrival_times_and_lengths_equal():
    for kind in tsynth.ARRIVALS:
        a = tsynth.arrival_times(kind, 33, 2.0, np.random.RandomState(4),
                                 _ARRIVAL_PARAMS[kind])
        b = jsynth.arrival_times(kind, 33, 2.0, np.random.RandomState(4),
                                 _ARRIVAL_PARAMS[kind])
        assert a[0].tobytes() == b[0].tobytes()
        assert a[1].tobytes() == b[1].tobytes()
    for spec in ({"dist": "fixed", "n": 5}, {"dist": "uniform", "lo": 1,
                                               "hi": 9},
                 {"dist": "lognormal", "median": 12, "sigma": 0.6},
                 {"dist": "bimodal", "short": [2, 4], "long": [30, 40]}):
        a = tsynth.sample_lengths(spec, 50, np.random.RandomState(5))
        b = jsynth.sample_lengths(spec, 50, np.random.RandomState(5))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError):
        tsynth.sample_lengths({"dist": "martian"}, 3,
                              np.random.RandomState(0))


def test_synthesize_seed_sensitivity():
    a = tsynth.synthesize(4, 20, 512, pattern="markov", scale=0.1, seed=0)
    b = tsynth.synthesize(4, 20, 512, pattern="markov", scale=0.1, seed=1)
    assert any(x.ctx_id != y.ctx_id or len(x.prompt) != len(y.prompt)
               for x, y in zip(a, b))


# --------------------------------------------------------------------- #
# spec / scenario library (tests/test_loadgen.py)
# --------------------------------------------------------------------- #
def test_scenario_library_matches_reference():
    """The whole catalog, mixed_zoo included, as data."""
    assert sorted(tloadgen.SCENARIOS) == sorted(jloadgen.SCENARIOS)
    for name, spec in tloadgen.SCENARIOS.items():
        tloadgen.validate_spec(spec)
        assert spec.to_dict() == jloadgen.SCENARIOS[name].to_dict()
    assert tloadgen.SCENARIOS["scale_10k"].n_contexts >= 10_000


def test_get_scenario_override_and_unknown():
    s = tloadgen.get_scenario("smoke_ci", n_calls=8, seed=99)
    assert (s.n_calls, s.seed) == (8, 99)
    assert tloadgen.SCENARIOS["smoke_ci"].n_calls != 8
    with pytest.raises(KeyError):
        tloadgen.get_scenario("nope")


def test_load_scenario_rejects_unknown_keys():
    with pytest.raises((KeyError, ValueError, TypeError)):
        tloadgen.load_scenario({"name": "x", "n_contexts": 4, "n_calls": 8,
                                "no_such_field": 1})


def test_scenario_from_dict_base_overlay():
    s = tloadgen.scenario_from_dict({"base": "smoke_ci", "name": "variant",
                                     "n_calls": 12})
    assert s.name == "variant" and s.n_calls == 12
    assert s.arrival == tloadgen.SCENARIOS["smoke_ci"].arrival


def test_validate_spec_rejects_bad_fields():
    base = tloadgen.SCENARIOS["smoke_ci"]
    with pytest.raises(ValueError):
        tloadgen.validate_spec(base.override(arrival={"kind": "martian"}))
    with pytest.raises(ValueError):
        tloadgen.validate_spec(base.override(ctx_pattern="zigzag"))
    with pytest.raises(ValueError):
        tloadgen.validate_spec(base.override(round_s=-1.0))
    with pytest.raises(ValueError):
        tloadgen.validate_spec(base.override(faults={"martian_eio": 0.1}))


def test_synthesize_mixed_deterministic():
    kw = dict(arrival={"kind": "bursty", "rate_per_s": 2.0,
                       "burst_every_s": 10.0, "burst_size": 6,
                       "burst_rate_per_s": 30.0, "burst_frac": 0.3},
              ctx_pattern="random",
              prompt_len={"dist": "uniform", "lo": 3, "hi": 8},
              output_len={"dist": "fixed", "n": 3},
              apps=[{"name": "chat", "priority": "foreground"},
                    {"name": "agent", "priority": "background"}],
              seed=5)
    a = tsynth.synthesize_mixed(8, 40, 512, **kw)
    _events_equal(a, tsynth.synthesize_mixed(8, 40, 512, **kw))
    assert {e.app for e in a} == {"chat", "agent"}


def test_event_log_retention_bounded():
    log = EventLog(keep=4)
    for i in range(10):
        log.emit("round", float(i), i)
    assert len(log.lines) == 4 and log.n == 10


# --------------------------------------------------------------------- #
# the virtual-clock driver on the port
# --------------------------------------------------------------------- #
def _run(spec, events=None, log_keep=None):
    return run_scenario_in("torch", spec, "llama2-7b", HEAD_SCALE,
                           events=events, log_keep=log_keep)


def test_build_service_defaults_to_the_card(monkeypatch):
    _, _, _, _, tmodel, tparams = scaled_head_pair("llama2-7b", HEAD_SCALE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloadgen.build_service(tloadgen.SCENARIOS["smoke_ci"], tmodel,
                               tparams)


def test_same_seed_runs_identical():
    spec = tloadgen.get_scenario("smoke_ci", n_calls=48)
    events = tloadgen.make_events(spec, 512)
    a, b = _run(spec, events=events), _run(spec, events=events)
    assert a["event_log_sha256"] == b["event_log_sha256"]
    assert a["events_logged"] == b["events_logged"]
    assert deterministic_view(a) == deterministic_view(b)


def test_e2e_mixed_scenario_invariants():
    spec = tloadgen.get_scenario("smoke_ci", n_contexts=64, n_calls=128,
                                 memory_budget=28_000)
    rep = _run(spec)
    assert rep["streams"]["total"] == 128
    assert rep["streams"]["stuck"] == 0
    assert rep["streams"]["errors"] == 0
    assert rep["budget"]["ok"]
    pool = rep["pool"]
    assert pool["pool_pages16_used"] <= pool["pool_pages16_total"]
    r = rep["router"]
    assert r["decoded_tokens"] > 0
    for prio in ("foreground", "background"):
        assert r[prio]["calls"] > 0
        assert r[prio]["wait_p95_s"] >= r[prio]["wait_p50_s"] >= 0.0
    assert r["queue_depth"]["samples"] > 0
    assert rep["virtual_duration_s"] > 0
    gm = gate_metrics(rep)
    assert gm["budget_ok"] and gm["stuck_streams"] == 0


def test_preemption_fires_in_burst_scenario():
    r = _run(tloadgen.get_scenario("smoke_ci"))["router"]
    assert r["preemptions"] > 0
    assert r["preemptions_by_priority"]["background"] > 0
    assert r["preemptions_by_priority"]["foreground"] == 0


@pytest.mark.parametrize("mode", ["serial", "flood"])
def test_replay_trace_contract(mode):
    """The wall-clock replay: serial (strict trace order) and flood
    (admit all, drain; fg/bg split), the router section attached."""
    _, _, _, tcfg, tmodel, tparams = scaled_head_pair("llama2-7b",
                                                      HEAD_SCALE)
    from repro_torch.core.service import LLMService, LLMSConfig
    events = tsynth.synthesize(4, 12, tcfg.vocab, pattern="markov",
                               scale=0.03, seed=2)
    sc = LLMSConfig(max_ctx_len=96, memory_budget=30_000,
                    decode_batch=2 if mode == "flood" else 1)
    with LLMService(tmodel, tparams, sc, device="cpu") as svc:
        kw = {}
        if mode == "flood":
            kw = dict(slice_steps=2,
                      apps=(("chat", "foreground"), ("agent", "background")),
                      route=lambda ev: "chat" if ev.ctx_id % 2 == 0
                      else "agent")
        st = tloadgen.replay_trace(svc, events, mode=mode, max_new=2,
                                   warm=mode == "serial",
                                   measured_throttle=None, **kw)
    r = st["router"]
    assert sum(r[p]["calls"] for p in ("foreground", "background")
               if p in r) == 12
    if mode == "flood":
        assert r["background"]["calls"] > 0
    assert st["switch_mean_s"] >= 0.0 and st["calls"] == 12


def test_mixed_zoo_is_refused():
    spec = tloadgen.SCENARIOS["mixed_zoo"]
    _, _, _, _, tmodel, tparams = scaled_head_pair("llama2-7b", HEAD_SCALE)
    with pytest.raises(NotImplementedError, match="zoo.py"):
        tloadgen.build_zoo_service(spec, {"dense": (tmodel, tparams)})
