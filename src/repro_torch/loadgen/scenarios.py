"""Named scenario library for the scale harness.

Each entry is a frozen, seeded ``ScenarioSpec`` — same name + same seed
always synthesizes the same workload and (under the virtual-clock
driver) the same event log.  The library covers the load shapes the
LLMaaS stack is built for (paper §2: one shared model, many apps):

  steady_poisson    open-loop Poisson arrivals over a markov context
                    pattern — the calibration baseline.
  fg_burst_over_bg  bursty foreground interactions arriving over a
                    steady background-agent load: the preemption /
                    decode-slice story (paper §2.2, DESIGN.md §4).
  diurnal_ramp      sinusoidal arrival rate (a day compressed into the
                    trace): queue depth breathes, AoT flushes happen in
                    the troughs.
  herd_restore      thundering-herd: batches of simultaneous arrivals
                    on cold contexts, hammering the restore/switch-in
                    path all at once.
  eviction_churn    adversarial ``sweep`` context pattern over far more
                    contexts than the budget holds — every touch is the
                    coldest context, defeating LRU/LCTRU, maximizing
                    pool reclaims and page faults.
  scale_10k         10^4 contexts / 10^4 calls through the router on
                    CPU in bounded wall time (uniform token source, no
                    disk throttle): the scale soak that surfaces O(n)
                    scans and unbounded retention.
  flaky_disk        transient EIO + bit-flips + torn writes + slow IO
                    injected into the swap tier under eviction pressure
                    (DESIGN.md §6): every fault must be retried or
                    recovered by recompute — zero failed foreground
                    calls, tokens identical to the fault-free run.
  disk_full_churn   ENOSPC windows over the churn workload: the service
                    enters degraded mode (AoT off, background shed),
                    keeps serving foreground via evict+recompute, and
                    exits when the probe write succeeds.
  mixed_zoo         three model families (dense + MLA latent + RWKV6
                    constant state) behind ONE ServiceRouter sharing a
                    single byte budget and swap tier (ZooService);
                    per-family tokens must match each family solo.
  smoke_ci          reduced mixed scenario for the CI gate (seconds).

``get_scenario(name, **overrides)`` returns a (variant of a) library
spec; ``scenario_from_dict`` loads the YAML-ish form, with ``base:``
naming a library entry to overlay.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

from repro_torch.loadgen.spec import ScenarioSpec, load_scenario, validate_spec

_FG_BG = (
    {"name": "chat", "priority": "foreground", "weight": 1.0},
    {"name": "agent", "priority": "background", "weight": 2.0},
)

_SPECS = (
    ScenarioSpec(
        name="steady_poisson", seed=11,
        n_contexts=64, n_calls=512,
        arrival={"kind": "poisson", "rate_per_s": 2.0},
        ctx_pattern="markov",
        prompt_len={"dist": "bimodal", "short": (4, 8), "long": (24, 48),
                    "p_long": 0.15},
        output_len={"dist": "uniform", "lo": 2, "hi": 6},
        apps=_FG_BG,
        notes="open-loop baseline: steady mixed load, moderate reuse"),
    ScenarioSpec(
        name="fg_burst_over_bg", seed=23,
        n_contexts=48, n_calls=640,
        arrival={"kind": "bursty", "rate_per_s": 1.0,
                 "burst_every_s": 40.0, "burst_size": 24,
                 "burst_rate_per_s": 40.0, "burst_frac": 0.4},
        ctx_pattern="markov",
        prompt_len={"dist": "uniform", "lo": 4, "hi": 12},
        output_len={"dist": "uniform", "lo": 2, "hi": 8},
        apps=(
            {"name": "chat", "priority": "foreground", "weight": 1.0,
             "output_len": {"dist": "uniform", "lo": 2, "hi": 4}},
            {"name": "agent", "priority": "background", "weight": 2.0,
             "output_len": {"dist": "uniform", "lo": 10, "hi": 18}},
            {"name": "indexer", "priority": "background", "weight": 1.0,
             "output_len": {"dist": "uniform", "lo": 10, "hi": 18}},
        ),
        slice_steps=2, decode_batch=4,
        notes="burst arrivals route to foreground apps -> preemptions"),
    ScenarioSpec(
        name="diurnal_ramp", seed=37,
        n_contexts=64, n_calls=512,
        arrival={"kind": "diurnal", "rate_per_s": 1.0,
                 "period_s": 600.0, "amplitude": 0.9},
        ctx_pattern="gaussian",
        prompt_len={"dist": "lognormal", "median": 8, "sigma": 0.5,
                    "lo": 2, "hi": 48},
        output_len={"dist": "fixed", "n": 4},
        apps=_FG_BG,
        idle_flush_s=20.0,
        notes="rate breathes over a compressed day; troughs AoT-flush"),
    ScenarioSpec(
        name="herd_restore", seed=41,
        n_contexts=96, n_calls=384,
        arrival={"kind": "herd", "herd_every_s": 30.0, "herd_size": 16,
                 "rate_per_s": 1 / 30.0},
        ctx_pattern="random",
        prompt_len={"dist": "uniform", "lo": 4, "hi": 10},
        output_len={"dist": "fixed", "n": 3},
        apps=_FG_BG,
        memory_budget=24_000,
        notes="simultaneous cold arrivals hammer restore/switch-in"),
    ScenarioSpec(
        name="eviction_churn", seed=53,
        n_contexts=160, n_calls=480,
        arrival={"kind": "uniform", "rate_per_s": 4.0},
        ctx_pattern="sweep",
        prompt_len={"dist": "fixed", "n": 6},
        output_len={"dist": "fixed", "n": 3},
        apps=_FG_BG,
        memory_budget=20_000,
        notes="round-robin over >> budget contexts: every switch-in "
              "misses, reclaim path saturates"),
    ScenarioSpec(
        name="scale_10k", seed=67,
        n_contexts=10_000, n_calls=10_000,
        arrival={"kind": "poisson", "rate_per_s": 50.0},
        ctx_pattern="sweep",
        prompt_len={"dist": "fixed", "n": 4},
        output_len={"dist": "fixed", "n": 2},
        apps=_FG_BG,
        prompt_source="uniform",
        memory_budget=120_000, max_ctx_len=32,
        decode_batch=8, slice_steps=4,
        record_limit=2048, predict=False, profile=False,
        disk_bw=None, model_profile="reduced",
        notes="10^4 contexts through the router on CPU under the "
              "virtual clock in ~1 min; unthrottled swap tier, uniform "
              "tokens, tiny model (the harness is the thing under test)"),
    ScenarioSpec(
        name="flaky_disk", seed=71,
        n_contexts=24, n_calls=160,
        arrival={"kind": "poisson", "rate_per_s": 2.0},
        ctx_pattern="sweep",
        prompt_len={"dist": "uniform", "lo": 4, "hi": 10},
        output_len={"dist": "fixed", "n": 3},
        apps=_FG_BG,
        # 16-bit chunk storage: the bf16->fp16->bf16 payload roundtrip
        # is lossless, so recompute-based recovery is BIT-EXACT and the
        # tokens_sha256 probe must match the fault-free run (quantized
        # tiers recover approximately — deterministic, but not
        # token-identical; DESIGN.md §6)
        policy="llms_nocomp",
        memory_budget=20_000, decode_batch=2,
        faults={"transient_eio": 0.03, "bit_flip": 0.01,
                "torn_write": 0.01, "slow_io": 0.02, "slow_io_s": 0.002,
                "fail_n": 1, "seed": 1234},
        notes="seeded storage faults under eviction churn: every "
              "injected failure is retried or recovered by recompute; "
              "zero failed foreground calls, tokens identical to the "
              "fault-free run"),
    ScenarioSpec(
        name="disk_full_churn", seed=83,
        n_contexts=32, n_calls=192,
        arrival={"kind": "uniform", "rate_per_s": 4.0},
        ctx_pattern="sweep",
        prompt_len={"dist": "fixed", "n": 6},
        output_len={"dist": "fixed", "n": 3},
        apps=_FG_BG,
        policy="llms_nocomp",
        memory_budget=20_000, decode_batch=2,
        # the window closes well before the trace ends so the probe
        # write succeeds and the run finishes OUT of degraded mode
        faults={"disk_full_windows": [[10.0, 25.0]], "seed": 4321},
        notes="ENOSPC window mid-run: enter degraded mode (AoT off, "
              "background shed, evictions drop dirty payloads), keep "
              "serving foreground via recompute, exit via the probe"),
    ScenarioSpec(
        name="mixed_zoo", seed=91,
        n_contexts=9, n_calls=18,
        arrival={"kind": "uniform", "rate_per_s": 2.0},
        # sweep + n_calls = 2*n_contexts: every context is touched
        # exactly twice, so the second call restores the first call's
        # compressed state — the MLA member's quant-resident latent
        # chunks are actually exercised, not just created.  Contexts
        # are bound to apps by driver.bind_apps_by_ctx (ctx_id mod 3),
        # so each app's token hash is comparable against its family
        # served SOLO at the same seed (tokens_sha_by_app).
        ctx_pattern="sweep",
        prompt_len={"dist": "uniform", "lo": 4, "hi": 8},
        output_len={"dist": "fixed", "n": 3},
        # all-foreground: equal priority means no preemption, so every
        # generation runs begin -> decode -> finish uninterrupted and
        # the solo-vs-mixed identity is a statement about the zoo's
        # shared-substrate routing, not about preemption timing
        apps=(
            {"name": "chat", "priority": "foreground", "weight": 1.0,
             "family": "dense"},
            {"name": "scholar", "priority": "foreground", "weight": 1.0,
             "family": "mla_moe"},
            {"name": "agent", "priority": "foreground", "weight": 1.0,
             "family": "rwkv6"},
        ),
        decode_batch=2, slice_steps=8,
        memory_budget=60_000, max_ctx_len=64,
        quant_resident=True, paged_pool=False,
        model_profile="reduced", profile=False,
        notes="three families (dense + MLA latent + RWKV6 constant "
              "state) behind ONE router against one byte budget and "
              "one swap tier; per-family tokens must equal each family "
              "served solo at the same seed"),
    ScenarioSpec(
        name="smoke_ci", seed=7,
        n_contexts=16, n_calls=96,
        arrival={"kind": "bursty", "rate_per_s": 2.0,
                 "burst_every_s": 15.0, "burst_size": 10,
                 "burst_rate_per_s": 20.0, "burst_frac": 0.3},
        ctx_pattern="random",
        prompt_len={"dist": "uniform", "lo": 3, "hi": 8},
        output_len={"dist": "fixed", "n": 3},
        # background outputs run long so slots are occupied when the
        # foreground burst lands — the burst must PREEMPT (uniformly
        # short outputs free slots so fast that continuous refill
        # always seats the burst without evicting anyone)
        apps=(
            {"name": "chat", "priority": "foreground", "weight": 1.0,
             "output_len": {"dist": "uniform", "lo": 2, "hi": 4}},
            {"name": "agent", "priority": "background", "weight": 2.0,
             "output_len": {"dist": "uniform", "lo": 12, "hi": 20}},
        ),
        decode_batch=2,
        memory_budget=24_000, max_ctx_len=64,
        notes="reduced mixed scenario for the CI regression gate"),
)

SCENARIOS: Dict[str, ScenarioSpec] = {s.name: validate_spec(s)
                                      for s in _SPECS}


def get_scenario(name: str, **overrides: Any) -> ScenarioSpec:
    """A library scenario, optionally with fields overridden (the
    variant keeps the base seed unless ``seed=`` is overridden)."""
    try:
        spec = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {sorted(SCENARIOS)})") from None
    return validate_spec(spec.override(**overrides)) if overrides else spec


def scenario_from_dict(doc: Mapping[str, Any]) -> ScenarioSpec:
    """YAML-ish loader entry point: ``base:`` overlays a library spec."""
    doc = dict(doc)
    base = doc.pop("base", None)
    return load_scenario(doc, base=SCENARIOS[base] if base else None)
