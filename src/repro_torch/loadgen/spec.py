"""Declarative scenario specs for the scale harness (DESIGN.md "Scale
harness").

A ``ScenarioSpec`` is the full description of one load experiment:
the synthetic workload (arrival process x context-selection pattern x
length distributions x per-app priority mix, all derived from ONE
seed), the service configuration it runs against, and the virtual-time
cost model the driver uses to advance the simulation clock.  Specs are
frozen dataclasses so a named scenario can never be mutated in place —
derive variants with ``override()``.

``load_scenario`` is the YAML-ish loader: it accepts the plain-dict
form (what ``yaml.safe_load`` of a scenario file would produce) and
validates every field against the spec schema, so a typo'd key or an
unknown arrival kind fails loudly at load time instead of silently
running the default workload.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core.faults import plan_from_config
from repro_torch.trace.synth import ARRIVALS, CTX_PATTERNS

_PRIORITIES = ("foreground", "fg", "background", "bg")
_LEN_DISTS = ("fixed", "uniform", "lognormal", "bimodal")


def _default_arrival() -> Dict[str, Any]:
    return {"kind": "poisson", "rate_per_s": 0.5}


def _default_prompt_len() -> Dict[str, Any]:
    return {"dist": "uniform", "lo": 4, "hi": 12}


def _default_output_len() -> Dict[str, Any]:
    return {"dist": "fixed", "n": 4}


def _default_apps() -> Tuple[Dict[str, Any], ...]:
    return ({"name": "app0", "priority": "foreground", "weight": 1.0},)


@dataclass(frozen=True)
class ScenarioSpec:
    """One named, seeded load scenario (workload + service + cost model).

    Workload fields feed ``trace.synth.synthesize_mixed``; service
    fields feed ``driver.build_service``; the cost-model fields are the
    virtual seconds the driver charges per scheduling event so QoS
    metrics are deterministic in the seed (DESIGN.md "Scale harness").
    """
    name: str
    n_contexts: int
    n_calls: int
    seed: int = 0
    # -- workload ------------------------------------------------------ #
    arrival: Mapping[str, Any] = field(default_factory=_default_arrival)
    ctx_pattern: str = "markov"
    prompt_len: Mapping[str, Any] = field(default_factory=_default_prompt_len)
    output_len: Mapping[str, Any] = field(default_factory=_default_output_len)
    apps: Tuple[Mapping[str, Any], ...] = field(default_factory=_default_apps)
    prompt_source: str = "markov"        # "uniform" skips the markov walk
    # -- service under test -------------------------------------------- #
    model_profile: str = "bench"         # "bench" (~8M) | "reduced" (tiny)
    policy: str = "llms"
    memory_budget: int = 30_000
    max_ctx_len: int = 96
    chunk_tokens: int = 16
    decode_batch: int = 4
    slice_steps: int = 2
    paged_pool: bool = True
    quant_resident: bool = False
    record_limit: Optional[int] = 4096   # bound per-call dict retention
    predict: bool = True                 # §3.4 next-context hints
    profile: bool = True                 # profile_pipeline for llms policy
    disk_bw: Optional[float] = 25e6      # None = unthrottled swap tier
    disk_lat: float = 2e-4
    # -- virtual-time cost model (simulated seconds) -------------------- #
    round_s: float = 0.05                # one batched decode round
    prefill_per_token_s: float = 0.01    # charged at begin (not resume)
    switch_base_s: float = 0.2           # begin/resume fixed cost
    idle_flush_s: Optional[float] = 60.0  # virtual idle gap -> AoT flush
    # -- fault injection (DESIGN.md §6) --------------------------------- #
    # per-kind rates + meta knobs, validated by faults.plan_from_config:
    #   transient_eio/persistent_eio/enospc/torn_write/bit_flip/slow_io/
    #   pool_admit (rates), fail_n, slow_io_s, seed (defaults spec.seed),
    #   disk_full_windows ([[t_on, t_off], ...] in VIRTUAL seconds),
    #   swap_deadline_s (per-slice switch-in watchdog).
    faults: Mapping[str, Any] = field(default_factory=dict)
    notes: str = ""

    def override(self, **kw) -> "ScenarioSpec":
        """A variant spec with the given fields replaced (reduced CI
        sizes, sweep points, ...)."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["apps"] = [dict(a) for a in self.apps]
        d["arrival"] = dict(self.arrival)
        d["prompt_len"] = dict(self.prompt_len)
        d["output_len"] = dict(self.output_len)
        d["faults"] = {k: (list(list(w) for w in v)
                           if k == "disk_full_windows" else v)
                       for k, v in self.faults.items()}
        return d


_FIELDS = {f.name for f in dataclasses.fields(ScenarioSpec)}
_REQUIRED = ("name", "n_contexts", "n_calls")


def validate_spec(spec: ScenarioSpec) -> ScenarioSpec:
    """Schema checks beyond dataclass typing; returns the spec."""
    if spec.n_contexts <= 0 or spec.n_calls <= 0:
        raise ValueError(f"{spec.name}: n_contexts/n_calls must be > 0")
    kind = spec.arrival.get("kind", "poisson")
    if kind not in ARRIVALS:
        raise ValueError(f"{spec.name}: unknown arrival kind {kind!r} "
                         f"(one of {ARRIVALS})")
    if float(spec.arrival.get("rate_per_s", 0.5)) <= 0:
        raise ValueError(f"{spec.name}: arrival rate_per_s must be > 0")
    if spec.ctx_pattern not in CTX_PATTERNS:
        raise ValueError(f"{spec.name}: unknown ctx_pattern "
                         f"{spec.ctx_pattern!r} (one of {CTX_PATTERNS})")
    for ln, which in ((spec.prompt_len, "prompt_len"),
                      (spec.output_len, "output_len")):
        if ln.get("dist", "fixed") not in _LEN_DISTS:
            raise ValueError(f"{spec.name}: {which} dist "
                             f"{ln.get('dist')!r} (one of {_LEN_DISTS})")
    if not spec.apps:
        raise ValueError(f"{spec.name}: at least one app required")
    names = set()
    for a in spec.apps:
        nm = a.get("name")
        if not nm or nm in names:
            raise ValueError(f"{spec.name}: apps need unique names")
        names.add(nm)
        if str(a.get("priority", "foreground")).lower() not in _PRIORITIES:
            raise ValueError(f"{spec.name}: app {nm!r} priority "
                             f"{a.get('priority')!r}")
        for which in ("prompt_len", "output_len"):   # per-app overrides
            if which in a and a[which].get("dist",
                                           "fixed") not in _LEN_DISTS:
                raise ValueError(f"{spec.name}: app {nm!r} {which} dist "
                                 f"{a[which].get('dist')!r}")
    if spec.prompt_source not in ("markov", "uniform"):
        raise ValueError(f"{spec.name}: prompt_source "
                         f"{spec.prompt_source!r}")
    if spec.model_profile not in ("bench", "reduced"):
        raise ValueError(f"{spec.name}: model_profile "
                         f"{spec.model_profile!r} (bench | reduced)")
    if spec.slice_steps < 0 or spec.decode_batch < 1:
        raise ValueError(f"{spec.name}: bad slice_steps/decode_batch")
    if min(spec.round_s, spec.prefill_per_token_s, spec.switch_base_s) < 0:
        raise ValueError(f"{spec.name}: cost model must be >= 0")
    if spec.faults:
        try:
            plan_from_config(dict(spec.faults), spec.seed)
        except (ValueError, TypeError) as e:
            raise ValueError(f"{spec.name}: bad faults config: {e}") from e
        for w in spec.faults.get("disk_full_windows", ()):
            a, b = float(w[0]), float(w[1])
            if not 0 <= a < b:
                raise ValueError(f"{spec.name}: disk_full_window {w} "
                                 "needs 0 <= t_on < t_off")
        dl = spec.faults.get("swap_deadline_s")
        if dl is not None and float(dl) <= 0:
            raise ValueError(f"{spec.name}: swap_deadline_s must be > 0")
    return spec


def load_scenario(doc: Mapping[str, Any],
                  base: Optional[ScenarioSpec] = None) -> ScenarioSpec:
    """Build a validated spec from a plain dict (e.g. parsed YAML).

    Unknown keys are an error, not a warning: a scenario file that
    misspells ``slice_steps`` must not silently run the default.  With
    ``base``, the dict is an OVERLAY — only the given fields replace
    the base spec's (used for reduced CI variants of named scenarios).
    """
    unknown = set(doc) - _FIELDS
    if unknown:
        raise ValueError(f"unknown scenario fields: {sorted(unknown)}")
    if base is None:
        missing = [k for k in _REQUIRED if k not in doc]
        if missing:
            raise ValueError(f"scenario missing required fields: {missing}")
        spec = ScenarioSpec(**{k: _coerce(k, v) for k, v in doc.items()})
    else:
        spec = base.override(**{k: _coerce(k, v) for k, v in doc.items()})
    return validate_spec(spec)


def _coerce(key: str, val: Any) -> Any:
    """Normalize loader-friendly forms (lists -> tuples for apps)."""
    if key == "apps":
        return tuple(dict(a) for a in val)
    return val
