"""Context-switching trace synthesis (paper §4, Eq. 5 + Table 3).

Trace = {(Time_i, CtxtID_i, Prompt_i, groundTruth_i)} with Poisson
arrivals and three switching patterns:

  Random    uniform over active contexts
  Markov    first-order chain favouring recently-used contexts
  Gaussian  preference for contexts with moderate delta-length workload

The paper derives prompts from 6 public datasets; offline we synthesize
token sequences from the same seeded Markov language as the training
pipeline, with each "dataset" keeping Table 3's delta-length range.
Traces are deterministic in (seed, pattern, n_contexts, calls).

**Scenario-parameterized synthesis** (the loadgen scale harness,
DESIGN.md "Scale harness"): ``arrival_times`` generates seeded arrival
processes beyond plain Poisson — bursty foreground-over-background,
diurnal ramps, thundering herds, uniform churn — and
``synthesize_mixed`` composes an arrival process with a context-
selection pattern (including the adversarial ``sweep``), mixed
prompt/output-length distributions, and a per-app priority mix into
one deterministic event list.  Everything is a plain dict/ndarray
interface so ``repro.loadgen`` stays the only layer that knows about
scenario specs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import markov_sample, markov_table

# Table 3: dataset -> (delta_lo, delta_hi) in tokens.  Scaled by
# ``scale`` for reduced-model benchmarks (the paper's are 0.01k-2k).
TABLE3 = {
    "agnews": (200, 500),
    "xsum": (1000, 2000),
    "samsum": (100, 300),
    "cnn_dailymail": (500, 1000),
    "wmt17_de_en": (100, 500),
    "sst2": (10, 100),
}
PATTERNS = ("random", "markov", "gaussian")
# context-selection patterns for scenario synthesis: the classic three
# plus "sweep" — strict round-robin over ALL contexts, the adversarial
# case for LRU/LCTRU (every touch is the coldest context, so every
# switch-in misses)
CTX_PATTERNS = PATTERNS + ("sweep",)
ARRIVALS = ("poisson", "uniform", "bursty", "diurnal", "herd")


@dataclass
class TraceEvent:
    time: float
    ctx_id: int
    prompt: np.ndarray          # int32 tokens
    ground_truth: np.ndarray    # int32 tokens (ideal output)
    dataset: str
    # scenario extensions (defaults keep classic synthesize() events
    # working everywhere): per-event priority/app assignment and output
    # budget, filled in by synthesize_mixed
    priority: Optional[str] = None
    max_new: int = 4
    app: str = ""


def synthesize(n_contexts: int, n_calls: int, vocab: int,
               pattern: str = "random", rate_per_s: float = 1 / 300.0,
               scale: float = 1.0, seed: int = 0,
               datasets: Tuple[str, ...] = tuple(TABLE3)) -> List[TraceEvent]:
    """rate_per_s: Poisson calling rate (paper default: 1 per 5 min)."""
    assert pattern in PATTERNS, pattern
    rng = np.random.RandomState(seed)
    table = markov_table(vocab, seed=seed + 77)
    ctx_dataset = [datasets[i % len(datasets)] for i in range(n_contexts)]
    # per-context mean delta (for the gaussian preference pattern)
    deltas = np.array([np.mean(TABLE3[d]) * scale for d in ctx_dataset])
    target = np.median(deltas)
    gauss_w = np.exp(-0.5 * ((deltas - target) / (deltas.std() + 1e-9)) ** 2)
    gauss_w /= gauss_w.sum()

    events: List[TraceEvent] = []
    t = 0.0
    prev = rng.randint(n_contexts)
    for _ in range(n_calls):
        t += rng.exponential(1.0 / rate_per_s)
        if pattern == "random":
            cid = rng.randint(n_contexts)
        elif pattern == "gaussian":
            cid = rng.choice(n_contexts, p=gauss_w)
        else:  # markov: stay with recently-used w.p. 0.5, else uniform
            if rng.rand() < 0.5:
                cid = prev
            else:
                cid = rng.randint(n_contexts)
        prev = cid
        lo, hi = TABLE3[ctx_dataset[cid]]
        n = max(2, int(rng.randint(int(lo * scale), int(hi * scale) + 1)))
        n_prompt = max(1, int(n * 0.8))
        seqtoks = markov_sample(table, n, rng)
        events.append(TraceEvent(
            time=t, ctx_id=cid, prompt=seqtoks[:n_prompt],
            ground_truth=seqtoks[n_prompt:], dataset=ctx_dataset[cid]))
    return events


# --------------------------------------------------------------------- #
# scenario-parameterized synthesis (loadgen scale harness)
# --------------------------------------------------------------------- #
def arrival_times(kind: str, n_calls: int, rate_per_s: float,
                  rng: np.random.RandomState,
                  params: Optional[Dict] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded arrival process -> (times (n,) float64 ascending,
    burst_flags (n,) bool).  ``burst_flags`` marks arrivals that belong
    to a burst/herd (the scenario layer routes those to foreground
    apps).  All processes are deterministic in (kind, n, rate, rng).

      poisson   homogeneous Poisson at ``rate_per_s``
      uniform   evenly spaced 1/rate apart (steady churn baseline)
      bursty    Poisson base load + periodic high-rate bursts
                (``burst_every_s``, ``burst_size``, ``burst_rate_per_s``)
      diurnal   inhomogeneous Poisson, sinusoidal rate
                ``rate * (1 + amplitude * sin(2 pi t / period_s))``
                via thinning
      herd      ``herd_size`` simultaneous arrivals every
                ``herd_every_s`` (thundering-herd restores)
    """
    assert kind in ARRIVALS, kind
    p = params or {}
    if kind == "poisson":
        times = np.cumsum(rng.exponential(1.0 / rate_per_s, n_calls))
        return times, np.zeros(n_calls, bool)
    if kind == "uniform":
        times = (np.arange(n_calls, dtype=np.float64) + 1.0) / rate_per_s
        return times, np.zeros(n_calls, bool)
    if kind == "bursty":
        burst_every = float(p.get("burst_every_s", 60.0))
        burst_size = int(p.get("burst_size", max(4, n_calls // 8)))
        burst_rate = float(p.get("burst_rate_per_s", rate_per_s * 50.0))
        n_burst = min(n_calls - 1, int(p.get(
            "burst_frac", 0.5) * n_calls))
        n_base = n_calls - n_burst
        base = np.cumsum(rng.exponential(1.0 / rate_per_s, n_base))
        bursts, t0 = [], burst_every
        while len(bursts) < n_burst:
            k = min(burst_size, n_burst - len(bursts))
            bursts.extend(t0 + np.cumsum(rng.exponential(1.0 / burst_rate,
                                                         k)))
            t0 += burst_every
        bursts = np.asarray(bursts[:n_burst])
        times = np.concatenate([base, bursts])
        flags = np.concatenate([np.zeros(n_base, bool),
                                np.ones(n_burst, bool)])
        order = np.argsort(times, kind="stable")
        return times[order], flags[order]
    if kind == "diurnal":
        period = float(p.get("period_s", 86400.0))
        amp = min(0.999, float(p.get("amplitude", 0.8)))
        peak = rate_per_s * (1.0 + amp)
        times = np.empty(n_calls)
        t, i = 0.0, 0
        while i < n_calls:
            t += rng.exponential(1.0 / peak)
            lam = rate_per_s * (1.0 + amp * np.sin(2 * np.pi * t / period))
            if rng.rand() * peak < lam:
                times[i] = t
                i += 1
        return times, np.zeros(n_calls, bool)
    # herd: bunches of simultaneous arrivals separated by idle gaps
    herd_every = float(p.get("herd_every_s", 1.0 / rate_per_s))
    herd_size = int(p.get("herd_size", max(2, n_calls // 8)))
    times = np.empty(n_calls)
    flags = np.ones(n_calls, bool)
    t0, i = herd_every, 0
    while i < n_calls:
        k = min(herd_size, n_calls - i)
        times[i:i + k] = t0
        i += k
        t0 += herd_every
    return times, flags


def sample_lengths(spec: Dict, n: int, rng: np.random.RandomState
                   ) -> np.ndarray:
    """Seeded per-event lengths from a distribution spec dict:

      {"dist": "fixed",     "n": 8}
      {"dist": "uniform",   "lo": 4, "hi": 16}
      {"dist": "lognormal", "median": 12, "sigma": 0.6,
                            "lo": 2, "hi": 256}
      {"dist": "bimodal",   "short": [4, 8], "long": [48, 96],
                            "p_long": 0.2}
    """
    dist = spec.get("dist", "fixed")
    if dist == "fixed":
        return np.full(n, int(spec.get("n", 8)), np.int64)
    if dist == "uniform":
        lo, hi = int(spec["lo"]), int(spec["hi"])
        return rng.randint(lo, hi + 1, size=n).astype(np.int64)
    if dist == "lognormal":
        med = float(spec.get("median", 12.0))
        sigma = float(spec.get("sigma", 0.6))
        lo = int(spec.get("lo", 1))
        hi = int(spec.get("hi", 4 * med))
        draw = np.exp(rng.normal(np.log(med), sigma, size=n))
        return np.clip(np.round(draw), lo, hi).astype(np.int64)
    if dist == "bimodal":
        s_lo, s_hi = (int(x) for x in spec.get("short", (4, 8)))
        l_lo, l_hi = (int(x) for x in spec.get("long", (48, 96)))
        p_long = float(spec.get("p_long", 0.2))
        is_long = rng.rand(n) < p_long
        out = rng.randint(s_lo, s_hi + 1, size=n)
        out[is_long] = rng.randint(l_lo, l_hi + 1, size=int(is_long.sum()))
        return out.astype(np.int64)
    raise ValueError(f"unknown length dist {dist!r}")


def _select_contexts(pattern: str, n_contexts: int, n_calls: int,
                     rng: np.random.RandomState) -> np.ndarray:
    assert pattern in CTX_PATTERNS, pattern
    if pattern == "sweep":
        return (np.arange(n_calls) % n_contexts).astype(np.int64)
    if pattern == "random":
        return rng.randint(n_contexts, size=n_calls).astype(np.int64)
    if pattern == "gaussian":
        # moderate-index preference, mirroring classic synthesize's
        # delta-length shaping without the Table-3 datasets
        idx = np.arange(n_contexts)
        w = np.exp(-0.5 * ((idx - n_contexts / 2) /
                           (0.25 * n_contexts + 1e-9)) ** 2)
        w /= w.sum()
        return rng.choice(n_contexts, size=n_calls, p=w).astype(np.int64)
    # markov: stay with the previous context w.p. 0.5
    out = np.empty(n_calls, np.int64)
    prev = rng.randint(n_contexts)
    stay = rng.rand(n_calls) < 0.5
    jumps = rng.randint(n_contexts, size=n_calls)
    for i in range(n_calls):
        prev = prev if stay[i] else jumps[i]
        out[i] = prev
    return out


def synthesize_mixed(n_contexts: int, n_calls: int, vocab: int, *,
                     arrival: Optional[Dict] = None,
                     ctx_pattern: str = "markov",
                     prompt_len: Optional[Dict] = None,
                     output_len: Optional[Dict] = None,
                     apps: Optional[Sequence[Dict]] = None,
                     prompt_source: str = "markov",
                     seed: int = 0) -> List[TraceEvent]:
    """Scenario-parameterized trace: one arrival process x one context
    pattern x length distributions x a per-app priority mix, all from
    one seed.  Burst/herd-flagged arrivals go to foreground apps and
    the rest to background apps (when both exist) — the load shape the
    scheduler's preemption is built for.  An app dict may carry its own
    ``prompt_len``/``output_len`` spec overriding the global one (e.g.
    long-running background agents under short foreground taps).
    Plain-dict parameters so any layer (loadgen specs, tests, ad-hoc
    scripts) can drive it."""
    arrival = arrival or {"kind": "poisson", "rate_per_s": 1 / 300.0}
    prompt_len = prompt_len or {"dist": "uniform", "lo": 4, "hi": 16}
    output_len = output_len or {"dist": "fixed", "n": 4}
    apps = list(apps or ({"name": "app0", "priority": "foreground",
                          "weight": 1.0},))
    rng = np.random.RandomState(seed)
    times, flags = arrival_times(arrival.get("kind", "poisson"), n_calls,
                                 float(arrival.get("rate_per_s", 1 / 300.0)),
                                 rng, arrival)
    cids = _select_contexts(ctx_pattern, n_contexts, n_calls, rng)
    p_lens = sample_lengths(prompt_len, n_calls, rng)
    o_lens = sample_lengths(output_len, n_calls, rng)

    w = np.asarray([float(a.get("weight", 1.0)) for a in apps])
    w = w / w.sum()
    fg_idx = [i for i, a in enumerate(apps)
              if str(a.get("priority", "foreground")).startswith(("f", "F"))]
    bg_idx = [i for i in range(len(apps)) if i not in fg_idx]
    app_choice = rng.choice(len(apps), size=n_calls, p=w)
    if flags.any() and fg_idx and bg_idx:
        wf = w[fg_idx] / w[fg_idx].sum()
        wb = w[bg_idx] / w[bg_idx].sum()
        n_f, n_b = int(flags.sum()), int((~flags).sum())
        app_choice[flags] = np.asarray(fg_idx)[
            rng.choice(len(fg_idx), size=n_f, p=wf)]
        app_choice[~flags] = np.asarray(bg_idx)[
            rng.choice(len(bg_idx), size=n_b, p=wb)]

    # per-app length overrides (drawn for every call up front so the
    # rng stream — and thus the whole trace — stays deterministic
    # regardless of which calls each app ends up with)
    for j, a in enumerate(apps):
        if "prompt_len" in a:
            over = sample_lengths(a["prompt_len"], n_calls, rng)
            p_lens = np.where(app_choice == j, over, p_lens)
        if "output_len" in a:
            over = sample_lengths(a["output_len"], n_calls, rng)
            o_lens = np.where(app_choice == j, over, o_lens)

    table = (markov_table(vocab, seed=seed + 77)
             if prompt_source == "markov" else None)
    events: List[TraceEvent] = []
    for i in range(n_calls):
        n = int(p_lens[i])
        if table is not None:
            prompt = markov_sample(table, n, rng)
        else:
            prompt = rng.randint(1, vocab, size=n).astype(np.int32)
        a = apps[int(app_choice[i])]
        events.append(TraceEvent(
            time=float(times[i]), ctx_id=int(cids[i]), prompt=prompt,
            ground_truth=np.empty(0, np.int32), dataset="scenario",
            priority=str(a.get("priority", "foreground")),
            max_new=int(o_lens[i]), app=str(a.get("name", "app0"))))
    return events
