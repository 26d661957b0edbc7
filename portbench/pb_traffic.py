"""The closed-loop app traffic of a cell, drawn from its mix file and a seed.

A mix file (``portbench/traffic/<mix>.json``) gives, in tokens:

  apps, contexts_per_app         apps, each with its own persistent contexts
  history, prompt, output        each context's history, built at set-up,
                                 and each call's prompt and greedy answer,
                                 as {median, sigma, lo, hi}: a lognormal
                                 of that median and log-sd, clipped to
                                 [lo, hi]
  round                          calls an app makes per stratum round
  calls_per_app                  calls drawn per app (more than a window uses)
  stay                           the markov pattern's chance that an app
                                 calls the context it called last
  kv_budget_share | kv_budget_mib  the service's KV budget: a share of the
                                 contexts' bf16 KV at their set-up lengths,
                                 or MiB

Lengths are stratified over a heavy-tailed distribution: the ``n``
values of a draw are the lognormal's quantiles at the midpoints of ``n``
equal strata of probability, clipped to [lo, hi] and rounded, put in an
order drawn from the seed.  Histories are stratified over all contexts; prompts and
outputs over each round of ``round`` calls of an app.  So every seed
gives the same multiset of lengths, and every whole round of calls the
same work, in a different order and to different contexts.

The context an app calls is the ``markov`` pattern of
``repro_torch/trace/synth.py`` over the app's own contexts: the one it
called last with chance ``stay``, else one drawn uniformly.  Token ids
are uniform over the vocabulary.  Everything comes from one
``numpy.random.default_rng(seed)``, which takes any seed of up to 128
bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List

import numpy as np


def quantiles(d: Dict, n: int) -> np.ndarray:
    """The ``n`` stratum lengths of the length distribution ``d``
    ({median, sigma, lo, hi}), in increasing order."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    v = [float(d["median"]) * math.exp(float(d["sigma"]) * x) for x in z]
    return np.clip(np.round(v), d["lo"], d["hi"]).astype(np.int64)


def stratified(d: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths of ``d``, one from each of ``n`` equal strata of
    probability, in an order drawn from ``rng``."""
    return rng.permutation(quantiles(d, n))


@dataclass
class Call:
    app: int
    ctx: int                    # index into Plan.histories
    prompt: np.ndarray          # int32 token ids
    max_new: int


@dataclass
class Plan:
    histories: List[np.ndarray]             # per context, int32 ids
    ctx_app: List[int]                      # the app owning each context
    calls: List[List[Call]]                 # per app, in issue order
    mix: Dict = field(default_factory=dict)

    @property
    def n_apps(self) -> int:
        return len(self.calls)


def make_plan(mix: Dict, vocab: int, seed: int) -> Plan:
    rng = np.random.default_rng(seed)
    n_apps, cpa = int(mix["apps"]), int(mix["contexts_per_app"])
    n_ctx = n_apps * cpa
    hist_len = stratified(mix["history"], n_ctx, rng)
    histories = [rng.integers(0, vocab, size=int(n), dtype=np.int32)
                 for n in hist_len]
    ctx_app = [c // cpa for c in range(n_ctx)]
    rnd, n_calls = int(mix["round"]), int(mix["calls_per_app"])
    stay = float(mix["stay"])
    calls: List[List[Call]] = []
    for a in range(n_apps):
        own = list(range(a * cpa, (a + 1) * cpa))
        prev = own[int(rng.integers(cpa))]
        app_calls: List[Call] = []
        while len(app_calls) < n_calls:
            p_len = stratified(mix["prompt"], rnd, rng)
            o_len = stratified(mix["output"], rnd, rng)
            for pl, ol in zip(p_len, o_len):
                if rng.random() >= stay:
                    prev = own[int(rng.integers(cpa))]
                app_calls.append(Call(
                    app=a, ctx=prev,
                    prompt=rng.integers(0, vocab, size=int(pl),
                                        dtype=np.int32),
                    max_new=int(ol)))
        calls.append(app_calls[:n_calls])
    return Plan(histories, ctx_app, calls, dict(mix))


def kv_budget_bytes(mix: Dict, plan: Plan, kv_bytes_per_token: float) -> int:
    """The service's KV budget in bytes, from the mix."""
    if "kv_budget_mib" in mix:
        return int(float(mix["kv_budget_mib"]) * 2**20)
    total = sum(len(h) for h in plan.histories) * kv_bytes_per_token
    return int(float(mix["kv_budget_share"]) * total)
