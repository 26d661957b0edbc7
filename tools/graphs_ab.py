#!/usr/bin/env python3
"""Before / after of the executor's CUDA graphs on one card: another
tree of the repository (the parent revision) against this one.

    mkdir -p build/ab_parent
    git archive <rev> | tar -x -C build/ab_parent
    python3 tools/graphs_ab.py build/ab_parent [--phases slot,mla,...]

Builds both trees' kernels at once, then runs ``--measure`` of each tree
in its own process, in turns (other, this, this, other).  A measure
imports that tree's ``chip_smoke.py`` and ``src/repro_torch``, draws each
phase's model at full width from ``chip_smoke.SEED`` and runs that
tree's own phase functions.  Phases (default: the slot engines'):

* ``slot``  — llama2-7b on the slot engine (``slot_phase``): ``llms``
  under the card's restore profile, ``llms`` with every restore split
  forced (the heaviest half recomputed: the Fig.-8 pipelined restore
  surely runs), and ``quant_resident`` forced likewise;
* ``pipelined`` — llama2-7b's full-width restore of ``pipelined_check``
  (chunks read and recomputed at once, window and mixed cache): its
  wall, the wait for the feed (the host's in ``LayerFeed.fetch`` where
  the tree loops eagerly, the gates' on the device where it replays a
  graph), each side alone and one restore under the profiler;
* ``mla``   — deepseek-v2-lite-16b (``family_phase``): ``llms``, ``lmk``;
* ``rwkv``  — rwkv6-1.6b (``rwkv_phase``): ``llms``;
* ``zoo``   — ``mixed_zoo`` (``zoo_phase``): the mixed run;
* ``moe``   — llama4-maverick at depth 2 (``family_phase``): ``llms``;
* ``serve`` / ``router`` — the paged pool's phases (llama2-7b, bf16 and
  quant-resident).

Every slot-engine run records each call's wall (the phase's records),
each pipelined restore's wall and wait for the feed, the restore splits
and ``switch_s`` over disk restores,
each ``ModelExecutor.decode`` and ``extend`` call's host wall (both
trees return host arrays, so the call ends with the card's work), one
decode token under the profiler (the 40th of the run: wall, busy and
idle share, kernels; ``chip_smoke._profile_round``), the peak memory
allocated and reserved (``torch.cuda.max_memory_*`` after an
``empty_cache`` and a reset, read where this tree's ``graph_check``
starts, whose buffer copies are no part of serving), the kernel launch
counts and this tree's graph stats.  Prints one JSON object: the runs in
order, and each tree's medians over its two runs.  The card's
``nvidia-smi`` name and power limit come with every run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOT_PHASES = ("slot", "pipelined", "mla", "rwkv", "zoo", "moe")
PROFILED_TOKEN = 40                 # the decode call profiled in a run


def _median(xs):
    xs = sorted(x for x in xs if x is not None)
    return xs[len(xs) // 2] if xs else None


def _peaks(torch) -> dict:
    return {"allocated": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.max_memory_reserved()}


class _Calls:
    """Class-level wrappers on the tree's ``ModelExecutor.decode`` and
    ``extend``: each call's host wall, and one decode token profiled."""

    def __init__(self, smoke, exe_cls):
        self.smoke, self.cls = smoke, exe_cls
        self.decode, self.extend = exe_cls.decode, exe_cls.extend
        self.reset()
        calls = self

        def decode(exe, *a, **k):
            calls.n_decode += 1
            if calls.n_decode == PROFILED_TOKEN:
                out, calls.token = smoke._profile_round(
                    lambda: calls.decode(exe, *a, **k), top=8)
                return out
            t0 = smoke.time.perf_counter()
            out = calls.decode(exe, *a, **k)
            calls.decode_ms.append((smoke.time.perf_counter() - t0) * 1e3)
            return out

        def extend(exe, *a, **k):
            t0 = smoke.time.perf_counter()
            out = calls.extend(exe, *a, **k)
            calls.extend_ms.append((smoke.time.perf_counter() - t0) * 1e3)
            return out

        exe_cls.decode, exe_cls.extend = decode, extend

    def reset(self):
        self.n_decode, self.token = 0, None
        self.decode_ms, self.extend_ms = [], []

    def take(self) -> dict:
        out = {"decode_ms": list(self.decode_ms),
               "decode_ms_median": _median(self.decode_ms),
               "extend_ms_median": _median(self.extend_ms),
               "n_extend": len(self.extend_ms), "token": self.token}
        self.reset()
        return out


def _walls(run) -> list:
    """A slot-engine run's per-call walls in ms."""
    recs = run.get("records") or []
    if recs and "wall_s" in recs[0]:
        return [r["wall_s"] * 1e3 for r in recs]
    return list(run.get("wall_ms") or [])


def measure(root: str, phases) -> dict:
    """The asked phases of the tree at ``root``, as its own
    ``chip_smoke.py`` runs them."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import gc
    import torch
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.core.executor import ModelExecutor
    from repro_torch.core.service import LLMService
    if not torch.cuda.is_available():
        raise SystemExit("graphs_ab: no CUDA device")
    out = {"root": root, "card": smoke.nvidia_smi_line()}
    # a phase's peak memory is read where this tree's graph_check starts
    # (its buffer copies are no part of serving), at its end otherwise
    peaks = {}
    check = getattr(smoke, "graph_check", None)
    if check is not None:
        def graph_check(*args):
            peaks.update(_peaks(torch))
            return check(*args)
        smoke.graph_check = graph_check
    calls = _Calls(smoke, ModelExecutor)

    def start():
        peaks.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls.reset()

    def slot_record(run):
        walls = _walls(run)
        return dict(calls.take(), call_ms=walls, call_ms_median=_median(walls),
                    run_s=run.get("run_s"), launches=run.get("launches"),
                    peak_bytes=dict(peaks) or _peaks(torch),
                    graphs=run.get("graphs"),
                    pipelined=run.get("pipelined"),
                    splits=[[len(a), len(b)] for a, b in
                            run.get("splits") or []],
                    switch_ms=run.get("disk_switch_ms"))

    def weights(arch, **over):
        cfg = get_config(arch)
        return smoke.build_weights(cfg.with_overrides(**over) if over
                                   else cfg, smoke.SEED)

    with tempfile.TemporaryDirectory(prefix="graphs_ab_") as tmp:
        if "serve" in phases or "router" in phases:
            out.update(_paged(smoke, torch, LLMService, weights, tmp, phases,
                              peaks, start))
        if "slot" in phases:
            model, params = weights("llama2-7b")
            for label, kw in (("ab-llms", {}),
                              ("ab-llms-forced", dict(split="forced")),
                              ("ab-quant", dict(quant_resident=True,
                                                split="forced"))):
                start()
                run = smoke.slot_phase(model, params, smoke.SEED, tmp, label,
                                       **kw)
                out[f"slot_{label}"] = slot_record(run)
            del model, params
        if "pipelined" in phases:
            model, params = weights("llama2-7b")
            for label, quant in (("bf16", False), ("mixed", True)):
                start()
                run = smoke.pipelined_check(model, params, tmp,
                                            quant_resident=quant)
                wait = run.get("feed_wait_s", run.get("fetch_wait_s"))
                out[f"pipelined_{label}"] = {
                    "pipelined": [{"wall_s": run["wall_s"],
                                   "wait_s": wait}],
                    "restore_s": run.get("restore_s"),
                    **{k: run.get(k) for k in (
                        "feed_alone_s", "inserts_s", "recompute_alone_s",
                        "sync_warnings", "profile", "graph")},
                    "peak_bytes": dict(peaks) or _peaks(torch)}
            del model, params
        if "mla" in phases or "zoo" in phases:
            mla_w = weights(smoke.MLA["arch"])
        if "mla" in phases:
            for policy in ("llms", "lmk"):
                start()
                run = smoke.family_phase(*mla_w, smoke.SEED, tmp,
                                         f"ab-{policy}", smoke.MLA,
                                         policy=policy)
                out[f"mla_{policy}"] = dict(
                    slot_record(run), switch_ms=run.get("disk_switch_ms"))
        if "rwkv" in phases or "zoo" in phases:
            rwkv_w = weights(smoke.RWKV["arch"])
        if "rwkv" in phases:
            start()
            run = smoke.rwkv_phase(*rwkv_w, smoke.SEED, tmp, "ab-llms")
            out["rwkv_llms"] = slot_record(run)
        if "zoo" in phases:
            from repro_torch.loadgen import (bind_apps_by_ctx, get_scenario,
                                             make_events)
            members = {"dense": weights("llama2-7b"), "mla_moe": mla_w,
                       "rwkv6": rwkv_w}
            spec = get_scenario("mixed_zoo").override(
                memory_budget=int(smoke.ZOO["budget_mib"] * 2**20))
            vocab = min(m.cfg.vocab for m, _ in members.values())
            events = bind_apps_by_ctx(make_events(spec, vocab), spec)
            start()
            run = smoke.zoo_phase(spec, members, events, vocab, "ab-mixed")
            out["zoo_mixed"] = dict(
                calls.take(), run_s=run["run_s"],
                per_family=run["per_family"], launches=run["launches"],
                peak_bytes=dict(peaks) or _peaks(torch),
                graphs=run.get("graphs"))
            del members
        mla_w = rwkv_w = None
        if "moe" in phases:
            gc.collect()
            torch.cuda.empty_cache()
            model, params = weights(smoke.MOE["arch"],
                                    n_layers=smoke.MOE["n_layers"])
            start()
            run = smoke.family_phase(model, params, smoke.SEED, tmp,
                                     "ab-llms", smoke.MOE)
            out["moe_llms"] = slot_record(run)
            del model, params
    return out


def _paged(smoke, torch, LLMService, weights, tmp, phases, peaks, start):
    """The paged pool's serve and router phases (llama2-7b, bf16 and
    quant-resident): each call's wall, the profiled round and extend."""
    walls = []
    call = LLMService.callLLM

    def timed(self, *a, **k):
        t0 = smoke.time.perf_counter()
        res = call(self, *a, **k)
        torch.cuda.synchronize()
        walls.append((smoke.time.perf_counter() - t0) * 1e3)
        return res

    LLMService.callLLM = timed
    model, params = weights("llama2-7b")
    out = {}
    for label, quant in (("bf16", False), ("quant", True)):
        if "serve" not in phases:
            break
        walls.clear()
        start()
        run = smoke.serve_phase(model, params, smoke.SEED, tmp, label,
                                quant_resident=quant)
        out[f"serve_{label}"] = {
            "call_ms": list(walls), "call_ms_median": _median(walls),
            "round_profile": run["round_profile"],
            "extend_profile": run["extend_profile"],
            "peak_bytes": dict(peaks) or _peaks(torch),
            "launches": run["launches"], "graphs": run.get("graphs")}
    LLMService.callLLM = call
    for label, quant in (("bf16", False), ("quant", True)):
        if "router" not in phases:
            break
        start()
        run = smoke.router_phase(model, params, smoke.SEED, tmp, label,
                                 smoke.ROUTER["calls"],
                                 quant_resident=quant, profiled=True)
        service = [c["service_s"] * 1e3 for c in run["calls"]]
        r = run["router"]
        out[f"router_{label}"] = {
            "call_ms": service, "call_ms_median": _median(service),
            "run_s": run["run_s"],
            "by_priority": {p: {k: r[p].get(k) for k in (
                "calls", "wait_mean_s", "wait_p95_s", "ttft_mean_s",
                "ttft_p95_s")} for p in ("foreground", "background")
                if p in r},
            "round_profile": run["profile"],
            "peak_bytes": dict(peaks) or _peaks(torch),
            "launches": run["launches"], "graphs": run.get("graphs")}
    return out


def summarize(runs) -> dict:
    """Each tree's figures over its runs: the median per-call wall of all
    its calls, the median decode token and extend wall, and per run the
    profiled token's wall, busy and idle share and the peak memory."""
    keys = [k for k in runs[0] if k not in ("root", "card", "tree")]
    out = {}
    for name in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == name]
        out[name] = {}
        for k in keys:
            tok = [r[k].get("token") or r[k].get("round_profile") or {}
                   for r in mine]
            pipes = [p for r in mine for p in r[k].get("pipelined") or []]
            out[name][k] = {
                "pipelined_wall_ms_median": _median(
                    [p["wall_s"] * 1e3 for p in pipes]),
                "pipelined_wait_ms_median": _median(
                    [p.get("feed_wait_s", p.get("fetch_wait_s",
                                                p.get("wait_s"))) * 1e3
                     for p in pipes]),
                "pipelined_restores": [len(r[k].get("pipelined") or [])
                                       for r in mine],
                "call_ms_median": _median([x for r in mine
                                           for x in r[k].get("call_ms", [])]),
                "decode_ms_median": _median([x for r in mine for x in
                                             r[k].get("decode_ms", [])]),
                "extend_ms_median": [r[k].get("extend_ms_median")
                                     for r in mine],
                "run_s": [r[k].get("run_s") for r in mine],
                "token_wall_ms": [t.get("wall_ms") for t in tok],
                "token_busy_ms": [t.get("device_ms") for t in tok],
                "token_idle_share": [t.get("idle_share") for t in tok],
                "token_kernels": [t.get("kernels") for t in tok],
                "peak_bytes": [r[k].get("peak_bytes") for r in mine]}
    return out


def _build(root: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.build_all()"],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))


def main(other: str, phases) -> int:
    other = os.path.abspath(other)
    trees = {"other": other, "this": ROOT}
    builds = [_build(r) for r in trees.values()]
    if any(p.wait() != 0 for p in builds):
        print("graphs_ab: a kernel build failed", file=sys.stderr)
        return 1
    runs = []
    for name in ("other", "this", "this", "other"):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             trees[name], ",".join(phases)], capture_output=True, text=True)
        sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
        if res.returncode != 0:
            print(f"graphs_ab: the {name} tree's measure failed",
                  file=sys.stderr)
            return 1
        runs.append(dict(json.loads(res.stdout.strip().splitlines()[-1]),
                         tree=name))
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    print(json.dumps({"runs": runs, "summary": summarize(runs)}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--measure":
        print(json.dumps(measure(os.path.abspath(args[1]),
                                 args[2].split(","))), flush=True)
        sys.exit(0)
    phases = list(SLOT_PHASES)
    if len(args) == 3 and args[1] == "--phases":
        phases = args[2].split(",")
    elif len(args) != 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(args[0], phases))
