#!/usr/bin/env python3
"""Before / after of the paged pool's CUDA graphs on one card: another
tree of the repository (the parent revision) against this one.

    mkdir -p build/ab_parent
    git archive <rev> | tar -x -C build/ab_parent
    python3 tools/graphs_ab.py build/ab_parent

Builds both trees' kernels at once, then runs ``--measure`` of each tree
in its own process, in turns (other, this, this, other).  A measure
imports that tree's ``chip_smoke.py`` and ``src/repro_torch``, draws
llama2-7b at full width from ``chip_smoke.SEED`` and runs that tree's
own serve phase (bf16 pool and ``quant_resident``: 12 calls, one decode
round and one extend under the profiler) and router phase (the same two,
``decode_batch`` 4, one round of >= 2 rows profiled), and records: each
call's wall (host clock around ``LLMService.callLLM`` up to a
``torch.cuda.synchronize()``; the router's ``service_s``), the profiled
round's and extend's wall, busy and idle share, the router's foreground
and background TTFT and queue wait, each phase's peak memory allocated
and reserved (``torch.cuda.max_memory_allocated`` /
``max_memory_reserved`` after an ``empty_cache`` and a reset; read
where this tree's ``graph_check`` starts, whose arena copies are no part
of serving), the kernel launch counts, the graphs' stats, and the
card's ``nvidia-smi`` name and power limit.  Prints one JSON object: the runs
in order, each tree's medians over its two runs.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def measure(root: str) -> dict:
    """The serve and router phases of the tree at ``root``, as its own
    ``chip_smoke.py`` runs them."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.core.service import LLMService
    if not torch.cuda.is_available():
        raise SystemExit("graphs_ab: no CUDA device")
    walls = []
    call = LLMService.callLLM

    def timed(self, *a, **k):
        t0 = smoke.time.perf_counter()
        out = call(self, *a, **k)
        torch.cuda.synchronize()
        walls.append((smoke.time.perf_counter() - t0) * 1e3)
        return out

    LLMService.callLLM = timed
    # a phase's peak memory is read where this tree's graph_check starts
    # (its arena copies are no part of serving), at its end otherwise
    peaks = {}
    check = getattr(smoke, "graph_check", None)
    if check is not None:
        def graph_check(*args):
            peaks.update(_peaks(torch))
            return check(*args)
        smoke.graph_check = graph_check
    model, params = smoke.build_weights(get_config("llama2-7b"), smoke.SEED)
    out = {"root": root, "card": smoke.nvidia_smi_line()}
    with tempfile.TemporaryDirectory(prefix="graphs_ab_") as tmp:
        for label, quant in (("bf16", False), ("quant", True)):
            walls.clear()
            peaks.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = smoke.serve_phase(model, params, smoke.SEED, tmp, label,
                                    quant_resident=quant)
            out[f"serve_{label}"] = {
                "call_ms": list(walls), "call_ms_median": _median(walls),
                "round_profile": run["round_profile"],
                "extend_profile": run["extend_profile"],
                "peak_bytes": dict(peaks) or _peaks(torch),
                "launches": run["launches"], "graphs": run.get("graphs")}
        for label, quant in (("bf16", False), ("quant", True)):
            peaks.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
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


def _peaks(torch) -> dict:
    return {"allocated": torch.cuda.max_memory_allocated(),
            "reserved": torch.cuda.max_memory_reserved()}


def summarize(runs) -> dict:
    """Each tree's figures over its runs: the median per-call wall of
    all its calls, and per run the profiled round's wall, busy and idle
    share, the router's TTFT mean by priority and the peak memory."""
    keys = [k for k in runs[0] if k.startswith(("serve_", "router_"))]
    out = {}
    for name in dict.fromkeys(r["tree"] for r in runs):
        mine = [r for r in runs if r["tree"] == name]
        out[name] = {}
        for k in keys:
            rounds = [r[k]["round_profile"] or {} for r in mine]
            prios = mine[0][k].get("by_priority", {})
            out[name][k] = {
                "call_ms_median": _median([x for r in mine
                                           for x in r[k]["call_ms"]]),
                "round_wall_ms": [p.get("wall_ms") for p in rounds],
                "round_busy_ms": [p.get("device_ms") for p in rounds],
                "round_idle_share": [p.get("idle_share") for p in rounds],
                "ttft_mean_s": {p: [r[k]["by_priority"][p]["ttft_mean_s"]
                                    for r in mine] for p in prios},
                "peak_bytes": [r[k]["peak_bytes"] for r in mine]}
    return out


def _build(root: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import build; "
         "build.build_all()"],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")))


def main(other: str) -> int:
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
             trees[name]], capture_output=True, text=True)
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
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        sys.exit(0)
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
