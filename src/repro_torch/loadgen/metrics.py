"""Event log + metrics/report layer for the scale harness.

``EventLog`` is the determinism probe: every scheduling event the
driver observes (arrive/begin/round/preempt/done/flush) is rendered to
one canonical text line and folded into a running sha256.  Two runs of
the same scenario seed must produce byte-identical logs — the hash
makes that checkable at 10^5-event scale without retaining the lines
(only the first ``keep`` are kept for inspection; the hash covers all).

``build_report`` aggregates one scenario run into the JSON shape the
regression gate consumes: per-priority p50/p95/p99 TTFT and TBT in
VIRTUAL seconds (machine-portable — the simulation clock advances by
the spec's cost model, never by wall time), admission waits, queue
depth, preemption counts, pool fault/reclaim counters, switch-in
totals, and bytes-moved-per-token from the swap tier's byte counters.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional


class EventLog:
    """Append-only scheduling-event log with an incremental sha256.

    Lines are ``kind t field0 field1 ...`` with times rendered via
    ``repr`` (exact — two equal floats always render identically).
    """

    def __init__(self, keep: Optional[int] = 4096):
        self._sha = hashlib.sha256()
        self._keep = keep
        self.lines: List[str] = []
        self.n = 0

    def emit(self, kind: str, t: float, *fields: Any):
        line = " ".join([kind, repr(float(t))] + [str(f) for f in fields])
        self._sha.update(line.encode())
        self._sha.update(b"\n")
        if self._keep is None or self.n < self._keep:
            self.lines.append(line)
        self.n += 1

    def sha256(self) -> str:
        return self._sha.hexdigest()


def _round_floats(obj: Any, ndigits: int = 9) -> Any:
    """Stabilize a report for JSON diffing: cut float noise far below
    metric significance (virtual times are exact; wall times are not)."""
    if isinstance(obj, float):
        return round(obj, ndigits)
    if isinstance(obj, dict):
        return {k: _round_floats(v, ndigits) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_round_floats(v, ndigits) for v in obj]
    return obj


_FAULT_KEYS = (
    "degraded_mode", "degraded_entries", "degraded_exits",
    "chunks_recovered_recompute", "chunks_corrupt_detected",
    "io_errors_detected", "evict_dropped", "recover_failed",
    "io_retries", "io_recovered", "io_failed_jobs",
    "tmp_files_swept", "delete_errors",
    "faults_injected_total", "faults_injected")


def build_report(spec, *, router_stats: Dict[str, Any],
                 svc_stats: Dict[str, Any], log: EventLog,
                 virtual_s: float, wall_s: float,
                 io_read: int, io_written: int,
                 n_streams: int, n_stuck: int, n_errors: int,
                 mem_used: int, n_errors_fg: int = 0,
                 tokens_sha256: Optional[str] = None,
                 tokens_sha_by_app: Optional[Dict[str, str]] = None
                 ) -> Dict[str, Any]:
    """One scenario run -> the report dict written to
    BENCH_scenarios.json.  Everything except ``wall_s`` is
    deterministic in (scenario, seed) and portable across machines."""
    toks = int(router_stats.get("decoded_tokens", 0))
    moved = int(io_read) + int(io_written)
    report: Dict[str, Any] = {
        "scenario": spec.name,
        "seed": spec.seed,
        "spec": spec.to_dict(),
        "n_contexts": spec.n_contexts,
        "n_calls": spec.n_calls,
        "virtual_duration_s": virtual_s,
        "wall_s": wall_s,                      # NOT gated: machine-local
        "event_log_sha256": log.sha256(),
        "events_logged": log.n,
        "streams": {"total": n_streams, "stuck": n_stuck,
                    "errors": n_errors, "errors_fg": n_errors_fg},
        "budget": {"memory_budget": spec.memory_budget,
                   "mem_used": mem_used,
                   "ok": mem_used <= spec.memory_budget},
        "io": {"disk_bytes_read": int(io_read),
               "disk_bytes_written": int(io_written),
               "bytes_moved_per_token": moved / max(1, toks)},
        "router": router_stats,
        "service": {k: svc_stats.get(k) for k in (
            "total_calls", "switch_mean_s", "switch_p99_s",
            "switch_total_s", "mem_used", "disk_bytes",
            "decode_ready_contexts", "quant_resident_chunks",
            "paged_pool") if k in svc_stats},
        "pool": {k: svc_stats[k] for k in (
            "pool_pages16_total", "pool_pages16_used",
            "pool_pages8_total", "pool_pages8_used",
            "pool_page_faults", "pool_pt_switch_ins",
            "pool_admit_switch_ins", "pool_reclaims",
            "pool_admit_fault_retries")
            if k in svc_stats},
        "faults": {k: svc_stats[k] for k in _FAULT_KEYS
                   if k in svc_stats},
    }
    report["faults"]["watchdog_preempts"] = int(
        router_stats.get("watchdog_preempts", 0))
    report["faults"]["bg_shed"] = int(router_stats.get("bg_shed", 0))
    if tokens_sha256 is not None:
        # every decoded token, streams in admission order: the recovery
        # token-identity probe (DESIGN.md §6) — identical across
        # same-seed runs, and for 16-bit policies identical to the
        # fault-free run of the same workload
        report["tokens_sha256"] = tokens_sha256
    if tokens_sha_by_app is not None:
        # per-app split of the probe: with contexts bound to apps (zoo
        # scenarios) each app's hash must match its family served solo
        report["tokens_sha_by_app"] = dict(tokens_sha_by_app)
    return _round_floats(report)


def gate_metrics(report: Dict[str, Any]) -> Dict[str, Any]:
    """The machine-portable subset ``check_regression --kind scenario``
    compares (virtual-time QoS + throughput shape + movement cost)."""
    r = report["router"]
    out: Dict[str, Any] = {
        "scenario": report["scenario"],
        "seed": report["seed"],
        "event_log_sha256": report["event_log_sha256"],
        "virtual_duration_s": report["virtual_duration_s"],
        "tokens_per_round": r.get("tokens_per_round", 0.0),
        "preemptions": r.get("preemptions", 0),
        "bytes_moved_per_token": report["io"]["bytes_moved_per_token"],
        "stuck_streams": report["streams"]["stuck"],
        "errors": report["streams"].get("errors", 0),
        "errors_fg": report["streams"].get("errors_fg", 0),
        "budget_ok": report["budget"]["ok"],
    }
    if "tokens_sha256" in report:
        out["tokens_sha256"] = report["tokens_sha256"]
    if "tokens_sha_by_app" in report:
        out["tokens_sha_by_app"] = report["tokens_sha_by_app"]
    fl = report.get("faults") or {}
    if fl.get("faults_injected_total") or fl.get("degraded_entries"):
        for k in ("faults_injected_total", "chunks_recovered_recompute",
                  "chunks_corrupt_detected", "recover_failed",
                  "degraded_entries", "degraded_exits", "degraded_mode",
                  "io_failed_jobs", "evict_dropped", "watchdog_preempts",
                  "bg_shed"):
            out[k] = fl.get(k, 0)
    fg = r.get("foreground")
    if fg:
        for k in ("ttft_p50_s", "ttft_p95_s", "ttft_p99_s",
                  "tbt_p50_s", "tbt_p99_s", "wait_p95_s"):
            if k in fg:
                out[f"fg_{k}"] = fg[k]
    bg = r.get("background")
    if bg:
        for k in ("wait_p50_s", "wait_p95_s", "wait_p99_s"):
            if k in bg:
                out[f"bg_{k}"] = bg[k]
    return out


def deterministic_view(report: Dict[str, Any]) -> Dict[str, Any]:
    """The subset of a report that must be IDENTICAL across same-seed
    runs.  ``wall_s`` is machine time; the ``service`` section carries
    wall-clock switch timings and the disk store's residual byte count
    (async swap-out completion order is thread-scheduling dependent).
    Everything else — event log hash, virtual-time QoS, queue depth,
    pool counters, io deltas — is a pure function of the seed."""
    return {k: v for k, v in report.items()
            if k not in ("wall_s", "service")}


def write_bench(path: str, doc: Dict[str, Any]):
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
