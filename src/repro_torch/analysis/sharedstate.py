"""Thread-shared-state audit (rule ``shared/unguarded-shared-write``).

An attribute is FLAGGED when all of:
  1. it is written without any lock held,
  2. the write happens in (or the attribute is also touched from) a
     function reachable from a worker-thread entry point
     (``config.WORKER_ENTRIES`` + functions the lock scan saw handed
     to ``submit``/``add_done_callback``/``Thread(target=)``), AND the
     attribute is also accessed from the router/scheduler side
     (``config.READER_ENTRY_PREFIXES`` / ``READER_ENTRIES``) — i.e.
     the access genuinely crosses threads,
  3. it is not in ``config.SHARED_STATE_ALLOWLIST`` (every allowlist
     entry carries a one-line justification).

Reachability is a BFS over the name-resolved call graph the lock scan
recorded.  ``__init__`` writes are construction, not sharing, and are
excluded at collection time.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

from repro_torch.analysis import config
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lockcheck import ScanData


def _reach(roots: Set[str], edges: Dict[str, Set[str]]) -> Set[str]:
    seen = set(roots)
    frontier = list(roots)
    while frontier:
        cur = frontier.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                frontier.append(nxt)
    return seen


def run(data: ScanData) -> List[Finding]:
    worker_roots: Set[str] = set()
    reader_roots: Set[str] = set()
    for node_id, fn in data.by_ident.items():
        ident = fn.ident
        if fn.worker or ident in config.WORKER_ENTRIES:
            worker_roots.add(node_id)
        if ident in config.READER_ENTRIES or any(
                ident.startswith(p)
                for p in config.READER_ENTRY_PREFIXES):
            reader_roots.add(node_id)

    wreach = _reach(worker_roots, data.edges)
    rreach = _reach(reader_roots, data.edges)

    def accessed(side: Set[str]) -> Set[Tuple[str, str]]:
        keys: Set[Tuple[str, str]] = set()
        for site in data.writes:
            if _node_id(site) in side:
                keys.add(site.key)
        for node_id in side:
            keys.update(data.reads.get(node_id, ()))
        return keys

    worker_keys = accessed(wreach)
    reader_keys = accessed(rreach)

    findings: List[Finding] = []
    emitted: Set[Tuple[str, str, str]] = set()
    for site in data.writes:
        if site.guarded:
            continue
        if site.key in config.SHARED_STATE_ALLOWLIST:
            continue
        nid = _node_id(site)
        crosses = (nid in wreach and site.key in reader_keys) or \
                  (nid in rreach and site.key in worker_keys)
        if not crosses:
            continue
        dedup = (site.fn.module.relpath, site.fn.qualname,
                 f"{site.key[0]}.{site.key[1]}")
        if dedup in emitted:
            continue
        emitted.add(dedup)
        side = "worker thread" if nid in wreach else "router/scheduler"
        findings.append(Finding(
            checker="shared", rule="unguarded-shared-write",
            file=site.fn.module.relpath, line=site.line,
            scope=site.fn.qualname,
            message=f"unguarded write to {site.key[0]}.{site.key[1]} "
                    f"on the {side} side while the other side also "
                    f"touches it; guard it or allowlist with a "
                    f"justification"))
    return findings


def _node_id(site) -> str:
    return f"{site.fn.qualname}@{site.fn.module.modname}"
