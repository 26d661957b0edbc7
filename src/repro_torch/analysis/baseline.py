"""Baseline load/diff/write: grandfathered findings pass, new ones
fail.  Format (the port's ``analysis/baseline.json``)::

    {"version": 1,
     "findings": [{"checker": ..., "rule": ..., "file": ..., "line":
                   ..., "scope": ..., "message": ..., "fingerprint":
                   ...}, ...]}

Only the fingerprint participates in the diff (line numbers are
excluded from it, so code motion doesn't churn the file); the rest is
kept for human readers.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Set, Tuple

from repro_torch.analysis.findings import Finding


def load(path: Path) -> Set[str]:
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {f["fingerprint"] for f in data.get("findings", [])}


def write(path: Path, findings: Iterable[Finding]):
    items = sorted(findings, key=lambda f: f.sort_key())
    payload = {"version": 1,
               "findings": [f.to_dict() for f in items]}
    path.write_text(json.dumps(payload, indent=2) + "\n")


def diff(findings: Iterable[Finding],
         baselined: Set[str]) -> Tuple[List[Finding], List[Finding]]:
    """-> (new, grandfathered)."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if f.fingerprint in baselined else new).append(f)
    return new, old
