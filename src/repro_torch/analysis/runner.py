"""Build a Program from the tree and run all four checkers.

Deliberately imports NOTHING outside the stdlib + this package: it runs on a
bare Python with no torch, numpy or jax installed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import familycheck, jitcheck, lockcheck, sharedstate
from repro_torch.analysis.astpass import Program
from repro_torch.analysis.findings import Finding

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_SCAN = REPO_ROOT / "src" / "repro_torch"
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"
# the analyzer's own package is config/infrastructure, and fixtures/
# holds KNOWN-BAD reproductions exercised only by --selftest and tests
_EXCLUDE_PARTS = ("analysis",)


def iter_sources(root: Path) -> Iterable[Path]:
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root)
        if rel.parts and rel.parts[0] in _EXCLUDE_PARTS:
            continue
        yield path


def build_program(paths: Optional[List[Path]] = None) -> Program:
    program = Program()
    files = list(paths) if paths else list(iter_sources(DEFAULT_SCAN))
    for path in files:
        try:
            rel = path.resolve().relative_to(REPO_ROOT)
        except ValueError:
            rel = path
        modname = ".".join(rel.with_suffix("").parts)
        if modname.startswith("src."):
            modname = modname[len("src."):]
        program.add_source(path.read_text(), rel.as_posix(), modname)
    return program


def run_checks(program: Program) -> List[Finding]:
    lock_findings, scan = lockcheck.run(program)
    findings = list(lock_findings)
    findings.extend(sharedstate.run(scan))
    findings.extend(jitcheck.run(program))
    findings.extend(familycheck.run(program))
    findings.sort(key=lambda f: f.sort_key())
    return findings


def analyze_source(source: str, relpath: str = "<memory>.py",
                   modname: str = "fixture") -> List[Finding]:
    """Single-module entry point for tests and --selftest."""
    program = Program()
    program.add_source(source, relpath, modname)
    return run_checks(program)


def analyze_paths(paths: List[Path]) -> List[Finding]:
    return run_checks(build_program(paths))


def run_default() -> Tuple[List[Finding], List[Finding]]:
    """Full-tree run diffed against the committed baseline:
    -> (new, grandfathered)."""
    findings = run_checks(build_program())
    baselined = baseline_mod.load(DEFAULT_BASELINE)
    return baseline_mod.diff(findings, baselined)
