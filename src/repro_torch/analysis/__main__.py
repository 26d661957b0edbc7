"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exit status: 0 = no unbaselined findings, 1 = new findings (or a
selftest expectation failed), 2 = usage error.  Runs on a bare Python
— no torch, numpy or jax, no third-party imports.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import runner


def _selftest() -> int:
    """Assert the analyzer still catches the shipped bug
    reproductions (the pool self-deadlock, the restore-vs-AoT race,
    and the old executor's family-string dispatch)."""
    fixdir = Path(__file__).resolve().parent / "fixtures"
    expect = {
        "pr3_deadlock.py": ("lock", "blocking-in-worker"),
        "pr6_restore_race.py": ("lock", "unordered-store-read"),
        "family_dispatch.py": ("family", "string-dispatch"),
    }
    failures = []
    for fname, (checker, rule) in sorted(expect.items()):
        path = fixdir / fname
        findings = runner.analyze_source(
            path.read_text(), relpath=f"fixtures/{fname}",
            modname=f"fixture.{fname[:-3]}")
        hits = [f for f in findings
                if f.checker == checker and f.rule == rule]
        if hits:
            print(f"selftest: {fname}: OK "
                  f"({checker}/{rule} x{len(hits)})")
        else:
            failures.append(fname)
            print(f"selftest: {fname}: MISSED expected "
                  f"{checker}/{rule}; got:")
            for f in findings:
                print(f"  {f.render()}")
    if failures:
        print(f"selftest FAILED: {', '.join(failures)}")
        return 1
    print("selftest passed: all regression fixtures flagged")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Concurrency & jit discipline static analyzer "
                    "of the PyTorch/CUDA port (stdlib-only).")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files to scan (default: src/repro_torch, minus "
                         "the analyzer itself)")
    ap.add_argument("--baseline", type=Path,
                    default=runner.DEFAULT_BASELINE,
                    help="baseline file (default: "
                         "repro_torch/analysis/baseline.json)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="re-grandfather: write ALL current findings "
                         "to the baseline and exit 0")
    ap.add_argument("--json", type=Path, metavar="OUT",
                    help="also dump findings as JSON")
    ap.add_argument("--selftest", action="store_true",
                    help="check the known-bad fixtures are flagged")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print grandfathered findings")
    args = ap.parse_args(argv)

    if args.selftest:
        return _selftest()

    if args.paths:
        findings = runner.analyze_paths(args.paths)
        baselined = baseline_mod.load(args.baseline)
        new, old = baseline_mod.diff(findings, baselined)
    else:
        findings = runner.run_checks(runner.build_program())
        baselined = baseline_mod.load(args.baseline)
        new, old = baseline_mod.diff(findings, baselined)

    if args.write_baseline:
        baseline_mod.write(args.baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    if args.json:
        payload = {"new": [f.to_dict() for f in new],
                   "grandfathered": [f.to_dict() for f in old]}
        args.json.write_text(json.dumps(payload, indent=2) + "\n")

    if args.verbose and old:
        print(f"-- {len(old)} grandfathered finding(s):")
        for f in old:
            print(f"   {f.render()}")
    if new:
        print(f"{len(new)} NEW finding(s) not in baseline:")
        for f in new:
            print(f"  {f.render()}")
        print("fix them, allowlist with a justification "
              "(repro_torch/analysis/config.py), or re-baseline with "
              "--write-baseline")
        return 1
    suffix = f" ({len(old)} grandfathered)" if old else ""
    print(f"analysis clean: 0 new findings{suffix}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
