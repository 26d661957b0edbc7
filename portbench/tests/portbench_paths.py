"""Where the benchmark's modules are, for its tests: they import them
from ``portbench/`` and run cells in subprocesses of their own."""
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))


def workloads():
    return [w["name"] for w in json.loads(
        (REPO / "BENCHMARK.json").read_text())["workloads"]]


def rehearse(root, workload, *extra, timeout=300):
    """One tiny CPU run of ``workload`` in the checkout ``root``.
    -> (exit code, the result line as a dict or None, stderr)."""
    r = subprocess.run(
        [sys.executable, str(Path(__file__).with_name(
            "portbench_rehearse.py")), "--root", str(root), "--workload",
         workload, *extra], capture_output=True, text=True, timeout=timeout,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "HOME": str(root),
             "TMPDIR": str(root)})
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        res = json.loads(last)
    except ValueError:
        res = None
    return r.returncode, res, r.stderr
