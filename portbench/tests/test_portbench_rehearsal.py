"""Every cell, rehearsed on the CPU at a tiny size through the harness:
its result line holds every metric listed for it, with and without the
trace, the comparison passes, and nothing forbidden was loaded."""
import json

import pytest

from portbench_paths import REPO, rehearse, workloads

import portbench_rehearse


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_rehearse.checkout(tmp_path_factory.mktemp("checkout"))


def _listed(workload, trace):
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e = [m for m in b["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not trace:
        return {m["name"] for m in e2e}
    names = {m["name"] for m in e2e}
    return {m["name"] for m in b["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", workloads())
def test_rehearsal_prints_every_listed_metric(root, workload, trace):
    rc, res, err = rehearse(root, workload, "--trace", str(trace),
                            "--seed", str(2**31 + 11), "--seconds", "4")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert set(res["metrics"]) == _listed(workload, trace)
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert res["breakdown"]["device_ops"]


def _run_py(cwd, *args):
    import subprocess
    import sys
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workloads()[0],
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0",
         *args], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(cwd), "TMPDIR": str(cwd),
             "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_run_refuses_and_prints_no_result():
    r = _run_py(REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_without_the_program_the_run_refuses(tmp_path):
    import shutil
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    r = _run_py(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
