"""The control, the plain reference computed in fp8 in the program's
place, reads well apart from the program on the numbers that separate
them, and the harness's own comparison (``pb_judge.verdict`` against
the cell's limits file) judges the program correct and the control
not, at a tiny size on the CPU (on the card at full size:
``portbench/control.py``)."""
import json
import subprocess
import sys

import pytest

from portbench_paths import BENCH, REPO, workloads

import portbench_rehearse

SCRIPT = """
import json, sys
sys.path[:0] = [{src!r}, {bench!r}]
import torch
torch.set_num_threads(1)
import control
print(json.dumps(control.readings({wl!r}, 5, 2.0, device="cpu",
                                  root={root!r})))
"""


@pytest.mark.parametrize("workload", workloads())
def test_control_reads_apart_from_the_program(tmp_path, workload):
    root = portbench_rehearse.checkout(tmp_path)
    code = SCRIPT.format(src=str(REPO / "src"),
                         bench=str(root / "portbench"), wl=workload,
                         root=str(root))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                            "TMPDIR": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    prog, ctl = out["program"], out["control_fp8"]
    assert ctl["max_gap_sigma"] > 3 * prog["max_gap_sigma"]
    assert ctl["code_dev"] > 5 * prog["code_dev"]
    assert ctl["scale_dev"] > 5 * prog["scale_dev"]
    assert prog["plan_mismatch"] == 0.0
    assert out["verdict"] == {"program": True, "control_fp8": False}
    assert (BENCH / "control.py").exists()
