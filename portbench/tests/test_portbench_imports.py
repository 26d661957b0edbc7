"""Nothing a run imports has a forbidden top-level name (``jax``,
``jaxlib``, ``flax``, ``repro``, ``benchmarks``; ``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""
import subprocess
import sys

from portbench_paths import BENCH, REPO

import pb_cell

REF = ("pb_ref_dense", "pb_codec", "pb_judge", "pb_stats", "pb_traffic")


def _modules(code):
    r = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": f"{REPO / 'src'}:{BENCH}", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    return set(r.stdout.split())


def test_the_run_loads_nothing_forbidden():
    mods = _modules("import pb_cell, pb_faults, control, sets\n"
                    "from repro_torch.core.service import LLMService\n"
                    "from repro_torch.core.scheduler import ServiceRouter\n"
                    "from repro_torch.models.registry import build_model")
    assert "repro_torch" in mods
    assert not mods & set(pb_cell.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules("import " + ", ".join(REF))
    assert "repro_torch" not in mods
    assert not mods & set(pb_cell.FORBIDDEN)


def test_forbidden_names_compare_whole():
    assert "repro" in pb_cell.FORBIDDEN
    sys.modules.setdefault("repro_torch_probe_", sys)
    try:
        assert "repro_torch_probe_" not in pb_cell.forbidden_modules()
    finally:
        del sys.modules["repro_torch_probe_"]
