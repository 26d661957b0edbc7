"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` at the repository
root (a directory ``.gitignore`` lists), at first use.  No fallback:
a missing ``nvcc`` or a failed build raises.  ``build_all`` starts one
``nvcc`` per source at once, so the first use of any kernel pays for
the slowest build of them all, not for their sum.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-prec-div=true", "-shared", "-Xcompiler", "-fPIC")

SOURCES = ("chunk_quant", "decode_mqattn", "attn_density", "attn_flash",
           "feed_gate")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels build only where the CUDA toolkit is installed")
    return found


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _start(name: str, nvcc: str) -> subprocess.Popen:
    src, out = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    src, out = _paths(name)
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, out)
    return log


def _stale(name: str) -> bool:
    src, out = _paths(name)
    return not out.exists() or out.stat().st_mtime < src.stat().st_mtime


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every stale kernel source in parallel.  -> name -> the
    compiler's log (``-Xptxas -v``: registers, shared memory, spills)."""
    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    nvcc = nvcc_path()
    procs = {n: _start(n, nvcc) for n in names}
    return {n: _finish(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``; every stale
    source is built first, in parallel."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib
