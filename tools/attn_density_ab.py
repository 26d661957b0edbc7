#!/usr/bin/env python3
"""A/B of the ``attn_density`` CUDA kernel: another revision's source
against this tree's, on one card.

    mkdir -p build/ab
    git show <rev>:src/repro_torch/csrc/attn_density.cu > build/ab/attn_density.cu
    python3 tools/attn_density_ab.py build/ab/attn_density.cu

Builds both sources with the port's nvcc flags (the other one from a
file of the same name, so that both get the same mangled names), then

1. compares the SASS of every kernel instantiation the two share
   (``cuobjdump -sass``, addresses left out): identical SASS is the
   same machine code;
2. times the shapes of ``PERF.md`` §6 rows 3-4 that both take, with
   and without the density, in turns (other, this, this, other, ...),
   device time a call from the profiler (``chip_smoke._device_ms``),
   and checks that the two give the same bits.  Every case calls this
   source's kernel directly (``attn_density._tiles``), also where the
   wrapper would route the call to ``csrc/attn_flash.cu`` (the flash
   form at head dims 64 and 128).  A source whose C entry takes
   ``seq_len_dev`` (``seq_len`` as a device int32) gets it in the
   served form, as serving's extend passes it; the flash form and a
   source without it take ``seq_len`` by value.

Prints one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def _build(src: str, out: str) -> None:
    from repro_torch.kernels import build
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out,
                          src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")


def _sass(lib: str):
    """{kernel and template arguments: its SASS lines, addresses out}."""
    from repro_torch.kernels import build
    cuobj = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    txt = subprocess.run([cuobj, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.search(r"attn_density_\w+?_kernel(I\w+?E(?=E))?",
                            m.group(1)).group(0)
            funcs[cur] = []
        elif cur is not None and line.strip():
            funcs[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip())
    return funcs


class _Older:
    """A library built from a source whose C entry lacks pointers the
    wrapper passes: ``stats`` (before the row stats; after ``density``)
    and ``seq_len_dev`` (before ``seq_len`` on the device; after
    ``stats``).  Takes the wrapper's call without them; refuses one that
    needs them."""

    def __init__(self, lib: ctypes.CDLL, stats: bool, seq_len_dev: bool):
        self._lib = lib
        self._drop = [i for i, has in ((7, stats), (8, seq_len_dev))
                      if not has]
        self.attn_density_rows = lib.attn_density_rows

    def attn_density(self, *args):
        if any(args[i] is not None for i in self._drop):
            raise ValueError("this source's kernel takes no such pointer")
        return self._lib.attn_density(
            *(a for i, a in enumerate(args) if i not in self._drop))


def _load(path: str, src: str):
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    with open(src) as f:
        text = f.read()
    stats, seq_dev = "void* stats" in text, "seq_len_dev" in text
    lib.attn_density.argtypes = ([vp] * (7 + stats + seq_dev) + [ci] * 10
                                 + [ctypes.c_float, ci, vp])
    lib.attn_density.restype = ci
    lib.attn_density_rows.argtypes = [ci] * 4
    lib.attn_density_rows.restype = ci
    return lib if stats and seq_dev else _Older(lib, stats, seq_dev)


def _tile_kernel(kad, args, seq_len, want, form):
    """One call of ``csrc/attn_density.cu`` (the library in
    ``kad._LIB``) over ``args`` = (q, k, v, q_pos), no window.
    -> (out, density | None)."""
    import torch
    q, k, v, qp = args
    B, Sq, H, _ = q.shape
    out = torch.empty((B, Sq, H, v.shape[-1]), dtype=torch.bfloat16,
                      device=q.device)
    dens = (torch.empty((B, k.shape[1]), dtype=torch.float32,
                        device=q.device) if want else None)
    kad._tiles(q, k, v, qp, out, None, dens, seq_len, 0, 0, form)
    return out, dens


def main(other_src: str) -> int:
    import torch
    import chip_smoke as smoke
    from repro_torch.kernels import attn_density as kad
    if not torch.cuda.is_available():
        print("attn_density_ab: no CUDA device", file=sys.stderr)
        return 2
    out_dir = os.path.dirname(os.path.abspath(other_src))
    libs = {"other": os.path.join(out_dir, "lib_other.so"),
            "this": os.path.join(out_dir, "lib_this.so")}
    srcs = {"other": other_src,
            "this": os.path.join(ROOT, "src/repro_torch/csrc/attn_density.cu")}
    for k in libs:
        _build(srcs[k], libs[k])
    s_o, s_t = _sass(libs["other"]), _sass(libs["this"])
    shared = sorted(set(s_o) & set(s_t))
    result = {"card": smoke.nvidia_smi_line(),
              "sass_identical": [f for f in shared if s_o[f] == s_t[f]],
              "sass_differ": [f for f in shared if s_o[f] != s_t[f]],
              "only_this": sorted(set(s_t) - set(s_o)),
              "only_other": sorted(set(s_o) - set(s_t)), "times": {}}
    loaded = {k: _load(p, srcs[k]) for k, p in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    serve = smoke._serve_positions(200)
    cases = {
        "(1,64,32,32,128) over 512": (64, 512, 32, 32, 128, 128, serve,
                                      200, "served"),
        "(1,64,16,16,192/128) over 512": (64, 512, 16, 16, 192, 128, serve,
                                          200, "served"),
        "(1,64,16,16,192/128) over 256": (
            64, 256, 16, 16, 192, 128, smoke._mla_positions(256)[0], 148,
            "served"),
        "(1,512,32,32,128) over 4096": (512, 4096, 32, 32, 128, 128,
                                        list(range(3584, 4096)), 4096,
                                        "served"),
        "(1,2048,32,32,128) causal": (2048, 2048, 32, 32, 128, 128,
                                      list(range(2048)), 2048, "flash"),
        "(1,64,15,5,64) over 512": (64, 512, 15, 5, 64, 64, serve, 200,
                                    "served"),
    }
    for label, (Sq, Sk, H, KV, dqk, dv, pos, seq_len, form) in cases.items():
        args = smoke._ad_case(1, Sq, Sk, H, KV, dqk, pos, g, "cuda", dv=dv)
        seq = {k: (torch.tensor(seq_len, dtype=torch.int32, device="cuda")
                   if form == "served" and isinstance(lib, ctypes.CDLL)
                   else seq_len) for k, lib in loaded.items()}
        for want in (False, True):
            times, outs = {"other": [], "this": []}, {}
            for rnd in range(4):
                for k in (("other", "this") if rnd % 2 == 0
                          else ("this", "other")):
                    kad._LIB = loaded[k]
                    fn = lambda: _tile_kernel(  # noqa: E731
                        kad, args, seq[k], want, form)
                    outs[k] = fn()
                    times[k].append(smoke._device_ms(
                        fn, smoke.AD_KERNELS, iters=50 if Sq <= 64 else 10))
            same = all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(outs["other"], outs["this"]))
            result["times"][f"{label} {form}"
                            f"{' + density' if want else ''}"] = {
                "other_ms": times["other"], "this_ms": times["this"],
                "seq_len_on_device": {k: not isinstance(v, int)
                                      for k, v in seq.items()},
                "bit_identical": same}
    kad._LIB = None
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
