"""CUDA extend attention with the Eq.-1 density: wrapper of
``csrc/attn_density.cu`` and ``csrc/attn_flash.cu``.

Replaces the Pallas TPU kernels ``attn_density`` (passes ``_fwd`` and
``_mass``) of the JAX package's ``kernels/attn_density.py``, and takes
what serving's extend needs beside them: query positions, ``seq_len``,
and the served form of ``models/common.gqa_attention``.  The plain
PyTorch version is ``kernels/ref.py::attn_density_plain``;
``kernels/ops.py`` dispatches between the two by the tensor's device.

``route`` picks the kernel by form and head dims alone:

  * "wgmma" — the flash form at Dqk = Dv = 64 or 128 (the prefill's,
    training's and the dry run's attention): ``csrc/attn_flash.cu``, a
    forward on wgmma fed by a TMA ring and the density as a key-major
    second kernel (``flash_plan``; its two-pass arithmetic is
    ``kernels/ref.py::attn_flash_plain``);
  * "mma" — every served form and the flash form at any other head
    dims: ``csrc/attn_density.cu``, (query, head) rows in blocks of 4
    warps, 16 or 64 rows a block (``plan``), bf16 K/V tiles
    double-buffered through shared memory, QK and PV on ``mma.sync``
    m16n8k16, the key mass summed from the score fragments and reduced
    by a second fixed-order launch.  Queries and keys have head dim
    Dqk <= 256 and values Dv <= 256, padded to the kernel's tile widths
    (``head_plan``): the dense family's Dqk = Dv = hd, MLA's recompute
    128 + 64 and 128, recurrentgemma's local MQA 256 and 256 (V in two
    128-column halves, one block each).

``seq_len`` is a Python int or a 0-d int32 CUDA tensor.  The tile
kernel reads a tensor's value on the device (its launches take the
pointer), so a CUDA graph that captured the call replays with the value
each later call stages there: serving's extend passes it so.  The flash
kernel takes ``seq_len`` by value: a tensor there is read on the host
(``int``), which syncs, and which a graph capture refuses.

The wrapper checks device, dtype, shape, contiguity and (for TMA) the
16-byte alignment of q, k and v, allocates the output, the density and
the kernels' scratch with ``torch.empty``, launches on the current
stream without synchronising, raises if a launch was refused, and adds
one to ``attn_density.launches`` (a plain integer on the wrapper) and,
when it also launched the density pass, to
``attn_density.density_launches``; when it returned the row stats
(``return_stats``: the forward of ``models/common.py flash_attention``),
to ``attn_density.stats_launches``; when the call ran
``csrc/attn_flash.cu``, to ``attn_density.flash_launches`` and, with
its density pass, to ``attn_density.flash_density_launches``.  No
fallback: a call the chosen kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MAX_DQK = 256
MAX_DV = 256
MAX_GROUP = 64
WAVE_BLOCKS = 132                  # SMs of an H100 SXM
FLASH_DIMS = (64, 128)             # csrc/attn_flash.cu's head dims
FLASH_ROWS = 128                   # its (query, head) rows a block
FLASH_KEYS = 128                   # its keys a K/V tile and a mass block
FLASH_COLS = 128                   # its rows of a mass query tile, at most
_LIB = None
_FLASH_LIB = None


def route(form: str, dqk: int, dv: int) -> str:
    """The kernel a call runs, by form and head dims alone: "wgmma"
    (``csrc/attn_flash.cu``) for the flash form at Dqk = Dv = 64 or 128,
    "mma" (``csrc/attn_density.cu``) for everything else."""
    return ("wgmma" if form == "flash" and dqk == dv and dqk in FLASH_DIMS
            else "mma")


def flash_plan(B: int, Sq: int, H: int, KV: int):
    """``csrc/attn_flash.cu``'s plan (``attn_flash_plan``): the forward
    takes FLASH_ROWS (query, head) rows a block, ceil(Sq G / 128) blocks
    along the rows, K/V tiles of FLASH_KEYS keys; the density takes
    query tiles of 128 // G whole queries (one TMA box of G heads), and
    ceil(Sq / that) of them.  -> (rows a block, row blocks, keys a tile,
    queries a query tile, query tiles)."""
    G = H // KV
    qt = FLASH_COLS // G
    return FLASH_ROWS, -(-Sq * G // FLASH_ROWS), FLASH_KEYS, qt, -(-Sq // qt)


def plan(B: int, Sq: int, H: int, KV: int):
    """The kernel's tile plan (``attn_density_rows`` in the CUDA source):
    64 (query, head) rows a block when B * KV * ceil(Sq G / 64) blocks
    still give every SM one, else 16 rows, so that serving's extend
    fills the card.  -> (rows a block, query tiles n_tiles, blocks)."""
    G = H // KV
    rows = 64 if B * KV * -(-Sq * G // 64) >= WAVE_BLOCKS else 16
    n_tiles = -(-Sq * G // rows)
    return rows, n_tiles, B * KV * n_tiles


def head_plan(dqk: int, dv: int):
    """The kernel's head-dim plan (``padded_dqk`` in the CUDA source):
    Dqk and Dv padded to the tile widths HDQ = max(Dqk, Dv) rounded up
    to 64, 128, 192 or 256 (the QK k-steps; 256 for any Dv > 128) and
    HDV = min(HDQ, 128) (the PV fragments; at HDQ 256 a block takes one
    128-column half of Dv).  -> (HDQ, HDV); ValueError for dims the
    kernel does not take."""
    if not (0 < dqk <= MAX_DQK and 0 < dv <= MAX_DV):
        raise ValueError(f"attn_density takes head dims Dqk <= {MAX_DQK} "
                         f"and Dv <= {MAX_DV}, not {dqk} and {dv}")
    w = max(dqk, dv)
    hdq = (64 if w <= 64 else 128 if w <= 128 else
           192 if w <= 192 and dv <= 128 else 256)
    return hdq, min(hdq, 128)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("attn_density")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.attn_density.argtypes = ([vp] * 9 + [ci] * 10
                                     + [ctypes.c_float, ci, vp])
        lib.attn_density.restype = ci
        lib.attn_density_rows.argtypes = [ci] * 4
        lib.attn_density_rows.restype = ci
        _LIB = lib
    return _LIB


def _flash_lib() -> ctypes.CDLL:
    global _FLASH_LIB
    if _FLASH_LIB is None:
        lib = build.load("attn_flash")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.attn_flash.argtypes = ([vp] * 10 + [ci] * 9
                                   + [ctypes.c_float, vp])
        lib.attn_flash.restype = ci
        lib.attn_flash_plan.argtypes = [ci] * 4 + [ctypes.POINTER(ci)]
        lib.attn_flash_plan.restype = ci
        _FLASH_LIB = lib
    return _FLASH_LIB


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def attn_density(q, k, v, q_pos, seq_len, window: int = 0,
                 n_sinks: int = 0, want_density: bool = True,
                 form: str = "served", return_stats: bool = False):
    """q (B,Sq,H,Dqk) bf16; k (B,Sk,KV,Dqk) bf16; v (B,Sk,KV,Dv) bf16;
    q_pos (Sq,) int32, all CUDA; seq_len an int or a 0-d int32 CUDA
    tensor.  Scores are scaled by 1/sqrt(Dqk).
    ``form`` is "served" (bf16-rounded p, the mass of every query) or
    "flash" (the Pallas kernel).  -> (out (B,Sq,H,Dv) bf16, density
    (B,Sk) fp32 | None); with ``return_stats`` (the flash form without
    the density) also each row's max m and sum max(l, 1e-30),
    (B,KV,G,Sq) fp32 each, views of one (2,B,KV,G,Sq) buffer."""
    if form not in ("served", "flash"):
        raise ValueError(f"form must be 'served' or 'flash', not {form!r}")
    if return_stats and (form != "flash" or want_density):
        raise ValueError("attn_density gives row stats in the flash form "
                         "without the density only")
    B, Sq, H, dqk = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    head_plan(dqk, dv)                  # ValueError for dims it refuses
    _check("q", q, torch.bfloat16, (B, Sq, H, dqk))
    _check("k", k, torch.bfloat16, (B, Sk, KV, dqk))
    _check("v", v, torch.bfloat16, (B, Sk, KV, dv))
    _check("q_pos", q_pos, torch.int32, (Sq,))
    if isinstance(seq_len, torch.Tensor):
        _check("seq_len", seq_len, torch.int32, ())
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"attn_density takes H a multiple of KV with "
                         f"H/KV <= {MAX_GROUP}, not H={H} KV={KV}")
    wgmma = route(form, dqk, dv) == "wgmma"
    stats = dens = None
    if return_stats or (want_density and wgmma):
        stats = torch.empty((2, B, KV, H // KV, Sq), dtype=torch.float32,
                            device=q.device)
    if want_density:
        dens = torch.empty((B, Sk), dtype=torch.float32, device=q.device)
    out = torch.empty((B, Sq, H, dv), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        if wgmma:
            _flash(q, k, v, q_pos, out, stats, dens, seq_len, window,
                   n_sinks)
            attn_density.flash_launches += 1
            if want_density:
                attn_density.flash_density_launches += 1
        else:
            _tiles(q, k, v, q_pos, out, stats, dens, seq_len, window,
                   n_sinks, form)
    attn_density.launches += 1
    if want_density:
        attn_density.density_launches += 1
    if return_stats:
        attn_density.stats_launches += 1
        return out, dens, stats[0], stats[1]
    return out, dens


def _tiles(q, k, v, q_pos, out, stats, dens, seq_len, window, n_sinks,
           form):
    """Launch ``csrc/attn_density.cu`` (route "mma") into ``out``,
    ``stats`` and ``dens`` (each may be None but out)."""
    B, Sq, H, dqk = q.shape
    Sk, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    lib = _lib()
    rows, n_tiles, _ = plan(B, Sq, H, KV)
    if lib.attn_density_rows(B, Sq, H, KV) != rows:
        raise RuntimeError("attn_density: the kernel's tile plan differs "
                           "from plan()")
    part = None
    if dens is not None:
        part = torch.empty((B, KV, n_tiles, Sk), dtype=torch.float32,
                           device=q.device)
    on_device = isinstance(seq_len, torch.Tensor)
    err = lib.attn_density(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if dens is None else dens.data_ptr(),
        None if stats is None else stats.data_ptr(),
        seq_len.data_ptr() if on_device else None,
        B, Sq, Sk, H, KV, dqk, dv, 0 if on_device else int(seq_len),
        int(window), int(n_sinks),
        float(np.float32(1.0 / np.sqrt(dqk))), int(form == "served"),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_density launch failed (error {err})")


def _flash(q, k, v, q_pos, out, stats, dens, seq_len, window, n_sinks):
    """Launch ``csrc/attn_flash.cu`` (route "wgmma") into ``out``,
    ``stats`` (the density needs it) and ``dens``."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"attn_density's flash kernel loads {name} by "
                             "TMA: its base must be 16-byte aligned")
    lib = _flash_lib()
    got = (ctypes.c_int * 5)()
    if (lib.attn_flash_plan(B, Sq, H, KV, got) != 0
            or tuple(got) != flash_plan(B, Sq, H, KV)):
        raise RuntimeError("attn_density: the flash kernel's plan differs "
                           "from flash_plan()")
    bounds = part = count = None
    if dens is not None:
        dev = q.device
        bounds = torch.empty((got[4], 2), dtype=torch.int32, device=dev)
        part = torch.empty((B, KV, Sk), dtype=torch.float32, device=dev)
        count = torch.empty((Sk,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = lib.attn_flash(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), ptr(stats), ptr(bounds), ptr(part), ptr(count),
        ptr(dens), B, Sq, Sk, H, KV, D, int(seq_len), int(window),
        int(n_sinks), float(np.float32(1.0 / np.sqrt(D))),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_density's flash kernel launch failed "
                           f"(error {err})")


attn_density.launches = 0
attn_density.density_launches = 0      # of them, those with the density
attn_density.stats_launches = 0        # of them, those with the row stats
attn_density.flash_launches = 0        # of them, those of csrc/attn_flash.cu
attn_density.flash_density_launches = 0  # and of those, with the density


def reset_launches() -> None:
    attn_density.launches = 0
    attn_density.density_launches = 0
    attn_density.stats_launches = 0
    attn_density.flash_launches = 0
    attn_density.flash_density_launches = 0
