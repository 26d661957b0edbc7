"""CUDA extend attention with the Eq.-1 density: wrapper of
``csrc/attn_density.cu``.

Replaces the Pallas TPU kernels ``attn_density`` (passes ``_fwd`` and
``_mass``) of the JAX package's ``kernels/attn_density.py``, and takes
what serving's extend needs beside them: query positions, ``seq_len``,
and the served form of ``models/common.gqa_attention``.  The plain
PyTorch version is ``kernels/ref.py::attn_density_plain``;
``kernels/ops.py`` dispatches between the two by the tensor's device.
Design and bound are in the CUDA source's note: (query, head) rows in
blocks of 4 warps, 16 or 64 rows a block (``plan``), bf16 K/V tiles
double-buffered through shared memory, QK and PV on the tensor cores
(``mma.sync`` m16n8k16), the key mass summed from the score fragments
and reduced by a second fixed-order launch.  Queries and keys have head
dim Dqk <= 256 and values Dv <= 256, padded to the kernel's tile widths
(``head_plan``): the dense family's Dqk = Dv = hd, MLA's recompute
128 + 64 and 128, recurrentgemma's local MQA 256 and 256 (V in two
128-column halves, one block each).

The wrapper checks device, dtype, shape and contiguity, allocates the
output, the density and the (B, KV, n_tiles, Sk) fp32 scratch with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and adds one to
``attn_density.launches`` (a plain integer on the wrapper) and, when
it also launched the density pass and its reduction, to
``attn_density.density_launches``; when it launched the row-stats
kernel (``return_stats``: the forward of ``models/common.py
flash_attention``), to ``attn_density.stats_launches``.
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
_LIB = None


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
        lib.attn_density.argtypes = ([vp] * 8 + [ci] * 10
                                     + [ctypes.c_float, ci, vp])
        lib.attn_density.restype = ci
        lib.attn_density_rows.argtypes = [ci] * 4
        lib.attn_density_rows.restype = ci
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def attn_density(q, k, v, q_pos, seq_len: int, window: int = 0,
                 n_sinks: int = 0, want_density: bool = True,
                 form: str = "served", return_stats: bool = False):
    """q (B,Sq,H,Dqk) bf16; k (B,Sk,KV,Dqk) bf16; v (B,Sk,KV,Dv) bf16;
    q_pos (Sq,) int32, all CUDA.  Scores are scaled by 1/sqrt(Dqk).
    ``form`` is "served" (bf16-rounded p, the mass of every query) or
    "flash" (the Pallas kernel).  -> (out (B,Sq,H,Dv) bf16, density
    (B,Sk) fp32 | None); with ``return_stats`` (the flash form without
    the density: ``attn_density_stats_kernel``) also each row's max m
    and sum max(l, 1e-30), (B,KV,G,Sq) fp32 each, views of one
    (2,B,KV,G,Sq) buffer."""
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
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"attn_density takes H a multiple of KV with "
                         f"H/KV <= {MAX_GROUP}, not H={H} KV={KV}")
    dev = q.device
    lib = _lib()
    rows, n_tiles, _ = plan(B, Sq, H, KV)
    if lib.attn_density_rows(B, Sq, H, KV) != rows:
        raise RuntimeError("attn_density: the kernel's tile plan differs "
                           "from plan()")
    out = torch.empty((B, Sq, H, dv), dtype=torch.bfloat16, device=dev)
    part = dens = stats = None
    if return_stats:
        stats = torch.empty((2, B, KV, H // KV, Sq), dtype=torch.float32,
                            device=dev)
    if want_density:
        part = torch.empty((B, KV, n_tiles, Sk), dtype=torch.float32,
                           device=dev)
        dens = torch.empty((B, Sk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.attn_density(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if dens is None else dens.data_ptr(),
            None if stats is None else stats.data_ptr(),
            B, Sq, Sk, H, KV, dqk, dv, int(seq_len), int(window),
            int(n_sinks), float(np.float32(1.0 / np.sqrt(dqk))),
            int(form == "served"), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_density launch failed (error {err})")
    attn_density.launches += 1
    if want_density:
        attn_density.density_launches += 1
    if return_stats:
        attn_density.stats_launches += 1
        return out, dens, stats[0], stats[1]
    return out, dens


attn_density.launches = 0
attn_density.density_launches = 0      # of them, those with the density
attn_density.stats_launches = 0        # of them, those with the row stats


def reset_launches() -> None:
    attn_density.launches = 0
    attn_density.density_launches = 0
    attn_density.stats_launches = 0
