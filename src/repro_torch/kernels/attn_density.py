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
and reduced by a second fixed-order launch.

The wrapper checks device, dtype, shape and contiguity, allocates the
output, the density and the (B, KV, n_tiles, Sk) fp32 scratch with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch was refused, and adds one to
``attn_density.launches`` (a plain integer on the wrapper) and, when
it also launched the density pass and its reduction, to
``attn_density.density_launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
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


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("attn_density")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.attn_density.argtypes = ([vp] * 7 + [ci] * 9
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
                 form: str = "served"):
    """q (B,Sq,H,hd) bf16; k/v (B,Sk,KV,hd) bf16; q_pos (Sq,) int32, all
    CUDA.  ``form`` is "served" (bf16-rounded p, the mass of every
    query) or "flash" (the Pallas kernel).  -> (out (B,Sq,H,hd) bf16,
    density (B,Sk) fp32 | None)."""
    if form not in ("served", "flash"):
        raise ValueError(f"form must be 'served' or 'flash', not {form!r}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    _check("q", q, torch.bfloat16, (B, Sq, H, hd))
    for name, t in (("k", k), ("v", v)):
        _check(name, t, torch.bfloat16, (B, Sk, KV, hd))
    _check("q_pos", q_pos, torch.int32, (Sq,))
    if H % KV or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"attn_density takes H a multiple of KV with "
                         f"H/KV <= {MAX_GROUP} and hd <= {MAX_HEAD_DIM}, "
                         f"not H={H} KV={KV} hd={hd}")
    dev = q.device
    lib = _lib()
    rows, n_tiles, _ = plan(B, Sq, H, KV)
    if lib.attn_density_rows(B, Sq, H, KV) != rows:
        raise RuntimeError("attn_density: the kernel's tile plan differs "
                           "from plan()")
    out = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16, device=dev)
    part = dens = None
    if want_density:
        part = torch.empty((B, KV, n_tiles, Sk), dtype=torch.float32,
                           device=dev)
        dens = torch.empty((B, Sk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.attn_density(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(),
            None if dens is None else dens.data_ptr(),
            B, Sq, Sk, H, KV, hd, int(seq_len), int(window),
            int(n_sinks), float(np.float32(1.0 / np.sqrt(hd))),
            int(form == "served"), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_density launch failed (error {err})")
    attn_density.launches += 1
    if want_density:
        attn_density.density_launches += 1
    return out, dens


attn_density.launches = 0
attn_density.density_launches = 0      # of them, those with the density


def reset_launches() -> None:
    attn_density.launches = 0
    attn_density.density_launches = 0
