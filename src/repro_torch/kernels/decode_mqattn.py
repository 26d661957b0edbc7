"""CUDA mixed-cache decode attention: wrapper of ``csrc/decode_mqattn.cu``.

Replaces the Pallas TPU kernel ``decode_mqattn`` of the JAX package's
``kernels/decode_qattn.py`` and, beside its output, emits the per-key
mass the serving path needs.  The plain PyTorch version is
``kernels/ref.py::decode_mqattn_plain``; ``kernels/ops.py`` dispatches
between the two by the tensor's device.  Design and bound are in the
CUDA source's note: S split across blocks (flash-decoding, ``plan``),
16-byte row loads on CUDA cores, a split's scores in shared memory, and
a last launch that combines the splits and sums the mass in a fixed
order.

The wrapper checks device, dtype, shape and contiguity, allocates the
output, the mass and the fp32 scratch (scores (B, H, S), each split's
(m, l) and PV partial: ``scratch_floats``) with ``torch.empty``,
launches on the current stream without synchronising (two or three
kernels), raises if the launch was refused, and adds one to
``decode_mqattn.launches`` (a plain integer on the wrapper) per call.  ``n_valid`` must be at least 1 in every row
(decode always attends its own new token).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 128
MAX_GROUP = 8
TARGET_BLOCKS = 4 * 132            # four blocks per SM of an H100 SXM
MIN_SPLIT_KEYS = 64
MAX_SPLIT_KEYS = 1024              # a split's scores in shared memory
_LIB = None


def plan(B: int, S: int, KV: int):
    """The kernel's split plan (``split_plan`` in the CUDA source): as
    many splits as give the (n_splits, KV, B) grid up to four blocks per
    SM, with at least 64 keys a split where S has them and at most 1024.
    -> (n_splits, keys a split, blocks)."""
    n = max(1, min(TARGET_BLOCKS // (B * KV), S // MIN_SPLIT_KEYS))
    n = max(n, -(-S // MAX_SPLIT_KEYS))
    length = -(-S // n)
    n = -(-S // length)
    return n, length, n * KV * B


def scratch_floats(B: int, S: int, H: int, KV: int, hd: int) -> int:
    """fp32 scratch of one call: scores (B, H, S), then each split's
    (m, l) (B, H, n_splits, 2) and PV partial (B, H, n_splits, hd)."""
    n = plan(B, S, KV)[0]
    return B * H * (S + n * (2 + hd))


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("decode_mqattn")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_mqattn.argtypes = ([vp] * 12 + [ci] * 7
                                      + [ctypes.c_float, ci, vp])
        lib.decode_mqattn.restype = ci
        lib.decode_mqattn_splits.argtypes = [ci] * 3
        lib.decode_mqattn_splits.restype = ci
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


def decode_mqattn(q, k, v, k_q, v_q, k_scale, v_scale, quant_mask, n_valid,
                  window: int = 0, n_sinks: int = 0, want_mass: bool = False,
                  select: bool = False):
    """q (B,H,hd) bf16; k/v (B,S,KV,hd) bf16; k_q/v_q int8; scales (B,S,KV)
    fp32; quant_mask (B,S) bool; n_valid (B,) int32, all CUDA.  ``select``
    picks the select form (bf16-rounded p), else the fused form.
    -> out (B,H,hd) bf16 [, mass (B,S) fp32]."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    _check("q", q, torch.bfloat16, (B, H, hd))
    for name, t in (("k", k), ("v", v)):
        _check(name, t, torch.bfloat16, (B, S, KV, hd))
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        _check(name, t, torch.int8, (B, S, KV, hd))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, t, torch.float32, (B, S, KV))
    _check("quant_mask", quant_mask, torch.bool, (B, S))
    _check("n_valid", n_valid, torch.int32, (B,))
    if H % KV or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_mqattn takes H a multiple of KV with "
                         f"H/KV <= {MAX_GROUP} and hd <= {MAX_HEAD_DIM}, "
                         f"not H={H} KV={KV} hd={hd}")
    dev = q.device
    lib = _lib()
    if lib.decode_mqattn_splits(B, S, KV) != plan(B, S, KV)[0]:
        raise RuntimeError("decode_mqattn: the kernel's split plan differs "
                           "from plan()")
    out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(scratch_floats(B, S, H, KV, hd),
                          dtype=torch.float32, device=dev)
    mass = (torch.empty((B, S), dtype=torch.float32, device=dev)
            if want_mass else None)
    with torch.cuda.device(dev):
        err = lib.decode_mqattn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_q.data_ptr(),
            v_q.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            quant_mask.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), None if mass is None else mass.data_ptr(),
            B, S, H, KV, hd, int(window), int(n_sinks),
            float(np.float32(1.0 / np.sqrt(hd))), int(bool(select)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_mqattn launch failed (error {err})")
    decode_mqattn.launches += 1
    return (out, mass) if want_mass else out


decode_mqattn.launches = 0


def reset_launches() -> None:
    decode_mqattn.launches = 0
