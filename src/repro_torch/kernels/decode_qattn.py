"""CUDA decode attention over an all-int8 cache: wrapper of the
``decode_qattn`` entry of ``csrc/decode_mqattn.cu``.

Replaces the Pallas TPU kernel ``decode_qattn`` of the JAX package's
``kernels/decode_qattn.py`` (fused form) and stands for the reference's
jnp ``decode_attention`` with scales (select form, with the per-key
mass).  It runs ``decode_mqattn``'s split-S kernels instantiated for a
cache whose every position is int8 (``dq_split_kernel``,
``dq_split_pv_kernel``, ``dq_combine_kernel``): the same split plan
(``kernels/decode_mqattn.py::plan``) and the same scratch layout
(``scratch_floats``), no bf16 loads and no quant mask.  The plain
PyTorch version is ``kernels/ref.py::decode_qattn_plain``;
``kernels/ops.py`` dispatches between the two by the tensor's device.

The wrapper checks device, dtype, shape and contiguity, checks the C
split plan against ``plan``, allocates the output, the mass and the
fp32 scratch with ``torch.empty``, launches on the current stream
without synchronising (two or three kernels), raises if the launch was
refused, and adds one to ``decode_qattn.launches`` (a plain integer on
the wrapper) per call.  ``n_valid`` must be at least 1 in every row.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import decode_mqattn as kmq
from repro_torch.kernels.decode_mqattn import (MAX_GROUP, MAX_HEAD_DIM,
                                               _check, plan, scratch_floats)

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kmq._lib()                  # one library for both caches
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.decode_qattn.argtypes = ([vp] * 9 + [ci] * 7
                                     + [ctypes.c_float, ci, vp])
        lib.decode_qattn.restype = ci
        _LIB = lib
    return _LIB


def decode_qattn(q, k_q, v_q, k_scale, v_scale, n_valid, window: int = 0,
                 n_sinks: int = 0, want_mass: bool = False,
                 select: bool = False):
    """q (B,H,hd) bf16; k_q/v_q (B,S,KV,hd) int8; scales (B,S,KV) fp32;
    n_valid (B,) int32, all CUDA.  ``select`` picks the select form
    (bf16-rounded K/V and p), else the fused form (fp32 dequant).
    -> out (B,H,hd) bf16 [, mass (B,S) fp32]."""
    B, H, hd = q.shape
    S, KV = k_q.shape[1], k_q.shape[2]
    _check("q", q, torch.bfloat16, (B, H, hd))
    for name, t in (("k_q", k_q), ("v_q", v_q)):
        _check(name, t, torch.int8, (B, S, KV, hd))
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, t, torch.float32, (B, S, KV))
    _check("n_valid", n_valid, torch.int32, (B,))
    if H % KV or H // KV > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode_qattn takes H a multiple of KV with "
                         f"H/KV <= {MAX_GROUP} and hd <= {MAX_HEAD_DIM}, "
                         f"not H={H} KV={KV} hd={hd}")
    dev = q.device
    lib = _lib()
    if lib.decode_mqattn_splits(B, S, KV) != plan(B, S, KV)[0]:
        raise RuntimeError("decode_qattn: the kernel's split plan differs "
                           "from plan()")
    out = torch.empty((B, H, hd), dtype=torch.bfloat16, device=dev)
    scratch = torch.empty(scratch_floats(B, S, H, KV, hd),
                          dtype=torch.float32, device=dev)
    mass = (torch.empty((B, S), dtype=torch.float32, device=dev)
            if want_mass else None)
    with torch.cuda.device(dev):
        err = lib.decode_qattn(
            q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), n_valid.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), None if mass is None else mass.data_ptr(),
            B, S, H, KV, hd, int(window), int(n_sinks),
            float(np.float32(1.0 / np.sqrt(hd))), int(bool(select)),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_qattn launch failed (error {err})")
    decode_qattn.launches += 1
    return (out, mass) if want_mass else out


decode_qattn.launches = 0


def reset_launches() -> None:
    decode_qattn.launches = 0
