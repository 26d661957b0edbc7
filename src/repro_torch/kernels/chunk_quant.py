"""CUDA chunk codec: wrappers of ``csrc/chunk_quant.cu``.

Replaces the Pallas TPU kernels ``quantize`` / ``dequantize`` of the JAX
package's ``kernels/chunk_quant.py``.  The plain PyTorch versions are
``kernels/ref.py``; ``kernels/ops.py`` dispatches between the two by
the tensor's device.  Design and bound are in the CUDA source's note:
one thread per channel column, memory-bound, launch-dominated at the
serving shape (16, 131072).

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and adds one to its
``launches`` count (a plain integer on the wrapper).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("chunk_quant")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.chunk_quantize.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp]
        lib.chunk_quantize.restype = ci
        lib.chunk_dequantize.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.chunk_dequantize.restype = ci
        _LIB = lib
    return _LIB


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bits(bits: int, T: int) -> None:
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, not {bits}")
    if T % (8 // bits):
        raise ValueError(f"T={T} is not a multiple of {8 // bits}")


def quantize(x: torch.Tensor, bits: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, F) fp32|bf16 CUDA -> (packed (T*bits//8, F) int8, scales
    (F,) fp32)."""
    _check_cuda("x", x)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (T, F) fp32/bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")
    T, F = x.shape
    _check_bits(bits, T)
    packed = torch.empty((T * bits // 8, F), dtype=torch.int8,
                         device=x.device)
    scale = torch.empty((F,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().chunk_quantize(
            x.data_ptr(), _DTYPE_CODE[x.dtype], packed.data_ptr(),
            scale.data_ptr(), T, F, bits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_quantize launch failed (error {err})")
    quantize.launches += 1
    return packed, scale


def dequantize(packed: torch.Tensor, scale: torch.Tensor, bits: int,
               n_tokens: int, dtype=torch.bfloat16) -> torch.Tensor:
    """packed (n_tokens*bits//8, F) int8 + scale (F,) fp32 CUDA ->
    (n_tokens, F) in ``dtype`` (bf16 or fp32)."""
    _check_cuda("packed", packed)
    _check_cuda("scale", scale)
    _check_bits(bits, n_tokens)
    if packed.dim() != 2 or packed.dtype != torch.int8:
        raise ValueError(f"packed must be (T', F) int8, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    Tp, F = packed.shape
    if Tp != n_tokens * bits // 8:
        raise ValueError(f"{Tp} packed rows do not hold {n_tokens} tokens "
                         f"at {bits} bits")
    if scale.shape != (F,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be ({F},) fp32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype must be fp32 or bf16, not {dtype}")
    if packed.device != scale.device:
        raise ValueError("packed and scale lie on different devices")
    out = torch.empty((n_tokens, F), dtype=dtype, device=packed.device)
    with torch.cuda.device(packed.device):
        err = _lib().chunk_dequantize(
            packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[dtype], n_tokens, F, bits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_dequantize launch failed (error {err})")
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0


def reset_launches() -> None:
    quantize.launches = 0
    dequantize.launches = 0
