"""CUDA chunk codec: wrappers of ``csrc/chunk_quant.cu``.

Replaces the Pallas TPU kernels ``quantize`` / ``dequantize`` of the JAX
package's ``kernels/chunk_quant.py``.  The plain PyTorch versions are
``kernels/ref.py``; ``kernels/ops.py`` dispatches between the two by
the tensor's device.  Design and bound are in the CUDA source's note:
quantize reads a chunk block once into registers with vector loads (4
columns a thread) and quantizes up to ``MAX_LEAVES`` leaves of one
chunk in one launch (``quantize_leaves``); dequantize runs one thread
per channel column.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch was refused, and adds one to its
kernel's ``launches`` count (a plain integer on the wrapper) per
launch: ``quantize.launches`` counts the quantize kernel's launches
from ``quantize`` and from ``quantize_leaves`` alike.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_LEAVES = 8                     # leaves of one quantize launch
_ALIGN = 256                       # bytes between leaves in a buffer
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("chunk_quant")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.chunk_quantize_leaves.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci,
                                              vp]
        lib.chunk_quantize_leaves.restype = ci
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


def leaf_buffer(T: int, Fs: Sequence[int], bits: int, device
                ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """One uint8 buffer for the codes and scales of leaves (T, F) of one
    chunk, each region 256-byte aligned.  -> (buf, [(packed (T*bits//8,
    F) int8, scale (F,) fp32) views of buf])."""
    regions, n = [], 0
    for F in Fs:
        p = n
        n = -(-(p + T * bits // 8 * F) // _ALIGN) * _ALIGN
        s = n
        n = -(-(s + 4 * F) // _ALIGN) * _ALIGN
        regions.append((p, s, F))
    buf = torch.empty(n, dtype=torch.uint8, device=device)
    return buf, [(buf[p:p + T * bits // 8 * F].view(torch.int8)
                  .view(T * bits // 8, F),
                  buf[s:s + 4 * F].view(torch.float32))
                 for p, s, F in regions]


def _check_leaf(x: torch.Tensor) -> None:
    _check_cuda("x", x)
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be (T, F) fp32/bf16, got {tuple(x.shape)} "
                         f"{x.dtype}")


def _launch_quantize(xs, outs, bits: int) -> None:
    """One launch of the quantize kernel over up to MAX_LEAVES leaves."""
    n, T = len(xs), xs[0].shape[0]
    vp = ctypes.c_void_p
    ptrs = lambda ts: (vp * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    with torch.cuda.device(xs[0].device):
        err = _lib().chunk_quantize_leaves(
            ptrs(xs), _DTYPE_CODE[xs[0].dtype], ptrs([p for p, _ in outs]),
            ptrs([s for _, s in outs]),
            (ctypes.c_int * n)(*[x.shape[1] for x in xs]), n, T, bits,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunk_quantize launch failed (error {err})")
    quantize.launches += 1


def quantize(x: torch.Tensor, bits: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, F) fp32|bf16 CUDA -> (packed (T*bits//8, F) int8, scales
    (F,) fp32)."""
    _check_leaf(x)
    T, F = x.shape
    _check_bits(bits, T)
    packed = torch.empty((T * bits // 8, F), dtype=torch.int8,
                         device=x.device)
    scale = torch.empty((F,), dtype=torch.float32, device=x.device)
    _launch_quantize([x], [(packed, scale)], bits)
    return packed, scale


def quantize_leaves(xs: Sequence[torch.Tensor], bits: int
                    ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                        torch.Tensor]]]:
    """Leaves (T, F_i) of one chunk, CUDA, of one dtype and one T, in
    one launch per ``MAX_LEAVES`` leaves.  -> (buf, [(packed, scale)]):
    the codes and scales are views of the one uint8 buffer ``buf``
    (``leaf_buffer``), so the chunk comes to the host in one copy."""
    xs = list(xs)
    if not xs:
        raise ValueError("no leaves to quantize")
    for x in xs:
        _check_leaf(x)
    T = xs[0].shape[0]
    if any(x.shape[0] != T or x.dtype != xs[0].dtype
           or x.device != xs[0].device for x in xs):
        raise ValueError("the leaves of one launch share T, dtype and "
                         "device")
    _check_bits(bits, T)
    buf, outs = leaf_buffer(T, [x.shape[1] for x in xs], bits, xs[0].device)
    for i in range(0, len(xs), MAX_LEAVES):
        _launch_quantize(xs[i:i + MAX_LEAVES], outs[i:i + MAX_LEAVES], bits)
    return buf, outs


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
