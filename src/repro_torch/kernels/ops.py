"""Public kernel entry points.

Each op sends a CUDA tensor to its hand-written kernel
(``kernels/chunk_quant.py``) and a CPU tensor to the plain PyTorch
version (``kernels/ref.py``).  There is no fallback: a CUDA call the
kernel refuses raises, and any other device raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref


def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no chunk codec for device {t.device}")


def chunk_quantize(x: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, F) float -> (packed int8 (T*bits//8, F), scales fp32 (F,))."""
    if _route(x) == "cpu":
        return ref.quantize_ref(x, bits)
    from repro_torch.kernels import chunk_quant
    return chunk_quant.quantize(x.contiguous(), bits)


def chunk_dequantize(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                     n_tokens: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``chunk_quantize`` -> (n_tokens, F) in ``dtype``."""
    if _route(packed) == "cpu":
        return ref.dequantize_ref(packed, scale, bits, n_tokens, dtype)
    from repro_torch.kernels import chunk_quant
    return chunk_quant.dequantize(packed.contiguous(), scale.contiguous(),
                                  bits, n_tokens, dtype)
