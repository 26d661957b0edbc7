"""Public kernel entry points.

Each op sends a CUDA tensor to its hand-written kernel
(``kernels/chunk_quant.py``, ``kernels/attn_density.py``,
``kernels/decode_mqattn.py``, ``kernels/decode_qattn.py``) and a CPU
tensor to the plain PyTorch version (``kernels/ref.py``).  There is no fallback: a CUDA call the
kernel refuses raises, and any other device raises.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import ref


def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no kernel for device {t.device}")


def chunk_quantize(x: torch.Tensor, bits: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, F) float -> (packed int8 (T*bits//8, F), scales fp32 (F,))."""
    if _route(x) == "cpu":
        return ref.quantize_ref(x, bits)
    from repro_torch.kernels import chunk_quant
    return chunk_quant.quantize(x.contiguous(), bits)


def chunk_quantize_leaves(xs: Sequence[torch.Tensor], bits: int
                          ) -> Tuple[torch.Tensor,
                                     List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The leaves (T, F_i) of one chunk -> (buf, [(packed, scales)]):
    each leaf's codes and scales (as ``chunk_quantize``) are views of the
    one uint8 buffer ``buf``, so the chunk comes to the host in one copy.
    On the card one launch quantizes up to eight leaves."""
    from repro_torch.kernels import chunk_quant
    xs = list(xs)
    if _route(xs[0]) == "cpu":
        refs = [ref.quantize_ref(x, bits) for x in xs]
        buf, outs = chunk_quant.leaf_buffer(
            xs[0].shape[0], [x.shape[1] for x in xs], bits, xs[0].device)
        for (p, s), (rp, rs) in zip(outs, refs):
            p.copy_(rp)
            s.copy_(rs)
        return buf, outs
    return chunk_quant.quantize_leaves([x.contiguous() for x in xs], bits)


def chunk_dequantize(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                     n_tokens: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``chunk_quantize`` -> (n_tokens, F) in ``dtype``."""
    if _route(packed) == "cpu":
        return ref.dequantize_ref(packed, scale, bits, n_tokens, dtype)
    from repro_torch.kernels import chunk_quant
    return chunk_quant.dequantize(packed.contiguous(), scale.contiguous(),
                                  bits, n_tokens, dtype)


def decode_mqattn(q, k, v, k_q, v_q, k_scale, v_scale, quant_mask, n_valid,
                  window: int = 0, n_sinks: int = 0, want_mass: bool = False,
                  select: bool = False):
    """One-token attention over a mixed bf16/int8 cache.  q (B,H,hd);
    k/v (B,S,KV,hd) bf16; k_q/v_q int8; scales (B,S,KV) fp32; quant_mask
    (B,S) bool; n_valid (B,) int.  -> out (B,H,hd) bf16 [, mass (B,S)]
    (forms: ``kernels/ref.py::decode_mqattn_plain``)."""
    if _route(q) == "cpu":
        return ref.decode_mqattn_plain(q, k, v, k_q, v_q, k_scale, v_scale,
                                       quant_mask, n_valid, window, n_sinks,
                                       want_mass, select)
    from repro_torch.kernels import decode_mqattn as kmq
    c = [t.contiguous() for t in (q, k, v, k_q, v_q, k_scale, v_scale,
                                  quant_mask)]
    return kmq.decode_mqattn(*c, n_valid.to(torch.int32).contiguous(),
                             window, n_sinks, want_mass, select)


def decode_qattn(q, k_q, v_q, k_scale, v_scale, n_valid, window: int = 0,
                 n_sinks: int = 0, want_mass: bool = False,
                 select: bool = False):
    """One-token attention over an all-int8 cache.  q (B,H,hd); k_q/v_q
    (B,S,KV,hd) int8; scales (B,S,KV) fp32; n_valid () or (B,) int.
    -> out (B,H,hd) [, mass (B,S)] (forms:
    ``kernels/ref.py::decode_qattn_plain``)."""
    if _route(q) == "cpu":
        return ref.decode_qattn_plain(q, k_q, v_q, k_scale, v_scale, n_valid,
                                      window, n_sinks, want_mass, select)
    from repro_torch.kernels import decode_qattn as kdq
    B = q.shape[0]
    nv = torch.as_tensor(n_valid, device=q.device).to(torch.int32)
    nv = nv.reshape(-1).expand(B).contiguous()
    c = [t.contiguous() for t in (q, k_q, v_q, k_scale, v_scale)]
    return kdq.decode_qattn(*c, nv, window, n_sinks, want_mass, select)


def attn_density(q, k, v, q_pos, seq_len, window: int = 0, n_sinks: int = 0,
                 want_density: bool = True, form: str = "served"):
    """Attention of queries at positions ``q_pos`` (Sq,) over a cache
    bounded by ``seq_len``, with the Eq.-1 key density.  q (B,Sq,H,hd);
    k/v (B,Sk,KV,hd).  -> (out (B,Sq,H,hd), density (B,Sk) | None)
    (forms: ``kernels/ref.py::attn_density_plain``)."""
    if _route(q) == "cpu":
        return ref.attn_density_plain(q, k, v, q_pos, seq_len, window,
                                      n_sinks, want_density, form)
    from repro_torch.kernels import attn_density as kad
    c = [t.contiguous() for t in (q, k, v)]
    return kad.attn_density(*c, q_pos.to(torch.int32).contiguous(),
                            int(seq_len), window, n_sinks, want_density,
                            form)
