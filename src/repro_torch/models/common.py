"""Shared model primitives for dense serving (mirror of the JAX
package's models/common.py: the functions dense serving runs).

These stay plain PyTorch, as the JAX package computes them outside any
Pallas kernel too — except the attention of serving's extend
(``extend_attention``: the ``attn_density`` kernel) and of decode over
a mixed or an all-int8 cache (``mixed_decode_attention``: the
``decode_mqattn`` kernel; ``decode_attention`` with scales: the
``decode_qattn`` kernel), which go through ``kernels/ops.py`` (on a
CPU tensor, to the kernels' plain versions).  Casts follow the
reference one for one — scores
and softmax in fp32, ``p`` cast to the value dtype before the PV
product, masking with the finite ``NEG_INF`` (a fully masked row comes
out uniform, not NaN) — because the Eq.-1 density they emit drives the
Eq.-3 bit plan.

``key_density`` is the paper's Eq. (1) information-density statistic:
the mean attention mass each key token receives from the queries that
can see it, averaged over heads (the caller averages layers).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def configure_numerics(device: torch.device) -> None:
    """Pin the card's matmul numerics to the reference's.  bf16 products
    reduce in full fp32 (no reduced-precision split-K reductions), and
    fp32 products stay fp32 (no TF32): the Eq.-1 density feeds the bit
    plan, so the port must not round where the reference does not."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


# --------------------------------------------------------------------- #
# Rotary position embeddings (computed on the fly from positions)
# --------------------------------------------------------------------- #
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin of shape (..., head_dim//2), fp32."""
    half = head_dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=positions.device)
        * (-math.log(theta) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (..., n_heads, head_dim); cos/sin broadcastable to (..., 1, hd//2).
    Rotate-half convention (llama): pairs are (x[:d/2], x[d/2:])."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# --------------------------------------------------------------------- #
# Masks
# --------------------------------------------------------------------- #
def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int = 0, n_sinks: int = 0) -> torch.Tensor:
    """Boolean (..., Sq, Sk) mask, True == attend.  window > 0 is the
    paper's streaming mode: the last ``window`` tokens plus the first
    ``n_sinks`` sink tokens (StreamingLLM, paper §4)."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    m = k <= q
    if window > 0:
        m = m & ((k > (q - window)) | (k < n_sinks))
    return m


# --------------------------------------------------------------------- #
# Grouped-query attention with the Eq.-1 density
# --------------------------------------------------------------------- #
class AttnOut(NamedTuple):
    out: torch.Tensor                       # (B, Sq, H, hd)
    key_density: Optional[torch.Tensor]     # (B, Sk) fp32 or None


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, want_density: bool = False) -> AttnOut:
    """q (B,Sq,H,hd); k/v (B,Sk,KV,hd); mask bool broadcastable to
    (B|1, Sq, Sk).  Never repeats KV heads."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    maskb = mask[None] if mask.dim() == 2 else mask           # (B|1, Sq, Sk)
    s = torch.where(maskb[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)
    out = out.reshape(B, Sq, H, v.shape[-1])
    density = None
    if want_density:
        # Eq. (1): per key, mean attention received over valid queries
        mass = torch.sum(p, dim=(1, 2, 3))                        # (B, Sk)
        nvalid = torch.clamp_min(torch.sum(maskb, dim=1), 1)      # (B|1, Sk)
        density = (mass / (H * nvalid)).to(torch.float32)
    return AttnOut(out, density)


def extend_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, seq_len, window: int = 0,
                     n_sinks: int = 0, want_density: bool = False
                     ) -> AttnOut:
    """The attention of serving's extend (``DenseModel.recompute``):
    queries at positions ``q_pos`` (Sq,) over the whole cache k/v
    (B,Sk,KV,hd), under ``causal_window_mask(q_pos, k) & (k <
    seq_len)``, with the Eq.-1 key density.  It computes what
    ``gqa_attention`` computes under that mask (``form="served"``): on
    the card through the ``attn_density`` CUDA kernel, on the CPU
    through its plain version."""
    from repro_torch.kernels import ops as kops
    out, density = kops.attn_density(q, k, v, q_pos, seq_len, window,
                                     n_sinks, want_density, form="served")
    return AttnOut(out, density)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: int = 0, n_sinks: int = 0,
                     want_density: bool = False):
    """One-step attention.  q (B,1,H,hd); caches (B,S,KV,hd) bf16, or
    int8 with per-(B,S,KV) fp32 scales.  cur_pos () or (B,): the new
    token attends to cache[:cur_pos].  -> out (B,1,H,hd)[, per-key mass
    (B,S) fp32].  With scales it runs ``ops.decode_qattn`` in the select
    form (K/V dequantized to q's dtype, p rounded before PV: what the
    reference computes here), the ``decode_qattn`` kernel on the card."""
    if k_scale is not None:
        from repro_torch.kernels import ops as kops
        res = kops.decode_qattn(q[:, 0], k_cache, v_cache, k_scale, v_scale,
                                cur_pos, window, n_sinks,
                                want_mass=want_density, select=True)
        if want_density:
            return res[0][:, None], res[1]
        return res[:, None]
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    k_pos = torch.arange(S, device=q.device)
    pos_b = cur_pos.expand(B) if cur_pos.dim() == 0 else cur_pos
    valid = k_pos[None, :] < pos_b[:, None]                    # (B, S)
    if window > 0:
        valid = valid & ((k_pos[None, :] >= (pos_b[:, None] - window))
                         | (k_pos[None, :] < n_sinks))
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, H, v_cache.shape[-1])
    if want_density:
        mass = (torch.sum(p, dim=(1, 2, 3)) / H).to(torch.float32)
        return out, mass
    return out


# --------------------------------------------------------------------- #
# Mixed-precision decode attention: bf16 recent window + int8
# quant-resident chunk segments (fused dequant, selected per position).
#
# A quant position's value is ``(code * scale) -> bf16``: exactly what a
# full dequantization materializes into the bf16 cache, so quant-resident
# decode gives the full-dequant path's tokens.
# --------------------------------------------------------------------- #

# from this many cache positions on, the CPU path switches from the
# plain select (``decode_attention`` numerics) to the blocked
# online-softmax scan, as the reference does
MIXED_BLOCKED_MIN_S = 4096


def dequant_select(x_cache: torch.Tensor, x_q: torch.Tensor,
                   x_scale: torch.Tensor, quant_mask: torch.Tensor
                   ) -> torch.Tensor:
    """Per-position select between the bf16 cache and the dequantized
    int8 segments.  x_cache (B,S,KV,hd); x_q int8; x_scale (B,S,KV);
    quant_mask (B,S) bool."""
    dq = (x_q.to(torch.float32) * x_scale[..., None]).to(x_cache.dtype)
    return torch.where(quant_mask[:, :, None, None], dq, x_cache)


def mixed_decode_attention_blocked(q, k_cache, v_cache, k_q, v_q, k_scale,
                                   v_scale, quant_mask, cur_pos,
                                   window: int = 0, n_sinks: int = 0,
                                   want_density: bool = False,
                                   block: int = 1024):
    """The reference's blocked scan: online softmax over key blocks, one
    (B, block, KV, hd) tile dequantized at a time, PV in fp32, and a
    second pass for the normalized per-key mass.  The reference pads the
    last block with invalid keys, whose p is exactly 0; here the last
    block is just shorter."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, 1, KV, G, hd).to(torch.float32)
    scale = 1.0 / np.sqrt(hd)
    pos_b = cur_pos.expand(B) if cur_pos.dim() == 0 else cur_pos

    def scores(lo: int, hi: int):
        kf = dequant_select(k_cache[:, lo:hi], k_q[:, lo:hi],
                            k_scale[:, lo:hi], quant_mask[:, lo:hi]
                            ).to(torch.float32)
        s = torch.einsum("bqngd,bknd->bngqk", qg, kf)[:, :, :, 0] * scale
        k_pos = torch.arange(lo, hi, device=q.device)
        valid = k_pos[None, :] < pos_b[:, None]
        if window > 0:
            valid = valid & ((k_pos[None, :] >= (pos_b[:, None] - window))
                             | (k_pos[None, :] < n_sinks))
        return torch.where(valid[:, None, None, :], s, NEG_INF)

    blocks = [(lo, min(lo + block, S)) for lo in range(0, S, block)]
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, hd), dtype=torch.float32, device=q.device)
    for lo, hi in blocks:
        s = scores(lo, hi)
        vf = dequant_select(v_cache[:, lo:hi], v_q[:, lo:hi],
                            v_scale[:, lo:hi], quant_mask[:, lo:hi]
                            ).to(torch.float32)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bngk,bknd->bngd", p, vf)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).to(q.dtype).reshape(B, 1, H, hd)
    if not want_density:
        return out
    masses = []
    for lo, hi in blocks:
        p = torch.exp(scores(lo, hi) - m[..., None]) / l_safe[..., None]
        masses.append((p.sum(dim=(1, 2)) / H).to(torch.float32))
    return out, torch.cat(masses, dim=1)


def mixed_decode_attention(q, k_cache, v_cache, k_q, v_q, k_scale, v_scale,
                           quant_mask, cur_pos, window: int = 0,
                           n_sinks: int = 0, want_density: bool = False):
    """One-step attention over a mixed cache.  q (B,1,H,hd); k/v bf16 and
    k_q/v_q int8 caches (B,S,KV,hd); scales (B,S,KV); quant_mask (B,S);
    cur_pos () or (B,).  -> out (B,1,H,hd)[, per-key mass (B,S)].

    On the card every case runs the ``decode_mqattn`` CUDA kernel, in the
    form of the reference branch it stands for: fused without density
    (the reference's Pallas kernel) or with density at S >= 4096 (its
    blocked scan), select with density below (its plain select path).
    On the CPU the reference's own branches run as plain PyTorch."""
    S = k_cache.shape[1]
    if q.is_cuda:
        from repro_torch.kernels import ops as kops
        B = q.shape[0]
        n_valid = cur_pos.expand(B) if cur_pos.dim() == 0 else cur_pos
        res = kops.decode_mqattn(
            q[:, 0], k_cache, v_cache, k_q, v_q, k_scale, v_scale,
            quant_mask, n_valid, window, n_sinks, want_mass=want_density,
            select=want_density and S < MIXED_BLOCKED_MIN_S)
        if want_density:
            return res[0][:, None], res[1]
        return res[:, None]
    if S >= MIXED_BLOCKED_MIN_S:
        return mixed_decode_attention_blocked(
            q, k_cache, v_cache, k_q, v_q, k_scale, v_scale, quant_mask,
            cur_pos, window, n_sinks, want_density)
    k = dequant_select(k_cache, k_q, k_scale, quant_mask)
    v = dequant_select(v_cache, v_q, v_scale, quant_mask)
    return decode_attention(q, k, v, cur_pos, window=window,
                            n_sinks=n_sinks, want_density=want_density)


# --------------------------------------------------------------------- #
# Paged KV pool: dense cache view over page arenas
# --------------------------------------------------------------------- #
def paged_cache_view(arenas, leaves, pt16: torch.Tensor, pt8=None,
                     quant_chunks=None, pos=None):
    """The dense (L, B, S, ...) slot-cache view of the pool's arenas
    through the (B, C) page-table rows (page 0 = scratch): ``<leaf>16``
    bf16 through ``pt16`` and, in quant-resident mode, ``<leaf>8`` int8
    codes and ``<leaf>8s`` per-(token, kv-head) scales through ``pt8``,
    with ``quant_chunks`` (B, C) bool marking the chunks that live in
    the int8 arena -> ``quant_mask`` (1, B, S).  The view is a gathered
    COPY: writes into it do not reach the arenas (the entries scatter
    new tokens back explicitly)."""
    from repro_torch.kernels.paged import gather_pages
    cache = {"pos": pos}
    for n in leaves:
        cache[n] = gather_pages(arenas[n + "16"], pt16)
    if pt8 is not None:
        for n in leaves:
            cache[n + "_q"] = gather_pages(arenas[n + "8"], pt8)
            cache[n + "_scale"] = gather_pages(arenas[n + "8s"], pt8)
        B, C = quant_chunks.shape
        cs = arenas[leaves[0] + "16"].shape[2]
        qm = quant_chunks[:, :, None].expand(B, C, cs)
        # leading axis of 1: axis 1 stays the batch axis for every leaf
        cache["quant_mask"] = qm.reshape(B, C * cs)[None]
    return cache


# --------------------------------------------------------------------- #
# FFN
# --------------------------------------------------------------------- #
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# --------------------------------------------------------------------- #
# Cache update helper
# --------------------------------------------------------------------- #
def ring_update(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                ring: bool = False) -> torch.Tensor:
    """Write ``new`` (B,1,...) into ``cache`` (B,S,...) at seq index pos,
    IN PLACE (the JAX version returns a new array), and return cache.

    pos is a 0-d tensor (every row writes at one position: the serial
    working cache) or a (B,) tensor of per-row positions (batched
    decode: row b writes at its own offset).  With ring=True the index
    wraps (sliding-window cache)."""
    S = cache.shape[1]
    idx = pos % S if ring else pos
    if pos.dim():
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new[:, 0].to(cache.dtype)
    else:
        i = int(idx)
        cache[:, i:i + 1] = new.to(cache.dtype)
    return cache


def init_linear(generator: torch.Generator, shape, device,
                scale: float = 0.02, dtype=torch.bfloat16) -> torch.Tensor:
    """N(0, scale^2) weights drawn in fp32 from ``generator`` on
    ``device``, stored in ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)
