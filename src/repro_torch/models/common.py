"""Shared model primitives for dense serving (mirror of the JAX
package's models/common.py: the functions dense serving runs).

These stay plain PyTorch: the JAX package computes them outside any
Pallas kernel too.  Casts follow the reference one for one — scores
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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_pos: torch.Tensor,
                     window: int = 0, n_sinks: int = 0,
                     want_density: bool = False):
    """One-step attention.  q (B,1,H,hd); caches (B,S,KV,hd) bf16.
    cur_pos () or (B,): the new token attends to cache[:cur_pos].
    -> out (B,1,H,hd)[, per-key mass (B,S) fp32]."""
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
# Paged KV pool: dense cache view over page arenas
# --------------------------------------------------------------------- #
def paged_cache_view(arenas, leaves, pt16: torch.Tensor, pos=None):
    """The dense (L, B, S, ...) slot-cache view of the pool's bf16
    arenas through the (B, C) page-table rows ``pt16`` (page 0 =
    scratch).  The view is a gathered COPY: writes into it do not reach
    the arenas (the entries scatter new tokens back explicitly).  The
    quant-resident arenas (``pt8``) are not ported (ROADMAP.md)."""
    from repro_torch.kernels.paged import gather_pages
    cache = {"pos": pos}
    for n in leaves:
        cache[n] = gather_pages(arenas[n + "16"], pt16)
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
