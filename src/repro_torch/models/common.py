"""Shared model primitives of the served families (mirror of the JAX
package's models/common.py: the functions serving runs).

These stay plain PyTorch, as the JAX package computes them outside any
Pallas kernel too — except the attention of serving's extend and of
a full-sequence prefill (``extend_attention``, ``prefill_attention``:
the ``attn_density`` kernel), the forward of training's
``flash_attention`` (the kernel with its row stats; its backward is
plain products, as the reference's) and the attention of decode over
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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, n_heads: int, eps: float = 1e-5
                     ) -> torch.Tensor:
    """GroupNorm with one group per head over the last dim (RWKV ln_x)."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.to(torch.float32).reshape(*lead, n_heads, d // n_heads)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


# --------------------------------------------------------------------- #
# Activations, rounded as the reference's jax.nn ones
# --------------------------------------------------------------------- #
def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference computes it: 1 / (1 +
    exp(-x)) with every op rounded to x's dtype (bf16 here), where
    ``torch.sigmoid`` rounds once."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference computes it: x * sigmoid(x), every
    op rounded to x's dtype, where ``F.silu`` rounds once; on bf16 inputs
    the two differ by an ulp in about one value in twenty
    (``tests/test_torch_models.py``)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` as the reference computes it:
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) with the constants
    in x's dtype and every op rounded to it (x^3 as (x x) x), where
    ``F.gelu(approximate="tanh")`` rounds once; on bf16 inputs the two
    differ in about one value in thirty (``tests/test_torch_models.py``)."""
    c = torch.tensor(float(np.float32(np.sqrt(2 / np.pi))), dtype=x.dtype,
                     device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


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


def sinusoidal_positions(n_pos: int, d_model: int, device=None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (n_pos, d_model) fp32:
    [sin, cos] of pos * exp(-i ln(10000) / max(d/2 - 1, 1))."""
    half = d_model // 2
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(i * np.float32(-np.log(10000.0) / max(half - 1, 1)))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
# int8 without scales: the reference's dtype flow over a scale-less int8
# cache (the VLM's int8 cache), which JAX carries through its promotion
# --------------------------------------------------------------------- #
# keys a chunk of the exact int8 p.v product: 1024 products of at most
# 2^14 in magnitude sum to at most 2^24, which fp32 holds exactly
INT8_PV_KEYS = 1024


def to_int8(x: torch.Tensor) -> torch.Tensor:
    """A float tensor -> int8 as the reference's ``astype(jnp.int8)``
    converts it: toward zero, saturated at -128 and 127, NaN to 0.
    (``.to(torch.int8)`` of a value out of range is undefined: 300.0
    comes out 44 on the CPU.)"""
    x = torch.nan_to_num(x, nan=0.0).trunc()
    return x.clamp(-128, 127).to(torch.int8)


def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, a float into int8 converted by ``to_int8``."""
    if dtype == torch.int8 and x.is_floating_point():
        return to_int8(x)
    return x.to(dtype)


def pv_product(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,KV,G,Sq,Sk) fp32, v (B,Sk,KV,vd) -> (B,Sq,KV,G,vd) in v's
    dtype: the reference's ``einsum("bngqk,bknd->bqngd",
    p.astype(v.dtype), v)``.  Over an int8 v (no scales) p becomes int8
    (``to_int8``: 1 only where one key takes all the mass) and the
    product is XLA's int8 einsum: the exact sum wrapped mod 256, here
    fp32 products over INT8_PV_KEYS keys at a time summed in int64
    (torch has no int8 product on the card)."""
    if v.dtype != torch.int8:
        return torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)
    p8 = to_int8(p)
    acc = 0
    for k0 in range(0, v.shape[1], INT8_PV_KEYS):
        k1 = k0 + INT8_PV_KEYS
        acc = acc + torch.einsum(
            "bngqk,bknd->bqngd", p8[..., k0:k1].to(torch.float32),
            v[:, k0:k1].to(torch.float32)).to(torch.int64)
    return ((acc + 128) % 256 - 128).to(torch.int8)


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
    out = pv_product(p, v).reshape(B, Sq, H, v.shape[-1])
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
    """The attention of serving's extend (``DenseModel.recompute``,
    ``MLAModel.recompute``): queries q (B,Sq,H,Dqk) at positions
    ``q_pos`` (Sq,) over the whole cache, k (B,Sk,KV,Dqk) and v
    (B,Sk,KV,Dv), under ``causal_window_mask(q_pos, k) & (k <
    seq_len)`` (seq_len an int or a 0-d integer tensor on q's device,
    passed through to the kernel, which reads a tensor on the card), with the Eq.-1 key density; out (B,Sq,H,Dv).  It computes what
    ``gqa_attention`` computes under that mask (``form="served"``): on
    the card through the ``attn_density`` CUDA kernel, on the CPU
    through its plain version."""
    from repro_torch.kernels import ops as kops
    out, density = kops.attn_density(q, k, v, q_pos, seq_len, window,
                                     n_sinks, want_density, form="served")
    return AttnOut(out, density)


# the longest prefill the reference attends in one materialised product
# (``gqa_attention``); longer ones, and every windowed one, take its
# blocked flash forms
PREFILL_FULL_MAX_S = 2048


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, window: int = 0,
                      n_sinks: int = 0, want_density: bool = False,
                      form: Optional[str] = None) -> AttnOut:
    """Causal self-attention of a full-sequence prefill: q (B,S,H,Dqk),
    k (B,S,KV,Dqk), v (B,S,KV,Dv) at ``positions`` (S,) = arange(S),
    through ``attn_density`` (the CUDA kernel on the card, its plain
    version on the CPU) in the form of the reference branch it stands
    for (``dense.py:_layer_full``): the served form where the reference
    takes ``gqa_attention`` under ``causal_window_mask`` (S <=
    PREFILL_FULL_MAX_S and no window), else the flash form, where it
    takes ``flash_attention`` (no density) or
    ``blocked_causal_attention`` (with the density).  Those two round
    the unnormalised p to bf16 before PV, in blocks of 1024 keys; the
    flash form keeps PV in fp32, as the Pallas kernel does, so outputs
    differ at bf16 level (``tests/test_torch_prefill.py``).  A family
    whose reference picks its branch by another rule passes ``form``
    (``RGLRUModel``: served under its window up to PREFILL_FULL_MAX_S)."""
    from repro_torch.kernels import ops as kops
    S = q.shape[1]
    if form is None:
        form = "flash" if S > PREFILL_FULL_MAX_S or window else "served"
    out, density = kops.attn_density(q, k, v, positions, S, window, n_sinks,
                                     want_density, form=form)
    return AttnOut(out, density)


# --------------------------------------------------------------------- #
# Training attention: flash attention with a custom backward
# --------------------------------------------------------------------- #
def _flash_bwd(q, k, v, out, m, l, dout, q_offset: int, block: int,
               window: int, n_sinks: int):
    """The reference's ``_flash_vjp_bwd`` op for op: blocks of ``block``
    keys, scores recomputed in fp32 from the saved (q, k, v, out, m, l),
    delta = rowsum(dout * out), every product fp32.  The reference pads
    the last block with invalid keys; here it is just shorter (a padded
    key's k and v are 0, so it adds nothing to dq and its dk, dv rows
    are dropped).  -> (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    vd = v.shape[-1]
    f32 = torch.float32
    qg = q.reshape(B, Sq, KV, G, hd).to(f32)
    do = dout.reshape(B, Sq, KV, G, vd).to(f32)
    og = out.reshape(B, Sq, KV, G, vd).to(f32)
    scale = 1.0 / np.sqrt(hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    delta = torch.sum(do * og, dim=-1).permute(0, 2, 3, 1)   # (B,KV,G,Sq)
    lsafe = torch.clamp_min(l, 1e-30)
    dq = torch.zeros((B, Sq, KV, G, hd), dtype=f32, device=q.device)
    dks, dvs = [], []
    for lo in range(0, Sk, block):
        hi = min(lo + block, Sk)
        kblk, vblk = k[:, lo:hi].to(f32), v[:, lo:hi].to(f32)
        k_pos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("bqngd,bknd->bngqk", qg, kblk) * scale
        valid = causal_window_mask(q_pos, k_pos, window, n_sinks)
        s = torch.where(valid[None, None, None], s, NEG_INF)
        p = torch.exp(s - m[..., None]) / lsafe[..., None]  # (B,n,g,q,k)
        dvs.append(torch.einsum("bngqk,bqngd->bknd", p, do))
        dp = torch.einsum("bqngd,bknd->bngqk", do, vblk)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bngqk,bknd->bqngd", ds, kblk)
        dks.append(torch.einsum("bngqk,bqngd->bknd", ds, qg))
    return (dq.reshape(B, Sq, H, hd).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` ``custom_vjp`` (its only custom
    gradient).  Forward: ``attn_density``'s flash form with the row stats
    (on the card ``csrc/attn_flash.cu``'s forward at head dims 64 and
    128, the tile kernel ``attn_density_stats_kernel`` at others; on the
    CPU its plain version), saving (q, k, v, out, m, l) as the
    reference's ``_flash_vjp_fwd`` does.  Backward: ``_flash_bwd``, plain
    fp32 products, as the reference computes its backward in jnp outside
    any Pallas kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, block, window, n_sinks):
        from repro_torch.kernels import ops as kops
        q_pos = torch.arange(q_offset, q_offset + q.shape[1],
                             device=q.device)
        out, _, m, l = kops.attn_density(q, k, v, q_pos, k.shape[1], window,
                                         n_sinks, want_density=False,
                                         form="flash", return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.cfg = (q_offset, block, window, n_sinks)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, dout, *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, block: int = 1024, window: int = 0,
                    n_sinks: int = 0) -> torch.Tensor:
    """Causal attention of q (B,Sq,H,Dqk) at positions q_offset + i over
    k (B,Sk,KV,Dqk) / v (B,Sk,KV,Dv), with a window and sinks, and the
    reference's flash backward (``block`` keys at a time).  The forward
    is the flash form (p unrounded, PV in fp32 on the CPU; on the card
    the kernel's bf16 PV operand): out differs from the reference's
    forward, which rounds p to bf16 before PV, by at most a bf16 ulp or
    two of its largest value.  -> out (B,Sq,H,Dv) in q's dtype."""
    return _FlashAttention.apply(q, k, v, q_offset, block, window, n_sinks)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, window: int = 0,
                    n_sinks: int = 0) -> torch.Tensor:
    """Causal self-attention of a training forward, by the reference's
    rule (``dense.py:_layer_full`` with no density): ``flash_attention``
    where S > PREFILL_FULL_MAX_S or there is a window, else
    ``gqa_attention`` under ``causal_window_mask``, differentiated by
    autograd (plain products, as the reference's jnp).  -> out."""
    if q.shape[1] > PREFILL_FULL_MAX_S or window:
        return flash_attention(q, k, v, 0, 1024, window, n_sinks)
    mask = causal_window_mask(positions, positions, window, n_sinks)
    return gqa_attention(q, k, v, mask).out


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
    reference computes here), the ``decode_qattn`` kernel on the card.
    An int8 cache without scales gives an int8 out (``pv_product``), as
    the reference's promotion does."""
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
    out = pv_product(p, v_cache).reshape(B, 1, H, v_cache.shape[-1])
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
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


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
    wraps (sliding-window cache).  A float ``new`` goes into an int8
    cache as the reference converts it (``cast_to``).  The index stays
    on the device (a 0-d one as a one-element index of ``index_copy_``),
    so no host read of pos keeps a decode out of a CUDA graph."""
    S = cache.shape[1]
    idx = pos % S if ring else pos
    if pos.dim():
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = cast_to(new[:, 0], cache.dtype)
    else:
        cache.index_copy_(1, idx.reshape(1).to(torch.int64),
                          cast_to(new, cache.dtype))
    return cache


def unstack(stack: dict) -> list:
    """A (nested) dict of tensors stacked on axis 0 -> one dict per entry
    of the stack, through ``torch.unbind``: in training each layer's
    slices come from one op, whose backward stacks the layers' gradients
    in one copy (``layer_at`` would add a full-size zero tensor per
    layer)."""
    cols = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in stack.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def checkpointed(fn, *args):
    """``fn(*args)`` rematerialised in the backward
    (``torch.utils.checkpoint``, non-reentrant): the reference's
    ``jax.checkpoint``.  Only ``args`` are kept for the backward."""
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False)


def layer_at(stack: dict, i: int) -> dict:
    """Layer ``i`` of a (nested) dict of tensors stacked on axis 0: the
    slice the reference's layer ``scan`` hands its body."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def init_linear(generator: torch.Generator, shape, device,
                scale: float = 0.02, dtype=torch.bfloat16) -> torch.Tensor:
    """N(0, scale^2) weights drawn in fp32 from ``generator`` on
    ``device``, stored in ``dtype``."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_stacked(generator: torch.Generator, n: int, shapes, device
                 ) -> dict:
    """{name: (n, *shape) bf16} for each name -> shape of ``shapes``,
    drawn one entry of the stack at a time (``init_linear``), so the
    fp32 draw of a full-width weight never sits beside the stack."""
    out = {}
    for name, shp in shapes.items():
        w = torch.empty((n, *shp), dtype=torch.bfloat16, device=device)
        for i in range(n):
            w[i] = init_linear(generator, shp, device)
        out[name] = w
    return out
