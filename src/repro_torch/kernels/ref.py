"""Plain PyTorch versions of the port's kernels (the semantics of record):
the chunk codec, the decode-grid quantizer, extend attention with the
Eq.-1 density (``attn_density``), decode attention over a mixed
(``decode_mqattn``) or an all-int8 (``decode_qattn``) cache, and the
pipelined restore's gate (``feed_gate_plain``).

The codec mirrors the JAX package's ``kernels/ref.py`` (``qmax_for``,
``quantize_ref``, ``dequantize_ref``) operation for operation, so the
two agree bit for bit in fp32 and bf16:

  * canonical layout (T, F): T chunk tokens, F flattened channels
    (layers x kv-heads x head-dim);
  * symmetric per-channel scales over the token axis:
    ``s_f = max_t|x| * fl32(1/qmax)``, floored at 1e-8.  The product
    with the fp32 reciprocal is what the reference computes when it
    serves: its codec runs under ``jax.jit``, where XLA rewrites the
    division by the constant qmax (the un-jitted oracle divides, and
    differs from its own jitted form by 1 ulp in some scales);
  * codes ``round`` half-to-even (``torch.round``), clipped to
    ``[-qmax, qmax]`` with ``qmax = 2^(bits-1) - 1``;
  * 4- and 2-bit codes are packed along T, token ``r*per + j`` in bit
    group ``j`` of byte row ``r``.

The CUDA kernels (``kernels/chunk_quant.py``, ``kernels/attn_density.py``,
``kernels/decode_mqattn.py``, ``kernels/decode_qattn.py``,
``kernels/feed_gate.py``) are held
against these functions; ``kernels/ops.py`` sends CPU tensors here.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

# the plain gate's pause between two reads of its word, seconds
GATE_POLL_S = 50e-6


def qmax_for(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def quantize_ref(x: torch.Tensor, bits: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, F) float -> (packed int8 (T*bits//8, F), scales fp32 (F,))."""
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, not {bits}")
    T, F = x.shape
    qm = qmax_for(bits)
    xf = x.to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(qm), device=x.device)
    scale = xf.abs().amax(dim=0) * inv                        # (F,)
    scale = torch.clamp_min(scale, 1e-8)
    codes = torch.clamp(torch.round(xf / scale), -qm, qm).to(torch.int32)
    if bits == 8:
        return codes.to(torch.int8), scale
    per = 8 // bits                                           # codes per byte
    if T % per:
        raise ValueError(f"T={T} is not a multiple of {per} at {bits} bits")
    u = (codes & ((1 << bits) - 1)).reshape(T // per, per, F)  # two's compl.
    packed = torch.zeros((T // per, F), dtype=torch.int32, device=x.device)
    for j in range(per):
        packed |= u[:, j] << (bits * j)
    return packed.to(torch.uint8).view(torch.int8), scale


def dequantize_ref(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                   T: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_ref`` -> (T, F) in ``dtype``."""
    if bits not in (8, 4, 2):
        raise ValueError(f"bits must be 8, 4 or 2, not {bits}")
    if bits == 8:
        return (packed.to(torch.float32) * scale).to(dtype)
    per = 8 // bits
    rows, F = packed.shape
    if rows * per != T:
        raise ValueError(f"{rows} packed rows do not hold {T} tokens")
    # read the bytes as UNSIGNED: >> on int8 is arithmetic in torch
    u = packed.view(torch.uint8).to(torch.int32)
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    outs = []
    for j in range(per):
        c = (u >> (bits * j)) & mask
        outs.append(torch.where(c >= half, c - (1 << bits), c))  # sign-extend
    codes = torch.stack(outs, dim=1).reshape(T, F)
    return (codes.to(torch.float32) * scale).to(dtype)


# --------------------------------------------------------------------- #
# decode-grid quantization (per-(token, kv-head) symmetric scales)
#
# The chunk codec above is the STORAGE grid (per-channel scales over the
# token axis).  Quant-resident decode attends the DECODE grid: one scale
# per (token, kv-head), shared across head_dim.  As with the storage
# codec, the scale is ``max|x| * fl32(1/127)``: the reference runs its
# oracle (which divides by 127.0) under ``jax.jit``, where XLA rewrites
# the division by the constant into that product, and the port computes
# what the reference serves.
# --------------------------------------------------------------------- #
def quantize_token_head_ref(x: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., hd) float -> (codes int8 (..., hd), scales fp32 (...,))."""
    xf = x.to(torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(127), device=x.device)
    scale = torch.clamp_min(xf.abs().amax(dim=-1) * inv, 1e-8)
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_token_head_ref(codes: torch.Tensor, scale: torch.Tensor,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_token_head_ref`` -> (..., hd) in ``dtype``."""
    return (codes.to(torch.float32) * scale[..., None]).to(dtype)


# --------------------------------------------------------------------- #
# decode_mqattn: one-step attention over a MIXED cache (bf16 recent
# window + int8 quant-resident segments, fused dequant per position)
# --------------------------------------------------------------------- #
NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _mixed_kv(k, v, k_q, v_q, k_scale, v_scale, quant_mask):
    """The attended bf16 K/V: ``(code * scale) -> bf16`` at quant
    positions, the bf16 cache elsewhere (the value a full dequant would
    have materialized, so mixed decode equals full-dequant decode)."""
    m = quant_mask[:, :, None, None]
    kd = dequantize_token_head_ref(k_q, k_scale, k.dtype)
    vd = dequantize_token_head_ref(v_q, v_scale, v.dtype)
    return torch.where(m, kd, k), torch.where(m, vd, v)


def _valid_keys(n_valid, B: int, S: int, window: int, n_sinks: int,
                device) -> torch.Tensor:
    """(B, S) bool: key j of row b is attended."""
    k_pos = torch.arange(S, device=device)
    nv = torch.as_tensor(n_valid, device=device).reshape(-1).expand(B)
    valid = k_pos[None, :] < nv[:, None]
    if window > 0:
        valid = valid & ((k_pos[None, :] >= nv[:, None] - window)
                         | (k_pos[None, :] < n_sinks))
    return valid


def decode_mqattn_ref(q, k, v, k_q, v_q, k_scale, v_scale, quant_mask,
                      n_valid, window: int = 0, n_sinks: int = 0
                      ) -> torch.Tensor:
    """Mirror of the reference's oracle (``decode_mqattn_ref``): q (B,H,hd);
    k/v (B,S,KV,hd) bf16; k_q/v_q int8; scales (B,S,KV) fp32; quant_mask
    (B,S) bool; n_valid () or (B,).  Softmax in fp32 over -inf-masked
    scores, PV in fp32.  -> (B,H,hd) in q.dtype."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    kb, vb = _mixed_kv(k, v, k_q, v_q, k_scale, v_scale, quant_mask)
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bngd,bknd->bngk", qg, kb.to(torch.float32)) \
        / np.sqrt(hd)
    valid = _valid_keys(n_valid, B, S, window, n_sinks, q.device)
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", p, vb.to(torch.float32))
    return out.reshape(B, H, hd).to(q.dtype)


def decode_mqattn_plain(q, k, v, k_q, v_q, k_scale, v_scale, quant_mask,
                        n_valid, window: int = 0, n_sinks: int = 0,
                        want_mass: bool = False, select: bool = False):
    """Plain version of the CUDA kernel (``kernels/decode_mqattn.py``),
    both of its forms.  Scores fp32 times 1/sqrt(hd), invalid keys at the
    finite NEG_INF; p = exp(s - m), l = sum p.

      * fused  (``select=False``): out = bf16(sum_j p_j v_j / max(l,
        1e-30)), PV in fp32 — the reference's Pallas kernel and its
        blocked CPU mirror;
      * select (``select=True``): p / l rounded to bf16 times the bf16
        values with fp32 accumulation — the reference's plain
        ``dequant_select`` + ``decode_attention`` path.

    mass (B, S) = sum over heads of p / max(l, 1e-30) in fp32, over H.
    -> out (B,H,hd) bf16 [, mass]."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    kb, vb = _mixed_kv(k, v, k_q, v_q, k_scale, v_scale, quant_mask)
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bngd,bknd->bngk", qg, kb.to(torch.float32)) \
        * (1.0 / np.sqrt(hd))
    valid = _valid_keys(n_valid, B, S, window, n_sinks, q.device)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    pn = p / l
    if select:
        out = torch.einsum("bngk,bknd->bngd", pn.to(vb.dtype), vb)
    else:
        out = torch.einsum("bngk,bknd->bngd", p,
                           vb.to(torch.float32)) / l
    out = out.reshape(B, H, hd).to(torch.bfloat16)
    if want_mass:
        return out, (pn.sum(dim=(1, 2)) / H).to(torch.float32)
    return out


# --------------------------------------------------------------------- #
# decode_qattn: one-step attention over an ALL-int8 cache
# --------------------------------------------------------------------- #
def decode_qattn_plain(q, k_q, v_q, k_scale, v_scale, n_valid,
                       window: int = 0, n_sinks: int = 0,
                       want_mass: bool = False, select: bool = False):
    """Plain version of the CUDA kernel (``kernels/decode_qattn.py``),
    both of its forms.  q (B,H,hd) bf16 or fp32; k_q/v_q (B,S,KV,hd)
    int8; scales (B,S,KV) fp32; n_valid () or (B,).  Scores fp32 times
    1/sqrt(hd), invalid keys at the finite NEG_INF; p = exp(s - m),
    l = sum p.

      * fused  (``select=False``): K/V = code * scale kept in fp32,
        out = sum_j p_j v_j / max(l, 1e-30), PV in fp32 — the
        reference's Pallas ``decode_qattn`` and its oracle;
      * select (``select=True``): K/V = code * scale rounded to q's
        dtype, p / l rounded to that dtype before PV — the reference's
        jnp ``decode_attention`` with scales (the all-int8 cache's
        ``decode_step``).

    mass (B, S) = sum over heads of p / max(l, 1e-30) in fp32, over H.
    -> out (B,H,hd) in q's dtype [, mass]."""
    B, H, hd = q.shape
    S, KV = k_q.shape[1], k_q.shape[2]
    kd = k_q.to(torch.float32) * k_scale[..., None]
    vd = v_q.to(torch.float32) * v_scale[..., None]
    if select:
        kd, vd = kd.to(q.dtype), vd.to(q.dtype)
    qg = q.reshape(B, KV, H // KV, hd).to(torch.float32)
    s = torch.einsum("bngd,bknd->bngk", qg, kd.to(torch.float32)) \
        * (1.0 / np.sqrt(hd))
    valid = _valid_keys(n_valid, B, S, window, n_sinks, q.device)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    pn = p / l
    if select:
        out = torch.einsum("bngk,bknd->bngd", pn.to(vd.dtype), vd)
    else:
        out = torch.einsum("bngk,bknd->bngd", p, vd) / l
    out = out.reshape(B, H, hd).to(q.dtype)
    if want_mass:
        return out, (pn.sum(dim=(1, 2)) / H).to(torch.float32)
    return out


# --------------------------------------------------------------------- #
# attn_density: extend attention with the Eq.-1 per-key density
# --------------------------------------------------------------------- #
def extend_visibility(q_pos: torch.Tensor, Sk: int, seq_len,
                      window: int = 0, n_sinks: int = 0) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible to the query at q_pos[i] when
    j <= q_pos[i], j < seq_len and, with a window, j > q_pos[i] - window
    or j < n_sinks (``causal_window_mask`` & ``k < seq_len``).  seq_len
    is an int or a 0-d integer tensor (compared on the device)."""
    k = torch.arange(Sk, device=q_pos.device)[None, :]
    q = q_pos[:, None]
    m = k <= q
    if window > 0:
        m = m & ((k > (q - window)) | (k < n_sinks))
    return m & (k < seq_len)


def attn_density_plain(q, k, v, q_pos=None, seq_len=None, window: int = 0,
                       n_sinks: int = 0, want_density: bool = True,
                       form: str = "served", return_stats: bool = False):
    """Plain version of the CUDA kernel (``kernels/attn_density.py``),
    both of its forms.  q (B,Sq,H,Dqk); k (B,Sk,KV,Dqk); v (B,Sk,KV,Dv)
    (Dv may differ from Dqk, as in MLA's recompute), bf16 or fp32;
    q_pos (Sq,) int (default ``arange(Sq)``); seq_len an int or a 0-d
    integer tensor (default Sk).  Visibility is ``extend_visibility``; invisible scores take the
    finite NEG_INF, so a query with no visible key is uniform over all
    Sk keys.  Scores fp32 times 1/sqrt(Dqk).

      * ``form="served"``: what serving's extend computes
        (``models/common.gqa_attention``, op for op): softmax in fp32,
        p rounded to v's dtype before PV, density = sum p over heads and
        queries / (H * max(1, visible queries of the key)) — a query
        with no visible key counts its uniform p;
      * ``form="flash"``: the reference's Pallas ``attn_density``
        (``_fwd`` + ``_mass``): p = exp(s - m) in fp32, PV in fp32,
        out = acc / max(l, 1e-30); the mass sums p / max(l, 1e-30) over
        visible (query, key) pairs only.

    -> (out (B,Sq,H,Dv) in q's dtype, density (B,Sk) fp32 | None); with
    ``return_stats`` (the flash form without the density, as the
    kernel) also m (B,KV,G,Sq) and max(l, 1e-30) (B,KV,G,Sq), fp32."""
    if form not in ("served", "flash"):
        raise ValueError(f"form must be 'served' or 'flash', not {form!r}")
    if return_stats and (form != "flash" or want_density):
        raise ValueError("attn_density gives row stats in the flash form "
                         "without the density only")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if seq_len is None:
        seq_len = Sk
    mask = extend_visibility(q_pos.to(q.device), Sk, seq_len, window,
                             n_sinks)
    maskb = mask[None]                                        # (1, Sq, Sk)
    qg = q.reshape(B, Sq, KV, G, hd)
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqngd,bknd->bngqk", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(maskb[:, None, None], s, NEG_INF)
    if form == "served":
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)
        pm = p
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        o = torch.einsum("bngqk,bknd->bngqd", p, v.to(torch.float32)) / l
        out = o.permute(0, 3, 1, 2, 4)
        pm = torch.where(maskb[:, None, None], p / l, 0.0)
    out = out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
    if return_stats:
        return out, None, m[..., 0], l[..., 0]
    if not want_density:
        return out, None
    mass = torch.sum(pm, dim=(1, 2, 3))                           # (B, Sk)
    nvalid = torch.clamp_min(torch.sum(maskb, dim=1), 1)          # (1, Sk)
    return out, (mass / (H * nvalid)).to(torch.float32)


def attn_flash_plain(q, k, v, q_pos=None, seq_len=None, window: int = 0,
                     n_sinks: int = 0, want_density: bool = True,
                     return_stats: bool = False, q_chunk: int = 0):
    """Plain version of ``csrc/attn_flash.cu`` (``attn_density``'s flash
    form at Dqk = Dv = 64 or 128): its two-pass arithmetic on the
    visibility and scores of ``attn_density_plain``.

      * pass 1, the rows: m = max_j s, p = exp(s - m), l = max(sum p,
        1e-30); out = (bf16(p) V) / l in fp32, then q's dtype (the
        kernel's PV takes p rounded to bf16, its tensor cores' operand);
      * pass 2, key-major: for each key, the kv-head's sum over its
        group's rows of exp(s - m) / l over visible (query, key) pairs,
        from pass 1's m and l; the kv-heads' partials summed in order,
        over H * max(1, visible queries of the key).

    ``q_chunk`` > 0 takes the queries that many at a time (a row's m
    and l are its own, so only the order of the mass sums changes): the
    scores of a chunk, not of all Sq rows, are held at once.
    -> (out (B,Sq,H,D), density (B,Sk) fp32 | None); with
    ``return_stats`` also m and l, (B,KV,G,Sq) fp32 each."""
    if return_stats and want_density:
        raise ValueError("attn_density gives row stats in the flash form "
                         "without the density only")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if q_pos is None:
        q_pos = torch.arange(Sq, device=q.device)
    if seq_len is None:
        seq_len = Sk
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    step = q_chunk if q_chunk > 0 else Sq
    outs, ms, ls = [], [], []
    part = torch.zeros((B, KV, Sk), dtype=torch.float32, device=q.device)
    count = torch.zeros((Sk,), dtype=torch.int64, device=q.device)
    for a in range(0, Sq, step):
        mask = extend_visibility(q_pos[a:a + step].to(q.device), Sk,
                                 int(seq_len), window, n_sinks)[None, None,
                                                                None]
        qg = q[:, a:a + step].reshape(B, -1, KV, G, hd).to(torch.float32)

        def scores():
            s = torch.einsum("bqngd,bknd->bngqk", qg, kf)
            return torch.where(mask, s * (1.0 / np.sqrt(hd)), NEG_INF)

        s = scores()                                       # pass 1
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
        o = torch.einsum("bngqk,bknd->bngqd", p.to(torch.bfloat16).float(),
                         vf) / l
        del s, p
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, -1, H, v.shape[-1]))
        ms.append(m[..., 0])
        ls.append(l[..., 0])
        if want_density:                                  # pass 2
            pn = torch.where(mask, torch.exp(scores() - m) / l, 0.0)
            part += pn.sum(dim=(2, 3))
            count += mask[0, 0, 0].sum(dim=0)
            del pn
    out = torch.cat(outs, dim=1).to(q.dtype)
    if return_stats:
        return out, None, torch.cat(ms, dim=-1), torch.cat(ls, dim=-1)
    if not want_density:
        return out, None
    mass = part[:, 0]
    for kv in range(1, KV):
        mass = mass + part[:, kv]
    return out, (mass / (H * torch.clamp_min(count, 1))).to(torch.float32)


def feed_gate_plain(flags: torch.Tensor, layer: int, gen, deadline_ns,
                    status: torch.Tensor, wait_ns: torch.Tensor) -> None:
    """``csrc/feed_gate.cu``'s gate on the host: unless ``status`` is
    already set, read ``flags[layer]`` (a word the restore's feed thread
    writes) every ``GATE_POLL_S`` until it equals ``gen`` (its layer's
    rows have arrived), ``-gen`` (the feed failed: ``status`` 1) or
    ``deadline_ns`` nanoseconds have passed (``status`` 2); the time
    waited is added to ``wait_ns[layer]``.  gen and deadline_ns are ints
    or 0-d tensors; status (1,) int32 and wait_ns (L,) int64 are written
    in place.  The sleeps release the GIL, which the feed thread
    needs."""
    if int(status[0]) != 0:
        return
    want, budget = int(gen), int(deadline_ns)
    t0 = time.perf_counter_ns()
    code = 0
    while True:
        word = int(flags[layer])
        if word == want:
            break
        if word == -want:
            code = 1
            break
        if time.perf_counter_ns() - t0 > budget:
            code = 2
            break
        time.sleep(GATE_POLL_S)
    wait_ns[layer] += time.perf_counter_ns() - t0
    if code:
        status[0] = code
