#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the quickest proof that the
port builds, is right, and serves on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure raises and the script exits non-zero with no
result line):

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             (one nvcc per source, all started at once) and print the
             card's name and power limit;
2. kernels — hold each kernel against its plain PyTorch version on the
             card: the chunk codec bit for bit (codes, scales,
             dequantized values) over bits {8, 4, 2}, bf16/fp32 inputs
             and four shapes, the quantize kernel also with a second
             leaf in one launch; decode_mqattn in both forms, with and
             without the mass, over five shapes, three quant shares and
             two (window, sinks) settings, and the edge cases of its
             split plan (MQ_EDGE); attn_density in both forms, with and
             without the density, at serving's extend (seq_len 48 and
             200, bucket pads, G 1/4/8), a long append, the Pallas
             kernel's own setting and the edge cases of its tile plan
             (ragged tiles, hd 16/20/80, G 64), causal, windowed and
             with rows that see no key; decode_qattn in both forms, with
             and without the mass, at two shapes and two (window, sinks)
             settings and over MQ_EDGE with every position quant.  Time
             each kernel (per launch of its kernels, by name; a kernel
             the profiler does not find raises), its plain version, its
             bound and (for the attention kernels) the library's
             attention at the shapes the main path gives them; the
             decode kernels and their library rows also with a cold L2
             (a 128 MiB buffer written before every call, its kernels
             left out), and a chunk's two leaves quantized in one launch
             beside two launches;
3. serve   — llama2-7b at full width and depth (random bf16 weights from
             a seeded torch.Generator, built once) behind LLMService
             (policy llms, paged pool, decode_batch 1): 4 contexts x 3
             rounds of callLLM under a budget of about two contexts' raw
             KV, so compression, AoT swap-out, LCTRU eviction and disk
             restores all fire.  Run twice with the bf16 pool and twice
             with quant_resident=True (8-bit chunks admitted into int8
             QUANT pages and attended in place by decode_mqattn).  Every
             prefill-append attends through attn_density (one launch per
             layer).  The kernel launch counts are zeroed just before
             each run and read just after; each rerun from the same seed
             must give identical tokens and bit plans; quantize
             launches per chunk and per switch-out are reported.  Then
             the same model decodes over an all-int8 cache (decode_qattn,
             one launch per layer and token), twice, with identical
             tokens and masses, one token of the first run profiled;
4. check   — the reduced llama2-7b served teacher-forced on the card
             agrees with the same port on the CPU (plain PyTorch), over
             the bf16 page view, a mixed (quant-resident) view and an
             all-int8 decode cache.

The last lines are the kernel record ({"kernels": [...]}), the card's
``nvidia-smi`` name and power limit, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time

SEED = 0
SERVE_SHAPE = (16, 32 * 32 * 128)          # one chunk leaf of llama2-7b
CHECK_SHAPES = [SERVE_SHAPE, (16, 384), (32, 100), (4, 64)]
# decode_mqattn cases (B, S, H, KV, hd): llama2-7b's serving shape at
# batch 1 and 4, a long GQA cache, a ragged tail, a tiny GQA case
MQ_SHAPES = [(1, 512, 32, 32, 128), (4, 512, 32, 32, 128),
             (2, 4096, 32, 8, 128), (3, 4100, 4, 4, 16), (1, 16, 4, 2, 16)]
MQ_TIMED = [(1, 512, 32, 32, 128, 0.5), (1, 4096, 32, 32, 128, 0.5)]
# decode_mqattn edge cases of the split plan (B, S, H, KV, hd, n_valid per
# row, (window, sinks) settings): n_valid inside a split; splits wholly
# between the sinks and the window; rows of one batch ending in different
# splits; one split; hd not a multiple of 8 (element-wise loads)
MQ_EDGE = [((1, 512, 32, 32, 128), [100], ((0, 0), (256, 4))),
           ((1, 512, 32, 32, 128), [512], ((128, 4), (64, 0))),
           ((4, 512, 32, 32, 128), [512, 1, 200, 77], ((0, 0), (128, 4))),
           ((1, 16, 4, 2, 16), [16], ((0, 0), (8, 2))),
           ((2, 300, 8, 2, 20), [300, 131], ((0, 0), (64, 3)))]
MQ_OUT_TOL = 2 ** -7                       # x max|out_plain|: two bf16 ulps
PROFILED_ROUND = 81                        # 4th decode round of the last call
MQ_MASS_TOL = 1e-6
# attn_density: out as above; the density (fp32 sums of probabilities in
# another order) within 1e-5 of the largest density
AD_DENS_TOL = 1e-5
AD_SERVE = dict(S=512, H=32, hd=128, bucket=64, pad=511)
# the kernels' names, as the profiler reports them
AD_KERNELS = ("attn_density_tc_kernel", "attn_density_reduce_kernel")
MQ_KERNELS = ("mq_split_kernel", "mq_split_pv_kernel", "mq_combine_kernel")
DQ_KERNELS = ("dq_split_kernel", "dq_split_pv_kernel", "dq_combine_kernel")
QUANT_KERNEL = "quant_leaves_kernel<"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores
BF16_OPS_PER_S = 989e12                    # H100 SXM, bf16 tensor cores
INT8_DECODE = dict(S=512, prompt=32, new=32)


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# 1. build
# --------------------------------------------------------------------- #
def _kernel_label(mangled: str) -> str:
    """A mangled kernel name's own name and template arguments, e.g.
    ``mq_split_kernelILi1ELb0E`` (the name follows its length)."""
    end = mangled.find("_kernel")
    if end < 0:
        return mangled[:72]
    end += len("_kernel")
    for start in range(end - 1, 0, -1):
        for k in (1, 2, 3):
            d = mangled[max(0, start - k):start]
            if d.isdigit() and int(d) == end - start:
                args = re.match(r"I\w*?E(?=E)", mangled[end:])
                return mangled[start:end] + (args.group(0) if args else "")
    return mangled[:72]


def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(build.SOURCES)
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        entry = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # the mangled name, e.g. ..._cu_95efd00315mq_split_kernelILi1E
                # ELb0EEEvN...: the kernel's name and template arguments
                entry = _kernel_label(line.split("'")[1] if "'" in line
                                      else line)
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {entry}: {line.strip()}")
    smi = nvidia_smi_line()
    log(f"[build] card: {smi}")
    return smi


# --------------------------------------------------------------------- #
# 2. kernels vs plain versions
# --------------------------------------------------------------------- #
def _time_ms(fn, iters=200, warmup=20):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


_FLUSH = {}


def _host_ms_pair(a, b, iters=40, warmup=5):
    """Median host time of ``a`` and of ``b``, run in turns (a, b, b, a,
    ...) so that both see the same host; each must end synchronised."""
    for _ in range(warmup):
        a()
        b()
    times = {a: [], b: []}
    for i in range(iters):
        for fn in ((a, b) if i % 2 == 0 else (b, a)):
            t0 = time.perf_counter()
            fn()
            times[fn].append((time.perf_counter() - t0) * 1e3)
    return tuple(sorted(times[f])[iters // 2] for f in (a, b))


def _l2_flush():
    """(flush, its kernels): a callable that writes 128 MiB (more than
    the card's 50 MB L2), so that the next call finds none of its inputs
    in the L2, and the names the profiler gives the flush's kernels,
    learnt once over ten flushes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not _FLUSH:
        buf = torch.empty(16 * 2**20, dtype=torch.int64, device="cuda")
        flush = lambda: buf.fill_(7)                     # noqa: E731
        flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                flush()
            torch.cuda.synchronize()
        keys = {ev.key for ev in prof.key_averages() if _device_us(ev) > 0}
        if not keys:
            raise AssertionError("the profiler recorded no kernel of the "
                                 "L2 flush")
        _FLUSH.update(fn=flush, keys=keys)
    return _FLUSH["fn"], _FLUSH["keys"]


def _device_us(ev) -> float:
    return getattr(ev, "device_time_total",
                   getattr(ev, "cuda_time_total", 0.0))


def _device_ms(fn, match=None, iters=50, by_kernel=None, flush=None):
    """Device time per call from the profiler's CUDA kernel records: the
    kernels whose name contains ``match`` (a string or a tuple of them;
    all kernels when None), summed and divided by ``iters``.  Raises when
    ``match`` is given and no kernel matches it (a kernel renamed without
    its match, or a profiler that records no device time); None when
    ``match`` is None and the profiler records no device time.  With a
    dict ``by_kernel``, also each counted kernel's time per call, by
    name.  With ``flush`` (``_l2_flush()``), the flush runs before every
    call and its own kernels are left out: the call's time with a cold
    L2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush, skip = flush if flush is not None else (None, set())
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    subs = (match,) if isinstance(match, str) else match
    for ev in prof.key_averages():
        if ev.key in skip:
            continue
        if subs is None or any(m in ev.key for m in subs):
            us = _device_us(ev)
            total_us += us
            if by_kernel is not None and us > 0:
                if subs is None:
                    name = ev.key[:96]
                else:
                    m = next(m for m in subs if m in ev.key)
                    name = ev.key[ev.key.index(m):].split("(")[0]
                by_kernel[name] = us / iters / 1e3
    if subs is not None and total_us == 0:
        raise AssertionError(f"the profiler recorded no device time for a "
                             f"kernel matching {subs}")
    return total_us / iters / 1e3 if total_us > 0 else None


def _profile_round(fn):
    """Run ``fn`` once under the profiler (CUDA activity only): its host
    wall time, the device time of its kernels by category, and the
    device's idle share of the wall time (profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats, n_kernels = {}, 0
    for ev in prof.key_averages():
        name = ev.key.lower()
        cat = ("decode_mqattn" if any(t in name for t in MQ_KERNELS)
               else "decode_qattn" if any(t in name for t in DQ_KERNELS)
               else "attn_density" if any(t in name for t in AD_KERNELS)
               else "indexing (page gather, scatter)" if "index" in name
               else "matmul" if any(t in name for t in
                                    ("gemm", "gemv", "xmma", "cutlass"))
               else "other")
        cats[cat] = cats.get(cat, 0.0) + _device_us(ev) / 1e3
        n_kernels += ev.count
    busy = sum(cats.values())
    return out, {"wall_ms": wall_ms, "device_ms": busy,
                 "idle_share": 1.0 - busy / wall_ms, "kernels": n_kernels,
                 "by_category_ms": cats}


def _codec_bound_ms(T, F, bits, in_bytes):
    """Least time for one launch: every input byte read once and every
    output byte written once at the HBM rate, or ~8 fp32 operations per
    element at the fp32 rate, whichever is larger."""
    packed = T * bits // 8 * F + 4 * F           # codes + scales
    dense = T * F * in_bytes
    nbytes = dense + packed
    ops = 8 * T * F
    bound_s = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S \
        else "operations"
    return bound_s * 1e3, by


def kernel_phase():
    import torch
    from repro_torch.kernels import chunk_quant, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    n_cases = 0
    for shape in CHECK_SHAPES:
        T, F = shape
        for dt in (torch.bfloat16, torch.float32):
            for bits in (8, 4, 2):
                x = (torch.randn(shape, generator=g, device=dev) * 3).to(dt)
                x[:, 0] = 0                      # the 1e-8 scale floor
                # a second leaf of the chunk, of another F (ragged when
                # x's F is a multiple of the 16-byte vectors)
                y = (torch.randn((T, 100 if F % 8 == 0 else 384),
                                 generator=g, device=dev) * 3).to(dt)
                p_k, s_k = chunk_quant.quantize(x, bits)
                p_r, s_r = ref.quantize_ref(x, bits)
                _, leaves = chunk_quant.quantize_leaves([x, y], bits)
                torch.cuda.synchronize()
                for label, got, want in (
                        ("quantize", (p_k, s_k), (p_r, s_r)),
                        ("one launch of two leaves, leaf 1", leaves[0],
                         (p_r, s_r)),
                        ("one launch of two leaves, leaf 2", leaves[1],
                         ref.quantize_ref(y, bits))):
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        bad = int((got[0] != want[0]).sum()) + int(
                            (got[1] != want[1]).sum())
                        raise AssertionError(
                            f"{label} {shape} {dt} {bits}-bit: {bad} codes "
                            "or scales differ from the plain version")
                for out_dt in (torch.bfloat16, torch.float32):
                    d_k = chunk_quant.dequantize(p_r, s_r, bits, T, out_dt)
                    d_r = ref.dequantize_ref(p_r, s_r, bits, T, out_dt)
                    torch.cuda.synchronize()
                    err = float((d_k.float() - d_r.float()).abs().max())
                    max_err = max(max_err, err)
                    same = torch.equal(d_k.view(torch.int16), d_r.view(
                        torch.int16)) if out_dt == torch.bfloat16 else \
                        torch.equal(d_k.view(torch.int32),
                                    d_r.view(torch.int32))
                    if not same:
                        raise AssertionError(
                            f"dequantize {shape} {bits}-bit -> {out_dt}: "
                            f"max |diff| {err}")
                n_cases += 1
    log(f"[kernels] {n_cases} quantize cases (each also in one launch "
        f"with a second leaf) x 2 dequantize dtypes bit-exact vs the plain "
        f"versions (max |diff| {max_err})")

    T, F = SERVE_SHAPE
    x, x2 = ((torch.randn(SERVE_SHAPE, generator=g, device=dev) * 3
              ).to(torch.bfloat16) for _ in range(2))
    times = {}
    for bits in (8, 4, 2):
        p, s = ref.quantize_ref(x, bits)
        q = lambda: chunk_quant.quantize(x, bits)            # noqa: E731
        q_ref = lambda: ref.quantize_ref(x, bits)            # noqa: E731
        d = lambda: chunk_quant.dequantize(p, s, bits, T)    # noqa: E731
        d_ref = lambda: ref.dequantize_ref(p, s, bits, T)    # noqa: E731
        bound, by = _codec_bound_ms(T, F, bits, 2)
        for name, fn, plain, match in (
                ("quantize", q, q_ref, QUANT_KERNEL),
                ("dequantize", d, d_ref, "dequant_kernel<")):
            row = {"call_ms": _time_ms(fn),
                   "plain_call_ms": _time_ms(plain, iters=50),
                   "device_ms": _device_ms(fn, match),
                   "plain_device_ms": _device_ms(plain),
                   "bound_ms": bound, "bound_by": by}
            times.setdefault(bits, {})[name] = row
            log(f"[kernels] ({T},{F}) bf16 {bits}-bit {name}: kernel "
                f"{row['device_ms']} ms on the device, {row['call_ms']:.5f}"
                f" ms per call; plain {row['plain_device_ms']} ms on the "
                f"device, {row['plain_call_ms']:.5f} ms per call; bound "
                f"{bound:.5f} ms ({by})")
        # a chunk's two leaves (k, v) in one launch, as switch-out runs it,
        # beside two launches of one leaf each
        two = lambda: chunk_quant.quantize_leaves([x, x2], bits)  # noqa: E731
        per_leaf = lambda: (chunk_quant.quantize(x, bits),  # noqa: E731
                            chunk_quant.quantize(x2, bits))
        row = {"call_ms": _time_ms(two),
               "device_ms": _device_ms(two, QUANT_KERNEL),
               "per_leaf_call_ms": _time_ms(per_leaf),
               "per_leaf_device_ms": _device_ms(per_leaf, QUANT_KERNEL),
               "bound_ms": 2 * bound, "bound_by": by}
        times[bits]["quantize_two_leaves"] = row
        log(f"[kernels] ({T},{F}) x 2 leaves bf16 {bits}-bit quantize in one "
            f"launch: {row['device_ms']} ms on the device, "
            f"{row['call_ms']:.5f} ms per call; as two launches "
            f"{row['per_leaf_device_ms']} ms on the device, "
            f"{row['per_leaf_call_ms']:.5f} ms per call; bound "
            f"{2 * bound:.5f} ms ({by})")
    # the switch-out codec step on the host: a chunk's two leaves to a
    # host payload in one launch and one copy, beside the per-leaf form
    # (a launch and two synchronising copies per leaf)
    from repro_torch.core.chunks import ChunkCodec
    codec = ChunkCodec(("k", "v"), T, dev)
    blocks = {"k": x, "v": x2}
    one = lambda: codec.compress_blocks(blocks, 4)        # noqa: E731
    per_leaf = lambda: {                                   # noqa: E731
        n: tuple(t.cpu().numpy() for t in chunk_quant.quantize(b, 4))
        for n, b in blocks.items()}
    one_ms, per_leaf_ms = _host_ms_pair(one, per_leaf)
    times["switch_out_host_ms"] = {"one_launch_one_copy": one_ms,
                                   "per_leaf": per_leaf_ms}
    log(f"[kernels] switch-out codec step, ({T},{F}) x 2 leaves bf16 "
        f"4-bit to a host payload: {one_ms:.4f} ms host time (median) in "
        f"one launch and one copy, {per_leaf_ms:.4f} ms as a launch and two "
        f"copies per leaf")
    return max_err, times


def _mq_case(B, S, H, KV, hd, quant_share, g, dev, full=False, cs=16,
             n_valid=None):
    """A mixed cache on the card: bf16 K/V, decode-grid int8 codes and
    scales, the quant mask on whole 16-token chunks with about the given
    share, n_valid per row from [1, S] (S in row 0, 1 in the last row of
    a batch), S everywhere with ``full``, or the given ``n_valid``."""
    import torch
    from repro_torch.kernels import ref
    r = lambda *s: torch.randn(s, generator=g, device=dev)   # noqa: E731
    q, k, v = (r(B, H, hd).bfloat16(), r(B, S, KV, hd).bfloat16(),
               r(B, S, KV, hd).bfloat16())
    k_q, k_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    v_q, v_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    chunks = torch.rand((B, -(-S // cs)), generator=g, device=dev) \
        < quant_share
    qm = chunks.repeat_interleave(cs, dim=1)[:, :S].contiguous()
    if n_valid is not None:
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    elif full:
        nv = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        nv = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                           dtype=torch.int32)
        nv[0] = S
        if B > 1:
            nv[-1] = 1
    return [q, k, v, k_q, v_q, k_s, v_s, qm, nv]


def _mq_bound_ms(args, want_mass):
    """Least time for one call: the bytes this call's data needs (each
    valid key's row once: 2 hd * 2 bytes per kv-head at a bf16 position,
    2 hd + 8 at a quant position; q, the mask, n_valid, out and mass
    once) over the HBM rate, or its fp32 operations (~4 H hd per valid
    key: QK and PV multiply-adds) over the fp32 rate, the larger."""
    q, k, _, _, _, _, _, qm, nv = args
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    n_q = n_b = 0
    for b in range(B):
        n = int(nv[b])
        nq = int(qm[b, :n].sum())
        n_q, n_b = n_q + nq, n_b + n - nq
    nbytes = (n_b * KV * 2 * hd * 2 + n_q * KV * (2 * hd + 8)
              + 2 * B * H * hd * 2 + B * S + 4 * B
              + (4 * B * S if want_mass else 0))
    ops = 4 * H * hd * (n_q + n_b)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def mqattn_phase():
    """decode_mqattn against its plain version on the card, both forms,
    with and without the mass; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = {"out": 0.0, "out_rel": 0.0, "mass": 0.0}
    n_cases = 0
    cases = [(_mq_case(*shape, share, g, dev), ((0, 0), (256, 4)))
             for shape in MQ_SHAPES for share in (0.0, 0.5, 1.0)]
    cases += [(_mq_case(*shape, 0.5, g, dev, n_valid=nv), masks)
              for shape, nv, masks in MQ_EDGE]
    for args, masks in cases:
        B, H, hd = args[0].shape
        S, KV = args[1].shape[1], args[1].shape[2]
        share = round(float(args[7].float().mean()), 3)
        for window, n_sinks in masks:
            for select in (False, True):
                o_r, m_r = ref.decode_mqattn_plain(
                    *args, window, n_sinks, want_mass=True,
                    select=select)
                o_k, m_k = kmq.decode_mqattn(*args, window, n_sinks,
                                             want_mass=True,
                                             select=select)
                o_n = kmq.decode_mqattn(*args, window, n_sinks,
                                        select=select)
                o_2, m_2 = kmq.decode_mqattn(*args, window, n_sinks,
                                             want_mass=True,
                                             select=select)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_m = float((m_k - m_r).abs().max())
                case = (f"({B},{S},{H},{KV},{hd}) share {share} window "
                        f"{window} sinks {n_sinks} "
                        f"{'select' if select else 'fused'}")
                if not (torch.isfinite(o_k.float()).all()
                        and d_o <= MQ_OUT_TOL * span
                        and d_m <= MQ_MASS_TOL):
                    raise AssertionError(
                        f"decode_mqattn {case}: max |d out| {d_o} "
                        f"(range {span}), max |d mass| {d_m}")
                if not (torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
                        and torch.equal(m_2, m_k)):
                    raise AssertionError(
                        f"decode_mqattn {case}: reruns differ")
                valid = ref._valid_keys(args[8], B, S, window, n_sinks, dev)
                if bool((m_k[~valid] != 0).any()):
                    raise AssertionError(
                        f"decode_mqattn {case}: mass not 0 at an invalid key")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"],
                                       d_o / max(span, 1e-30))
                worst["mass"] = max(worst["mass"], d_m)
                n_cases += 1
    log(f"[kernels] decode_mqattn: {n_cases} cases ({len(MQ_EDGE)} edge "
        f"shapes of the split plan among them) x (with, without mass) "
        f"within tolerance of the plain version: max |d out| "
        f"{worst['out']} ({worst['out_rel']} of max|out|, tolerance "
        f"{MQ_OUT_TOL}), max |d mass| {worst['mass']} (tolerance "
        f"{MQ_MASS_TOL}); reruns bit-identical")

    times = []
    for B, S, H, KV, hd, share in MQ_TIMED:
        args = _mq_case(B, S, H, KV, hd, share, g, dev, full=True)
        select = S < 4096                    # the form serving runs there
        fn = lambda: kmq.decode_mqattn(*args, want_mass=True,  # noqa: E731
                                       select=select)
        plain = lambda: ref.decode_mqattn_plain(  # noqa: E731
            *args, want_mass=True, select=select)
        kb, vb = ref._mixed_kv(*args[1:8])
        q4 = args[0][:, :, None]                          # (B, H, 1, hd)
        k4 = kb.transpose(1, 2).contiguous()              # (B, KV, S, hd)
        v4 = vb.transpose(1, 2).contiguous()
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4)
        bound, by = _mq_bound_ms(args, True)
        parts = {}
        row = {"shape": f"({B},{S},{H},{KV},{hd})", "quant_share": share,
               "form": "select" if select else "fused",
               "call_ms": _time_ms(fn),
               "device_ms": _device_ms(fn, MQ_KERNELS, by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=50),
               "plain_device_ms": _device_ms(plain),
               "bound_ms": bound, "bound_by": by,
               **_cold_and_library(fn, MQ_KERNELS, lib, q4, k4, v4)}
        times.append(row)
        log(f"[kernels] decode_mqattn {row['shape']} {row['form']} + mass, "
            f"quant share {share}, n_valid = S: kernel {row['device_ms']} ms"
            f" on the device (L2 cold {row['device_ms_l2_cold']} ms), "
            f"{row['call_ms']:.5f} ms per call; plain "
            f"{row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; bound "
            f"{bound:.5f} ms ({by}); kernel by launch {parts}, L2 cold "
            f"{row['device_ms_by_kernel_l2_cold']}")
        _log_library("decode_mqattn", row, "over the pre-selected bf16 K/V "
                     "(out only: no dequant, select or mass)")
    return worst, times


def _sdpa_bound_ms(q4, k4, v4):
    """The least time of scaled_dot_product_attention over these bf16
    inputs: q, K, V read once and out written once at the HBM rate."""
    nbytes = 2 * q4.numel() * 2 + (k4.numel() + v4.numel()) * 2
    return nbytes / HBM_BYTES_PER_S * 1e3


def _cold_and_library(fn, match, lib, q4, k4, v4):
    """A decode kernel's device time with a cold L2 (a 128 MiB buffer
    written before every call, its kernels left out), by launch; the
    library call's device time with a warm and a cold L2, the kernels
    the profiler saw for it, its own bytes bound, and whether a reading
    came in below that bound (then it read from the L2, not the HBM,
    and is no yardstick)."""
    flush = _l2_flush()
    cold, lib_warm, lib_cold = {}, {}, {}
    row = {"device_ms_l2_cold": _device_ms(fn, match, iters=30,
                                           by_kernel=cold, flush=flush),
           "device_ms_by_kernel_l2_cold": cold,
           "library_call_ms": _time_ms(lib),
           "library_device_ms": _device_ms(lib, by_kernel=lib_warm),
           "library_device_ms_l2_cold": _device_ms(lib, iters=30,
                                                   by_kernel=lib_cold,
                                                   flush=flush),
           "library_kernels": lib_warm,
           "library_kernels_l2_cold": lib_cold,
           "library_bytes_bound_ms": _sdpa_bound_ms(q4, k4, v4)}
    row["library_below_its_bytes_bound"] = [
        k for k in ("library_device_ms", "library_device_ms_l2_cold")
        if row[k] is not None and row[k] < row["library_bytes_bound_ms"]]
    return row


def _log_library(kernel, row, what):
    flag = (f"; BELOW its bytes bound: {row['library_below_its_bytes_bound']}"
            f" (read from the L2, not a yardstick)"
            if row["library_below_its_bytes_bound"] else "")
    log(f"[kernels] {kernel} {row['shape']}: scaled_dot_product_attention "
        f"{what} {row['library_device_ms']} ms on the device (L2 cold "
        f"{row['library_device_ms_l2_cold']} ms), "
        f"{row['library_call_ms']:.5f} ms per call; its bytes bound "
        f"{row['library_bytes_bound_ms']:.5f} ms{flag}; kernels seen "
        f"{row['library_kernels']}, L2 cold {row['library_kernels_l2_cold']}")


def _ad_case(B, Sq, Sk, H, KV, hd, q_pos, g, dev):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) bf16 on the card and the (Sq,)
    int32 query positions."""
    import torch
    r = lambda *s: torch.randn(s, generator=g, device=dev)   # noqa: E731
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=dev)
    return [r(B, Sq, H, hd).bfloat16(), r(B, Sk, KV, hd).bfloat16(),
            r(B, Sk, KV, hd).bfloat16(), qp]


def _serve_positions(seq_len):
    """serving's bucket-padded extend positions at S = 512: a first
    prefill of 48 tokens (seq_len 48) or an append of 40 at [160, 200)
    (seq_len 200), then pads at 511 up to the 64-token bucket."""
    n = 48 if seq_len == 48 else 40
    return (list(range(seq_len - n, seq_len))
            + [AD_SERVE["pad"]] * (AD_SERVE["bucket"] - n))


def _ad_bound_ms(args, seq_len, window, n_sinks, want_density):
    """Least time for one call: q, the K/V rows some query sees, out
    (and the density) once over the HBM rate, or 4 hd FLOPs per visible
    (query-head, key) pair (QK and PV) over the bf16 tensor-core rate,
    the larger."""
    from repro_torch.kernels import ref
    q, k, _, qp = args
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    vis = ref.extend_visibility(qp.long(), Sk, seq_len, window, n_sinks)
    n_pairs = int(vis.sum()) * H * B
    n_keys = int(vis.any(dim=0).sum())
    nbytes = B * (2 * Sq * H * hd * 2 + n_keys * KV * hd * 2 * 2) + 4 * Sq \
        + (4 * B * Sk if want_density else 0)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * hd * n_pairs / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def attn_phase():
    """attn_density against its plain version on the card, both forms,
    with and without the density; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    S, H, hd = AD_SERVE["S"], AD_SERVE["H"], AD_SERVE["hd"]
    cases = []        # (label, args, seq_len, (window, n_sinks) settings)
    for seq_len in (48, 200):
        for KV in (32, 8, 4):                         # G = 1, 4, 8
            cases.append((f"serve seq_len {seq_len} G {H // KV}",
                          _ad_case(1, 64, S, H, KV, hd,
                                   _serve_positions(seq_len), g, dev),
                          seq_len, ((0, 0), (512, 4), (16, 0))))
    long_args = _ad_case(1, 512, 4096, H, 32, hd, list(range(3584, 4096)),
                         g, dev)
    cases.append(("long append", long_args, 4096, ((0, 0), (512, 4))))
    pallas_args = _ad_case(1, 2048, 2048, H, 32, hd, list(range(2048)), g,
                           dev)
    cases.append(("Pallas setting", pallas_args, 2048, ((0, 0), (512, 4))))
    # edge cases of the tile plan: Sq G and Sk off the tiles, hd 16, 20 and
    # 80 (zero-padded in shared memory; 20 loads element by element), G 8
    # and 64, and 16-row tiles that hold rows seeing no key beside rows
    # seeing keys (the pads under window 8)
    for label, shape, q_pos, seq_len in (
            ("ragged rows and keys, hd 16", (2, 37, 100, 4, 4, 16),
             list(range(57, 90)) + [99] * 4, 90),
            ("G 8, hd 80", (1, 50, 200, 16, 2, 80),
             list(range(138, 180)) + [199] * 8, 180),
            ("G 64", (1, 24, 300, 64, 1, 64), list(range(226, 250)), 250),
            ("hd 20", (1, 10, 40, 2, 1, 20), list(range(25, 35)), 35),
            ("empty and seeing rows in a tile", (1, 20, 64, 4, 4, 32),
             list(range(30, 40)) + [63] * 10, 40)):
        cases.append((label, _ad_case(*shape, q_pos, g, dev), seq_len,
                      ((0, 0), (8, 0), (16, 2))))
    worst = {"out": 0.0, "out_rel": 0.0, "density": 0.0, "density_rel": 0.0}
    n_cases = n_empty = 0
    for label, args, seq_len, masks in cases:
        for window, n_sinks in masks:
            vis = ref.extend_visibility(args[3].long(), args[1].shape[1],
                                        seq_len, window, n_sinks)
            n_empty += int((~vis.any(dim=1)).sum())
            for form in ("served", "flash"):
                o_r, d_r = ref.attn_density_plain(*args, seq_len, window,
                                                  n_sinks, True, form)
                o_k, d_k = kad.attn_density(*args, seq_len, window, n_sinks,
                                            True, form)
                o_n, d_n = kad.attn_density(*args, seq_len, window, n_sinks,
                                            False, form)
                o_2, d_2 = kad.attn_density(*args, seq_len, window, n_sinks,
                                            True, form)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                dspan = float(d_r.abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_d = float((d_k - d_r).abs().max())
                case = (f"{label} window {window} sinks {n_sinks} {form}")
                if not (torch.isfinite(o_k.float()).all()
                        and torch.isfinite(d_k).all()
                        and d_o <= MQ_OUT_TOL * span
                        and d_d <= AD_DENS_TOL * dspan):
                    raise AssertionError(
                        f"attn_density {case}: max |d out| {d_o} (range "
                        f"{span}), max |d density| {d_d} (range {dspan})")
                if not (d_n is None and torch.equal(o_n, o_k)
                        and torch.equal(o_2, o_k) and torch.equal(d_2, d_k)):
                    raise AssertionError(f"attn_density {case}: reruns "
                                         "differ")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"], d_o / span)
                worst["density"] = max(worst["density"], d_d)
                worst["density_rel"] = max(worst["density_rel"],
                                           d_d / dspan)
                n_cases += 1
    if n_empty == 0:
        raise AssertionError("no attn_density case had a row that sees no "
                             "key")
    log(f"[kernels] attn_density: {n_cases} cases x (with, without density) "
        f"within tolerance of the plain version ({n_empty} rows that see no "
        f"key among them): max |d out| {worst['out']} ({worst['out_rel']} "
        f"of max|out|, tolerance {MQ_OUT_TOL}), max |d density| "
        f"{worst['density']} ({worst['density_rel']} of max density, "
        f"tolerance {AD_DENS_TOL}); reruns bit-identical")

    def timed(label, args, seq_len, form, want_density):
        q, k, v, qp = args
        fn = lambda: kad.attn_density(*args, seq_len, 0, 0,  # noqa: E731
                                      want_density, form)
        plain = lambda: ref.attn_density_plain(  # noqa: E731
            *args, seq_len, 0, 0, want_density, form)
        mask = ref.extend_visibility(qp.long(), k.shape[1], seq_len)
        q4, k4, v4 = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, attn_mask=mask)
        bound, by = _ad_bound_ms(args, seq_len, 0, 0, want_density)
        iters = 200 if q.shape[1] <= 64 else 20
        parts = {}
        row = {"shape": label, "form": form, "density": want_density,
               "call_ms": _time_ms(fn, iters=iters),
               "device_ms": _device_ms(fn, AD_KERNELS, iters=min(iters, 50),
                                       by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=min(iters, 50)),
               "plain_device_ms": _device_ms(plain, iters=min(iters, 50)),
               "library_call_ms": _time_ms(lib, iters=iters),
               "library_device_ms": _device_ms(lib, iters=min(iters, 50)),
               "bound_ms": bound, "bound_by": by}
        log(f"[kernels] attn_density {label} {form}"
            f"{' + density' if want_density else ''}: kernel "
            f"{row['device_ms']} ms on the device, {row['call_ms']:.5f} ms "
            f"per call; plain {row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; "
            f"scaled_dot_product_attention with the boolean mask (out "
            f"only) {row['library_device_ms']} ms on the device, "
            f"{row['library_call_ms']:.5f} ms per call; bound "
            f"{bound:.5f} ms ({by}); kernel by launch {parts}")
        return row

    serve = _ad_case(1, 64, S, H, 32, hd, _serve_positions(200), g, dev)
    times = {
        "out": timed("(1,64,32,32,128) over 512, seq_len 200", serve, 200,
                     "served", False),
        "density": timed("(1,64,32,32,128) over 512, seq_len 200", serve,
                         200, "served", True),
        "long": timed("(1,512,32,32,128) at [3584,4096) over 4096",
                      long_args, 4096, "served", True),
        "pallas": timed("(1,2048,32,32,128) causal", pallas_args, 2048,
                        "flash", True),
    }
    return worst, times


def _dq_bound_ms(args, want_mass):
    """Least time for one call: each valid key's int8 K/V row and its two
    scales (2 hd + 8 bytes per kv-head), q, n_valid, out and the mass once
    over the HBM rate, or 4 H hd FLOPs per valid key over the bf16
    tensor-core rate, the larger."""
    q, k_q, _, _, _, nv = args
    B, H, hd = q.shape
    S, KV = k_q.shape[1], k_q.shape[2]
    n = int(nv.long().clamp(max=S).sum())
    nbytes = (n * KV * (2 * hd + 8) + 2 * B * H * hd * 2 + 4 * B
              + (4 * B * S if want_mass else 0))
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * H * hd * n / BF16_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def qattn_phase():
    """decode_qattn against its plain version on the card, both forms,
    with and without the mass; identical reruns; timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 3)

    def case(B, S, H, KV, hd, full=False, n_valid=None):
        a = _mq_case(B, S, H, KV, hd, 1.0, g, dev, full=full,
                     n_valid=n_valid)
        return [a[0], a[3], a[4], a[5], a[6], a[8]]

    worst = {"out": 0.0, "out_rel": 0.0, "mass": 0.0}
    n_cases = 0
    cases = [(case(*shape), ((0, 0), (256, 4)))
             for shape in ((1, 512, 32, 32, 128), (4, 4096, 32, 32, 128))]
    # the split plan's edge cases, every position quant
    cases += [(case(*shape, n_valid=nv), masks)
              for shape, nv, masks in MQ_EDGE]
    for args, masks in cases:
        B, H, hd = args[0].shape
        S, KV = args[1].shape[1], args[1].shape[2]
        for window, n_sinks in masks:
            for select in (False, True):
                o_r, m_r = ref.decode_qattn_plain(*args, window, n_sinks,
                                                  True, select)
                o_k, m_k = kdq.decode_qattn(*args, window, n_sinks, True,
                                            select)
                o_n = kdq.decode_qattn(*args, window, n_sinks, False,
                                       select)
                o_2, m_2 = kdq.decode_qattn(*args, window, n_sinks, True,
                                            select)
                torch.cuda.synchronize()
                span = float(o_r.float().abs().max())
                d_o = float((o_k.float() - o_r.float()).abs().max())
                d_m = float((m_k - m_r).abs().max())
                label = (f"({B},{S},{H},{KV},{hd}) window {window} sinks "
                         f"{n_sinks} {'select' if select else 'fused'}")
                if not (torch.isfinite(o_k.float()).all()
                        and d_o <= MQ_OUT_TOL * span and d_m <= MQ_MASS_TOL):
                    raise AssertionError(
                        f"decode_qattn {label}: max |d out| {d_o} (range "
                        f"{span}), max |d mass| {d_m}")
                if not (torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
                        and torch.equal(m_2, m_k)):
                    raise AssertionError(f"decode_qattn {label}: reruns "
                                         "differ")
                valid = ref._valid_keys(args[5], B, S, window, n_sinks, dev)
                if bool((m_k[~valid] != 0).any()):
                    raise AssertionError(
                        f"decode_qattn {label}: mass not 0 at an invalid key")
                worst["out"] = max(worst["out"], d_o)
                worst["out_rel"] = max(worst["out_rel"], d_o / span)
                worst["mass"] = max(worst["mass"], d_m)
                n_cases += 1
    log(f"[kernels] decode_qattn: {n_cases} cases ({len(MQ_EDGE)} edge "
        f"shapes of the split plan among them) x (with, without mass) "
        f"within tolerance of the plain version: max |d out| "
        f"{worst['out']} ({worst['out_rel']} of max|out|, tolerance "
        f"{MQ_OUT_TOL}), max |d mass| {worst['mass']} (tolerance "
        f"{MQ_MASS_TOL}); mass 0 at every invalid key; reruns "
        f"bit-identical")

    times = []
    for shape, select in (((1, 512, 32, 32, 128), True),
                          ((4, 4096, 32, 32, 128), False)):
        args = case(*shape, full=True)
        q, k_q, v_q, k_s, v_s, nv = args
        fn = lambda: kdq.decode_qattn(*args, want_mass=True,  # noqa: E731
                                      select=select)
        plain = lambda: ref.decode_qattn_plain(  # noqa: E731
            *args, want_mass=True, select=select)
        kb = ref.dequantize_token_head_ref(k_q, k_s)
        vb = ref.dequantize_token_head_ref(v_q, v_s)
        q4 = q[:, :, None]
        k4, v4 = (t.transpose(1, 2).contiguous() for t in (kb, vb))
        lib = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4)
        bound, by = _dq_bound_ms(args, True)
        parts = {}
        row = {"shape": str(shape).replace(" ", ""),
               "form": "select" if select else "fused",
               "call_ms": _time_ms(fn),
               "device_ms": _device_ms(fn, DQ_KERNELS, by_kernel=parts),
               "device_ms_by_kernel": parts,
               "plain_call_ms": _time_ms(plain, iters=50),
               "plain_device_ms": _device_ms(plain),
               "bound_ms": bound, "bound_by": by,
               **_cold_and_library(fn, DQ_KERNELS, lib, q4, k4, v4)}
        times.append(row)
        log(f"[kernels] decode_qattn {row['shape']} {row['form']} + mass, "
            f"n_valid = S: kernel {row['device_ms']} ms on the device (L2 "
            f"cold {row['device_ms_l2_cold']} ms), {row['call_ms']:.5f} ms "
            f"per call; plain {row['plain_device_ms']} ms on the device, "
            f"{row['plain_call_ms']:.5f} ms per call; bound {bound:.5f} ms "
            f"({by}); kernel by launch {parts}, L2 cold "
            f"{row['device_ms_by_kernel_l2_cold']}")
        _log_library("decode_qattn", row, "over the dequantized bf16 K/V "
                     "(out only)")
    return worst, times


# --------------------------------------------------------------------- #
# 3. serve llama2-7b at full width
# --------------------------------------------------------------------- #
def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _trace(vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):                          # rounds
        for c in range(4):                      # contexts
            n = int(rng.integers(32, 65))
            out.append((c, rng.integers(1, vocab, n).tolist(), 8))
    return out


def build_weights(cfg, seed, device="cuda"):
    """The model and its random bf16 weights from ``seed``, built once
    and shared by every serve run."""
    import torch
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    gib = sum(w.numel() * w.element_size() for w in _leaves(params)) / 2**30
    log(f"[serve] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} hd={cfg.head_dim} vocab={cfg.vocab}, random bf16 "
        f"weights ({gib:.2f} GiB) in {time.perf_counter() - t0:.1f} s")
    return model, params


def serve_phase(model, params, seed, swap_root, label,
                quant_resident=False):
    """Drive LLMService over ``model`` on its device (the CPU only to
    rehearse this script at a reduced size), with the bf16 pool or with
    ``quant_resident``."""
    import numpy as np
    import torch
    from repro_torch.core import restore
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import chunk_quant
    from repro_torch.kernels import decode_mqattn as kmq

    cfg, device = model.cfg, model.device
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cs = 16
    raw_chunk = 2 * cfg.n_layers * cs * cfg.n_kv_heads * cfg.head_dim * 2
    budget = 2 * 4 * raw_chunk        # two contexts' raw KV after 1 call
    sc = LLMSConfig(policy="llms", paged_pool=True, decode_batch=1,
                    max_ctx_len=256, chunk_tokens=cs, memory_budget=budget,
                    quant_resident=quant_resident,
                    swap_dir=tempfile.mkdtemp(dir=swap_root))
    svc = LLMService(model, params, sc, device=device)
    n_logits = {"checked": 0, "quant_rounds": 0, "rounds": 0,
                "profile_extend": False}
    round_profile = {}
    exe = svc.exe
    extend, decode = exe.paged_extend, exe.paged_decode

    def checked(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            logits = out[1]
            if not np.isfinite(logits).all():
                raise AssertionError(f"non-finite logits from {fn.__name__}")
            n_logits["checked"] += 1
            return out
        return run

    def decode_tally(*a, **k):
        # (arenas, toks, pos, pt16, pt8, qmask): a round whose page rows
        # hold a quant chunk, tallied on the host from pool.rows
        qmask = a[5] if len(a) > 5 else k.get("qmask")
        if qmask is not None and np.asarray(qmask).any():
            n_logits["quant_rounds"] += 1
        n_logits["rounds"] += 1
        if on_card and n_logits["rounds"] == PROFILED_ROUND:
            out, round_profile["round"] = _profile_round(
                lambda: decode(*a, **k))
            return out
        return decode(*a, **k)

    def extend_profiled(*a, **k):
        # the last call's prefill-append, once, under the profiler
        if on_card and n_logits["profile_extend"]:
            n_logits["profile_extend"] = False
            out, round_profile["extend"] = _profile_round(
                lambda: extend(*a, **k))
            return out
        return extend(*a, **k)

    exe.paged_extend = checked(extend_profiled)
    exe.paged_decode = checked(decode_tally)

    # codec launches per switch-in and per switch-out of each call
    phase = {"in": [0, 0], "out": [0, 0]}

    def tally(fn, key):
        def run(*a, **k):
            q0 = chunk_quant.quantize.launches
            d0 = chunk_quant.dequantize.launches
            try:
                return fn(*a, **k)
            finally:
                phase[key][0] += chunk_quant.quantize.launches - q0
                phase[key][1] += chunk_quant.dequantize.launches - d0
        return run

    res, pool = svc.res, svc.res.pool
    res.switch_in = tally(res.switch_in, "in")
    res.compress_and_swap_out = tally(res.compress_and_swap_out, "out")
    # chunks quantized by the storage codec (one quantize launch each)
    codec = svc.exe.codec
    compress_blocks = codec.compress_blocks
    compressed = {"chunks": 0, "switch_outs": 0, "host_ms": []}

    def counted_compress(*a, **k):
        compressed["chunks"] += 1
        t0 = time.perf_counter()
        try:
            return compress_blocks(*a, **k)
        finally:
            compressed["host_ms"].append((time.perf_counter() - t0) * 1e3)

    codec.compress_blocks = counted_compress
    alloc8 = pool.alloc8
    quant_pages = {"admitted": 0}

    def counted_alloc8(*a, **k):
        page = alloc8(*a, **k)
        quant_pages["admitted"] += 1
        return page

    pool.alloc8 = counted_alloc8
    restore.reset_io_counters()
    trace = _trace(cfg.vocab, seed)
    records = []
    with svc:
        stubs = [svc.newLLMCtx() for _ in range(4)]
        chunk_quant.reset_launches()
        kmq.reset_launches()
        kad.reset_launches()
        t_run = time.perf_counter()
        for i, (c, prompt, max_new) in enumerate(trace):
            read0 = restore.io_counters()["read"]
            mq0 = kmq.decode_mqattn.launches
            ad0 = kad.attn_density.launches
            n_logits["profile_extend"] = i == len(trace) - 1
            phase["in"][:] = phase["out"][:] = [0, 0]
            t1 = time.perf_counter()
            _, toks = svc.callLLM(stubs[c], prompt, max_new)
            sync()
            wall = time.perf_counter() - t1
            compressed["switch_outs"] += phase["out"][0] > 0
            rec = svc.records[-1]
            ctx = svc.contexts[stubs[c].ctx_id]
            bits = [m.bits for _, m in sorted(ctx.chunks.items())]
            restored = restore.io_counters()["read"] - read0
            pages8 = pool.stats()["pool_pages8_used"]
            mq = kmq.decode_mqattn.launches - mq0
            ad = kad.attn_density.launches - ad0
            records.append({"ctx": c, "tokens": list(map(int, toks)),
                            "bits": bits, "restored_bytes": restored,
                            "switch_s": rec["switch_s"],
                            "launches_in": list(phase["in"]),
                            "launches_out": list(phase["out"]),
                            "quant_pages": pages8, "mqattn_launches": mq,
                            "attn_density_launches": ad})
            log(f"[serve:{label}] call {i:2d} ctx {c} prompt {len(prompt)} "
                f"-> {len(toks)} tokens | switch {rec['switch_s'] * 1e3:.3f}"
                f" ms | restored {restored} B | wall {wall * 1e3:.1f} ms | "
                f"quantize/dequantize launches: switch-in {phase['in']}, "
                f"switch-out {phase['out']} | QUANT pages {pages8} | "
                f"decode_mqattn launches {mq} | attn_density launches {ad} "
                f"| bits {bits}")
        run_s = time.perf_counter() - t_run
        launches = {"quantize": chunk_quant.quantize.launches,
                    "dequantize": chunk_quant.dequantize.launches,
                    "decode_mqattn": kmq.decode_mqattn.launches,
                    "attn_density": kad.attn_density.launches,
                    "attn_density_with_density":
                        kad.attn_density.density_launches}
        stats = svc.stats()
        widths = {}
        for ctx in svc.contexts.values():
            for m in ctx.chunks.values():
                widths[m.bits] = widths.get(m.bits, 0) + 1
    log(f"[serve:{label}] {len(trace)} calls in {run_s:.2f} s; kernel "
        f"launches {launches}; logits checked finite {n_logits['checked']}"
        f" times; decode rounds with a quant chunk "
        f"{n_logits['quant_rounds']}; QUANT pages admitted "
        f"{quant_pages['admitted']}; chunk bit widths stored "
        f"{dict(sorted(widths.items()))}")
    launches["quantize_per_chunk"] = (
        launches["quantize"] / max(compressed["chunks"], 1))
    launches["quantize_per_switch_out"] = (
        sum(r["launches_out"][0] for r in records)
        / max(compressed["switch_outs"], 1))
    host = sorted(compressed["host_ms"]) or [0.0]
    log(f"[serve:{label}] storage codec: {compressed['chunks']} chunks "
        f"quantized in {launches['quantize']} launches "
        f"({launches['quantize_per_chunk']} a chunk); "
        f"{compressed['switch_outs']} calls' switch-outs quantized, "
        f"{launches['quantize_per_switch_out']} launches each; "
        f"compress_blocks host time per chunk median "
        f"{host[len(host) // 2]:.4f} ms (min {host[0]:.4f}, max "
        f"{host[-1]:.4f})")
    log(f"[serve:{label}] stats {json.dumps(stats, default=str)}")
    if "round" in round_profile:
        log(f"[serve:{label}] decode round {PROFILED_ROUND} under the "
            f"profiler: {json.dumps(round_profile['round'])}")
    if "extend" in round_profile:
        log(f"[serve:{label}] the last call's prefill-append under the "
            f"profiler: {json.dumps(round_profile['extend'])}")

    if on_card and not (launches["quantize"] > 0
                        and launches["dequantize"] > 0):
        raise AssertionError(f"a codec kernel never ran: {launches}")
    # every prefill-append attends through attn_density, once per layer
    if on_card and any(r["attn_density_launches"] < cfg.n_layers
                       or r["attn_density_launches"] % cfg.n_layers
                       for r in records):
        raise AssertionError("a call's extend did not run attn_density once "
                             "per layer")
    if not any(b < 16 for b in widths):
        raise AssertionError("no chunk was stored below 16 bits")
    if not any(r["restored_bytes"] > 0 for r in records):
        raise AssertionError("no switch-in restored a chunk from disk")
    if stats["total_calls"] != len(trace):
        raise AssertionError("a call did not complete")
    if quant_resident:
        if on_card and launches["decode_mqattn"] == 0:
            raise AssertionError("decode_mqattn never ran")
        if n_logits["quant_rounds"] == 0:
            raise AssertionError("no decode round attended a quant chunk")
        if quant_pages["admitted"] == 0:
            raise AssertionError("no QUANT page was admitted")
    del svc, exe, extend, decode, res, pool, alloc8, codec, compress_blocks
    gc.collect()                # the logit check closes over the executor
    if on_card:
        torch.cuda.empty_cache()
    return {"records": records, "launches": launches, "stats": stats,
            "run_s": run_s, "widths": widths,
            "quant_rounds": n_logits["quant_rounds"],
            "round_profile": round_profile.get("round"),
            "extend_profile": round_profile.get("extend"),
            "quant_pages_admitted": quant_pages["admitted"]}


def int8_decode_phase(model, params, seed, label, profiled=False):
    """The all-int8 decode cache at full width: a prompt fed through
    ``decode_step`` one token at a time (the only way the reference fills
    this cache), then greedy tokens with the per-key mass; with
    ``profiled``, the middle token runs under the profiler.  The
    decode_qattn launch count is zeroed just before and read just
    after."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_qattn as kdq
    cfg, dev = model.cfg, model.device
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    S, n_prompt, n_new = (INT8_DECODE[k] for k in ("S", "prompt", "new"))
    prompt = np.random.default_rng(seed).integers(1, cfg.vocab, n_prompt)
    cache = model.init_cache(1, S, dtype=torch.int8)
    kdq.reset_launches()
    t0 = time.perf_counter()
    for tok in prompt:
        out = model.decode_step(params, torch.tensor([[int(tok)]],
                                                     device=dev), cache)
        cache = out.cache
    sync()
    prompt_s = time.perf_counter() - t0
    logits, toks, masses, per_token_ms = out.logits, [], [], []
    profile = None
    for i in range(n_new):
        nxt = int(torch.argmax(logits[0]))
        step = lambda: model.decode_step(  # noqa: E731
            params, torch.tensor([[nxt]], device=dev), cache,
            want_density=True)
        if on_card and profiled and i == n_new // 2:
            # one token under the profiler, left out of the per-token times
            (out, mass), profile = _profile_round(step)
        else:
            t1 = time.perf_counter()
            out, mass = step()
            sync()
            per_token_ms.append((time.perf_counter() - t1) * 1e3)
        if not torch.isfinite(out.logits).all():
            raise AssertionError("non-finite logits over the int8 cache")
        cache, logits = out.cache, out.logits
        toks.append(nxt)
        masses.append(mass.float().cpu())
    launches = kdq.decode_qattn.launches
    mass = torch.stack(masses)
    if int(cache["pos"]) != n_prompt + n_new:
        raise AssertionError(f"int8 cache at {int(cache['pos'])}")
    if on_card and launches != (n_prompt + n_new) * cfg.n_layers:
        raise AssertionError(f"{launches} decode_qattn launches, not "
                             f"{(n_prompt + n_new) * cfg.n_layers}")
    sums = mass.sum(dim=-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-3):
        raise AssertionError(f"int8 decode masses do not sum to 1: {sums}")
    ms = sorted(per_token_ms)
    log(f"[int8:{label}] all-int8 cache (1, {S}): {n_prompt}-token prompt "
        f"fed one token at a time in {prompt_s:.2f} s, then {n_new} greedy "
        f"tokens with the mass: per token median {ms[len(ms) // 2]:.2f} ms "
        f"(min {ms[0]:.2f}, max {ms[-1]:.2f}); decode_qattn launches "
        f"{launches} ({cfg.n_layers} a token); tokens {toks}")
    if profile is not None:
        log(f"[int8:{label}] token {n_new // 2} under the profiler: "
            f"{json.dumps(profile)}")
    return {"tokens": toks, "mass": mass, "launches": launches,
            "per_token_ms": per_token_ms, "prompt_s": prompt_s,
            "profile": profile}


# --------------------------------------------------------------------- #
# 4. reduced model on the card vs the same port on the CPU
# --------------------------------------------------------------------- #
def _teacher_forced(model, params, dev, arenas0, mixed):
    """Extend a prompt into row 0's pages, then four decode rounds fed
    fixed tokens.  The bf16 view: one row, pages [3, 7].  The mixed
    view: row 0 holds chunk 0 as an int8 QUANT page and appends 12
    tokens at [16, 28); the decode rounds run two rows, row 1 with its
    chunk 1 quant-resident.  -> all logits, stacked, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    vocab = model.cfg.vocab
    ar = {k: a.to(dev) for k, a in arenas0.items()}
    t = lambda a, dt=torch.long: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    if mixed:
        pt16, lo, n, rows = [[0, 7, 0, 0], [4, 0, 5, 0]], 16, 12, 2
        quant = dict(pt8=t([[2, 0, 0, 0], [0, 3, 0, 0]]),
                     quant_chunks=t([[True, False, False, False],
                                     [False, True, False, False]],
                                    torch.bool))
        first = {k: v[:1] for k, v in quant.items()}
    else:
        pt16, lo, n, rows = [[3, 7, 0, 0]], 0, 20, 1
        quant = first = {}
    prompt = rng.integers(1, vocab, n).tolist()
    pos = t(list(range(lo, lo + n)) + [63] * (32 - n if not mixed else 4))
    toks = t(prompt + [0] * (len(pos) - n))[None]
    ar, x, _ = model.extend_paged(params, toks, pos, ar, t(pt16)[:1],
                                  lo + n, want_density=True, **first)
    logits = [(x[:, n - 1] @ params["head"]).float().cpu()]
    starts = [lo + n, 32][:rows]
    for step in range(4):
        tok = t(rng.integers(1, vocab, (rows, 1)))
        ar, lg, _ = model.decode_paged(
            params, tok, ar, t(pt16), t([p + step for p in starts]),
            want_density=True, **quant)
        logits.append(lg.float().cpu())
    return torch.cat(logits)


def _teacher_forced_int8(model, params, dev):
    """Eight decode_step rounds of two rows over an all-int8 cache, row 1
    starting at position 7, fed fixed tokens.  -> logits and masses,
    stacked, on the CPU."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 4)
    cache = model.init_cache(2, 64, dtype=torch.int8)
    cache["pos"] = torch.tensor([0, 7], device=dev)
    logits, masses = [], []
    for _ in range(8):
        tok = torch.as_tensor(rng.integers(1, model.cfg.vocab, (2, 1)),
                              device=dev)
        out, mass = model.decode_step(params, tok, cache, want_density=True)
        cache = out.cache
        logits.append(out.logits.float().cpu())
        masses.append(mass.float().cpu())
    return torch.cat(logits), torch.cat(masses)


def check_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    from repro_torch.models.registry import build_model

    cfg = reduced(get_config("llama2-7b"))
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(SEED))
    gpu = build_model(cfg, device="cuda")
    params_gpu = {k: ({n: w.cuda() for n, w in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    L, KV, hd, cs = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 16
    g = torch.Generator().manual_seed(SEED)
    shape = (L, 10, cs, KV, hd)
    views = {"bf16": {n: torch.zeros(shape, dtype=torch.bfloat16)
                      for n in ("k16", "v16")}}
    mixed = {}
    for n in ("k", "v"):
        mixed[n + "16"] = torch.randn(shape, generator=g).bfloat16()
        mixed[n + "8"], mixed[n + "8s"] = ref.quantize_token_head_ref(
            torch.randn(shape, generator=g))
    views["mixed"] = mixed
    for view, arenas0 in views.items():
        kmq.reset_launches()
        kad.reset_launches()
        ref_l = _teacher_forced(cpu, params_cpu, "cpu", arenas0,
                                view == "mixed")
        card_l = _teacher_forced(gpu, params_gpu, "cuda", arenas0,
                                 view == "mixed")
        span = float(ref_l.abs().max())
        worst = float((ref_l - card_l).abs().max())
        if not torch.isfinite(card_l).all() or worst > 0.02 * span + 1e-3:
            raise AssertionError(
                f"{view} view: card logits differ from the CPU plain path: "
                f"max |diff| {worst} over range {span}")
        if view == "mixed" and kmq.decode_mqattn.launches != 4 * L:
            raise AssertionError(
                f"mixed view: {kmq.decode_mqattn.launches} decode_mqattn "
                f"launches, not {4 * L}")
        if kad.attn_density.launches != L:
            raise AssertionError(
                f"{view} view: {kad.attn_density.launches} attn_density "
                f"launches in the extend, not {L}")
        log(f"[check] reduced llama2-7b, {view} page view, teacher-forced "
            f"extend (attn_density on the card) + 4 decode rounds: card vs "
            f"CPU max |logit diff| {worst:.5f} (range {span:.4f}, "
            f"tolerance 2% of range: bf16 matmuls round differently)")
    kdq.reset_launches()
    ref_l, ref_m = _teacher_forced_int8(cpu, params_cpu, "cpu")
    card_l, card_m = _teacher_forced_int8(gpu, params_gpu, "cuda")
    span = float(ref_l.abs().max())
    worst = float((ref_l - card_l).abs().max())
    worst_m = float((ref_m - card_m).abs().max())
    if not torch.isfinite(card_l).all() or worst > 0.02 * span + 1e-3 \
            or worst_m > 1e-3:
        raise AssertionError(
            f"int8 cache: card logits differ from the CPU plain path: max "
            f"|diff| {worst} over range {span}, max |d mass| {worst_m}")
    if kdq.decode_qattn.launches != 8 * L:
        raise AssertionError(f"int8 cache: {kdq.decode_qattn.launches} "
                             f"decode_qattn launches, not {8 * L}")
    log(f"[check] reduced llama2-7b, all-int8 decode cache, teacher-forced "
        f"8 rounds of 2 rows ((B,) pos): card vs CPU max |logit diff| "
        f"{worst:.5f} (range {span:.4f}, tolerance 2% of range), max |d "
        f"mass| {worst_m:.3g} (tolerance 1e-3: bf16 K/V and p upstream)")


# the L2-cold readings of the decode kernels' timed rows (kernel and
# library) and the library's own bytes bound
COLD_KEYS = ("device_ms_l2_cold", "device_ms_by_kernel_l2_cold",
             "library_device_ms_l2_cold", "library_kernels",
             "library_bytes_bound_ms", "library_below_its_bytes_bound")


def _device_or_call(row, prefix):
    """The profiler's device time where it recorded one, else the
    event-timed time per call."""
    dev = row[prefix + "device_ms"]
    return dev if dev is not None else row[prefix + "call_ms"]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails where the repo is absent)

    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    smi = build_phase()
    max_err, times = kernel_phase()
    mq_err, mq_times = mqattn_phase()
    ad_err, ad_times = attn_phase()
    dq_err, dq_times = qattn_phase()
    from repro_torch.configs import get_config
    model, params = build_weights(get_config("llama2-7b"), SEED)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="llms_chip_smoke_") as root:
        for label, quant in (("run1", False), ("rerun", False),
                             ("quant1", True), ("quant-rerun", True)):
            runs[label] = serve_phase(model, params, SEED, root, label,
                                      quant_resident=quant)
    int8 = [int8_decode_phase(model, params, SEED, label,
                              profiled=label == "run1")
            for label in ("run1", "rerun")]
    del model, params
    torch.cuda.empty_cache()
    for a_name, b_name in (("run1", "rerun"), ("quant1", "quant-rerun")):
        for a, b in zip(runs[a_name]["records"], runs[b_name]["records"]):
            if (a["tokens"], a["bits"]) != (b["tokens"], b["bits"]):
                raise AssertionError(f"{b_name} differs: {a} vs {b}")
        log(f"[serve] {b_name} from the same seed: identical tokens and bit "
            f"plans over {len(runs[a_name]['records'])} calls")
    if not (int8[0]["tokens"] == int8[1]["tokens"]
            and torch.equal(int8[0]["mass"], int8[1]["mass"])):
        raise AssertionError("the int8 decode rerun differs")
    log("[int8] rerun from the same seed: identical tokens and masses")
    first, quant = runs["run1"], runs["quant1"]
    check_phase()

    src = "src/repro_torch/csrc/chunk_quant.cu"
    kernels = []
    for name, line in (("quantize", 88), ("dequantize", 113)):
        row = times[4][name]
        kernels.append({
            "name": f"chunk_{name}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/chunk_quant.py:{line}",
            "launches": first["launches"][name], "max_abs_err": max_err,
            "ms": _device_or_call(row, ""),
            "plain_ms": _device_or_call(row, "plain_"),
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "shape": f"({SERVE_SHAPE[0]},{SERVE_SHAPE[1]}) bf16 4-bit",
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "ms_by_bits": {b: _device_or_call(times[b][name], "")
                           for b in (8, 4, 2)},
            "bound_ms_by_bits": {b: times[b][name]["bound_ms"]
                                 for b in (8, 4, 2)},
            "launches_quant_resident": quant["launches"][name],
        })
    kernels[0].update({
        "two_leaves_ms_by_bits": {
            b: _device_or_call(times[b]["quantize_two_leaves"], "")
            for b in (8, 4, 2)},
        "two_leaves_as_two_launches_ms_by_bits": {
            b: times[b]["quantize_two_leaves"]["per_leaf_device_ms"]
            for b in (8, 4, 2)},
        "two_leaves_bound_ms_by_bits": {
            b: times[b]["quantize_two_leaves"]["bound_ms"]
            for b in (8, 4, 2)},
        "switch_out_host_ms": times["switch_out_host_ms"],
        "launches_per_chunk": first["launches"]["quantize_per_chunk"],
        "launches_per_switch_out": first["launches"][
            "quantize_per_switch_out"],
    })
    row, long_row = mq_times
    kernels.append({
        "name": "decode_mqattn", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_mqattn.cu",
        "replaces": "src/repro/kernels/decode_qattn.py:183",
        "launches": quant["launches"]["decode_mqattn"],
        "max_abs_err": mq_err["out"], "max_abs_err_mass": mq_err["mass"],
        "ms": _device_or_call(row, ""),
        "plain_ms": _device_or_call(row, "plain_"),
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": _device_or_call(row, "library_"),
        "library_call": "F.scaled_dot_product_attention over the pre-"
                        "selected bf16 K/V: out only, no dequant, select "
                        "or mass",
        "shape": f"{row['shape']} {row['form']} + mass, half quant, "
                 "n_valid = S",
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        **{k: row[k] for k in COLD_KEYS},
        "at_4096": {k: long_row[k] for k in (
            "shape", "form", "device_ms", "call_ms", "plain_device_ms",
            "plain_call_ms", "library_device_ms", "library_call_ms",
            "bound_ms", "bound_by", *COLD_KEYS)},
    })
    for name, line, key, launches, err in (
            ("attn_density_out", 128, "out", first["launches"]
             ["attn_density"], ad_err["out"]),
            ("attn_density_mass", 156, "density", first["launches"]
             ["attn_density_with_density"], ad_err["density"])):
        row = ad_times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/attn_density.cu",
            "replaces": f"src/repro/kernels/attn_density.py:{line}",
            "launches": launches, "max_abs_err": err,
            "ms": _device_or_call(row, ""),
            "plain_ms": _device_or_call(row, "plain_"),
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": (_device_or_call(row, "library_") if key == "out"
                           else None),
            "library_call": ("F.scaled_dot_product_attention with the "
                             "boolean mask: out only" if key == "out"
                             else None),
            "shape": f"{row['shape']}, {row['form']} form"
                     f"{' + density' if row['density'] else ''}",
            "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
            "launches_quant_resident": quant["launches"][
                "attn_density" if key == "out"
                else "attn_density_with_density"],
            **{name: {k: ad_times[src][k] for k in (
                "shape", "form", "device_ms", "call_ms", "plain_device_ms",
                "library_device_ms", "bound_ms", "bound_by")}
               for name, src in (("long_append", "long"),
                                 ("pallas_setting", "pallas"))},
        })
    row, long_row = dq_times
    kernels.append({
        "name": "decode_qattn", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_mqattn.cu",
        "replaces": "src/repro/kernels/decode_qattn.py:84",
        "launches": int8[0]["launches"],
        "max_abs_err": dq_err["out"], "max_abs_err_mass": dq_err["mass"],
        "ms": _device_or_call(row, ""),
        "plain_ms": _device_or_call(row, "plain_"),
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": _device_or_call(row, "library_"),
        "library_call": "F.scaled_dot_product_attention over the "
                        "dequantized bf16 K/V: out only, no mass",
        "shape": f"{row['shape']} {row['form']} + mass, n_valid = S",
        "call_ms": row["call_ms"], "plain_call_ms": row["plain_call_ms"],
        **{k: row[k] for k in COLD_KEYS},
        "at_4096": {k: long_row[k] for k in (
            "shape", "form", "device_ms", "call_ms", "plain_device_ms",
            "plain_call_ms", "library_device_ms", "library_call_ms",
            "bound_ms", "bound_by", *COLD_KEYS)},
        "int8_decode_ms_per_token": sorted(int8[0]["per_token_ms"])[
            len(int8[0]["per_token_ms"]) // 2],
        "int8_decode_profiled_token": int8[0]["profile"],
    })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)      # the one card this run used
    return 0


if __name__ == "__main__":
    sys.exit(main())
