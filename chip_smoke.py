#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the quickest proof that the
port builds, is right, and serves on an NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases (any failure raises and the script exits non-zero with no
result line):

1. build   — compile every CUDA kernel of the port with nvcc for sm_90a
             (all sources at once) and print the card's name and power
             limit;
2. kernels — hold each kernel against its plain PyTorch version on the
             card, bit for bit (codes, scales, dequantized values) over
             bits {8, 4, 2}, bf16/fp32 inputs and four shapes; time the
             kernel, the plain version and the memory bound at the
             serving shape (16, 131072);
3. serve   — llama2-7b at full width and depth (random bf16 weights from
             a seeded torch.Generator) behind LLMService (policy llms,
             paged pool, decode_batch 1): 4 contexts x 3 rounds of
             callLLM under a budget of about two contexts' raw KV, so
             compression, AoT swap-out, LCTRU eviction and disk restores
             all fire.  The kernel launch counts are zeroed just before
             and read just after; the run is repeated from the same seed
             and must give identical tokens and bit plans;
4. check   — the reduced llama2-7b served teacher-forced on the card
             agrees with the same port on the CPU (plain PyTorch).

The last lines are the kernel record ({"kernels": [...]}), the card's
``nvidia-smi`` name and power limit, and {"ok": true, "device": ...}.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
SERVE_SHAPE = (16, 32 * 32 * 128)          # one chunk leaf of llama2-7b
CHECK_SHAPES = [SERVE_SHAPE, (16, 384), (32, 100), (4, 64)]
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12                     # H100 SXM, outside tensor cores


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
def build_phase():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(["chunk_quant"])
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
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


def _device_ms(fn, match=None, iters=50):
    """Device time per call from the profiler's CUDA kernel records: the
    kernels whose name contains ``match`` (all kernels when None),
    summed and divided by ``iters``.  None when the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if match is None or match in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / iters / 1e3 if total_us > 0 else None


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
                p_k, s_k = chunk_quant.quantize(x, bits)
                p_r, s_r = ref.quantize_ref(x, bits)
                torch.cuda.synchronize()
                if not (torch.equal(p_k, p_r) and torch.equal(s_k, s_r)):
                    bad = int((p_k != p_r).sum()) + int((s_k != s_r).sum())
                    raise AssertionError(
                        f"quantize {shape} {dt} {bits}-bit: {bad} codes or "
                        "scales differ from the plain version")
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
    log(f"[kernels] {n_cases} quantize cases x 2 dequantize dtypes "
        f"bit-exact vs the plain versions (max |diff| {max_err})")

    T, F = SERVE_SHAPE
    x = (torch.randn(SERVE_SHAPE, generator=g, device=dev) * 3
         ).to(torch.bfloat16)
    times = {}
    for bits in (8, 4, 2):
        p, s = ref.quantize_ref(x, bits)
        q = lambda: chunk_quant.quantize(x, bits)            # noqa: E731
        q_ref = lambda: ref.quantize_ref(x, bits)            # noqa: E731
        d = lambda: chunk_quant.dequantize(p, s, bits, T)    # noqa: E731
        d_ref = lambda: ref.dequantize_ref(p, s, bits, T)    # noqa: E731
        bound, by = _codec_bound_ms(T, F, bits, 2)
        for name, fn, plain, match in (
                ("quantize", q, q_ref, "::quant_kernel<"),
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
    return max_err, times


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


def serve_phase(seed, swap_root, label, cfg=None, device="cuda"):
    """Drive LLMService on ``cfg`` (default: full llama2-7b) on ``device``
    (the CPU only to rehearse this script at a reduced size)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import restore
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import chunk_quant
    from repro_torch.models.registry import build_model

    cfg = cfg or get_config("llama2-7b")
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    sync()
    log(f"[serve:{label}] {cfg.name}: L={cfg.n_layers} d={cfg.d_model} "
        f"H={cfg.n_heads} hd={cfg.head_dim} vocab={cfg.vocab}, random bf16 "
        f"weights ({sum(w.numel() * w.element_size() for w in _leaves(params)) / 2**30:.2f} GiB) in "
        f"{time.perf_counter() - t0:.1f} s")

    cs = 16
    raw_chunk = 2 * cfg.n_layers * cs * cfg.n_kv_heads * cfg.head_dim * 2
    budget = 2 * 4 * raw_chunk        # two contexts' raw KV after 1 call
    sc = LLMSConfig(policy="llms", paged_pool=True, decode_batch=1,
                    max_ctx_len=256, chunk_tokens=cs, memory_budget=budget,
                    swap_dir=tempfile.mkdtemp(dir=swap_root))
    svc = LLMService(model, params, sc, device=device)
    n_logits = {"checked": 0}
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

    exe.paged_extend, exe.paged_decode = checked(extend), checked(decode)

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

    res = svc.res
    res.switch_in = tally(res.switch_in, "in")
    res.compress_and_swap_out = tally(res.compress_and_swap_out, "out")
    restore.reset_io_counters()
    trace = _trace(cfg.vocab, seed)
    records = []
    with svc:
        stubs = [svc.newLLMCtx() for _ in range(4)]
        chunk_quant.reset_launches()
        t_run = time.perf_counter()
        for i, (c, prompt, max_new) in enumerate(trace):
            read0 = restore.io_counters()["read"]
            phase["in"][:] = phase["out"][:] = [0, 0]
            t1 = time.perf_counter()
            _, toks = svc.callLLM(stubs[c], prompt, max_new)
            sync()
            wall = time.perf_counter() - t1
            rec = svc.records[-1]
            ctx = svc.contexts[stubs[c].ctx_id]
            bits = [m.bits for _, m in sorted(ctx.chunks.items())]
            restored = restore.io_counters()["read"] - read0
            records.append({"ctx": c, "tokens": list(map(int, toks)),
                            "bits": bits, "restored_bytes": restored,
                            "switch_s": rec["switch_s"],
                            "launches_in": list(phase["in"]),
                            "launches_out": list(phase["out"])})
            log(f"[serve:{label}] call {i:2d} ctx {c} prompt {len(prompt)} "
                f"-> {len(toks)} tokens | switch {rec['switch_s'] * 1e3:.3f}"
                f" ms | restored {restored} B | wall {wall * 1e3:.1f} ms | "
                f"quantize/dequantize launches: switch-in {phase['in']}, "
                f"switch-out {phase['out']} | bits {bits}")
        run_s = time.perf_counter() - t_run
        launches = {"quantize": chunk_quant.quantize.launches,
                    "dequantize": chunk_quant.dequantize.launches}
        stats = svc.stats()
        widths = {}
        for ctx in svc.contexts.values():
            for m in ctx.chunks.values():
                widths[m.bits] = widths.get(m.bits, 0) + 1
    log(f"[serve:{label}] {len(trace)} calls in {run_s:.2f} s; kernel "
        f"launches {launches}; logits checked finite {n_logits['checked']}"
        f" times; chunk bit widths stored {dict(sorted(widths.items()))}")
    log(f"[serve:{label}] stats {json.dumps(stats, default=str)}")

    if on_card and not (launches["quantize"] > 0
                        and launches["dequantize"] > 0):
        raise AssertionError(f"a codec kernel never ran: {launches}")
    if not any(b < 16 for b in widths):
        raise AssertionError("no chunk was stored below 16 bits")
    if not any(r["restored_bytes"] > 0 for r in records):
        raise AssertionError("no switch-in restored a chunk from disk")
    if stats["total_calls"] != len(trace):
        raise AssertionError("a call did not complete")
    del svc, params, model, exe, extend, decode, res
    gc.collect()                # the logit check closes over the executor
    if on_card:
        torch.cuda.empty_cache()
    return {"records": records, "launches": launches, "stats": stats,
            "run_s": run_s, "widths": widths}


# --------------------------------------------------------------------- #
# 4. reduced model on the card vs the same port on the CPU
# --------------------------------------------------------------------- #
def check_phase():
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model

    cfg = reduced(get_config("llama2-7b"))
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init(torch.Generator().manual_seed(SEED))
    gpu = build_model(cfg, device="cuda")
    params_gpu = {k: ({n: w.cuda() for n, w in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in params_cpu.items()}
    L, KV, hd, cs = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 16
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(1, cfg.vocab, 20)
    feed = rng.integers(1, cfg.vocab, 4)
    pt = torch.tensor([[3, 7, 0, 0]])
    pos = torch.tensor(list(range(20)) + [63] * 12)
    toks = torch.tensor(list(prompt) + [0] * 12)[None]
    worst = 0.0
    outs = []
    for model, params, dev in ((cpu, params_cpu, "cpu"),
                               (gpu, params_gpu, "cuda")):
        ar = {n: torch.zeros((L, 10, cs, KV, hd), dtype=torch.bfloat16,
                             device=dev) for n in ("k16", "v16")}
        ar, x, dens = model.extend_paged(params, toks.to(dev), pos.to(dev),
                                         ar, pt.to(dev), 20,
                                         want_density=True)
        logits = [(x[:, 19] @ params["head"]).float().cpu()]
        for step, tok in enumerate(feed):
            ar, lg, _ = model.decode_paged(
                params, torch.tensor([[int(tok)]], device=dev), ar,
                pt.to(dev), torch.tensor([20 + step], device=dev),
                want_density=True)
            logits.append(lg.float().cpu())
        outs.append(torch.cat(logits))
    ref_l, card_l = outs
    span = float(ref_l.abs().max())
    worst = float((ref_l - card_l).abs().max())
    if not torch.isfinite(card_l).all() or worst > 0.02 * span + 1e-3:
        raise AssertionError(f"card logits differ from the CPU plain path: "
                             f"max |diff| {worst} over range {span}")
    log(f"[check] reduced llama2-7b, teacher-forced extend + 4 decodes: card"
        f" vs CPU max |logit diff| {worst:.5f} (range {span:.4f}, "
        f"tolerance 2% of range: bf16 matmuls round differently)")


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
    with tempfile.TemporaryDirectory(prefix="llms_chip_smoke_") as root:
        first = serve_phase(SEED, root, "run1")
        again = serve_phase(SEED, root, "rerun")
    for a, b in zip(first["records"], again["records"]):
        if (a["tokens"], a["bits"]) != (b["tokens"], b["bits"]):
            raise AssertionError(f"rerun differs: {a} vs {b}")
    log("[serve] rerun from the same seed: identical tokens and bit plans "
        f"over {len(first['records'])} calls")
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
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
