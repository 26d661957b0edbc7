"""Tests of the port that need the card (marker ``cuda``); they skip
where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so it also runs on a machine with no
JAX, without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none for the codec kernels (bit-exact against their plain
PyTorch versions); for ``decode_mqattn`` and ``decode_qattn`` two bf16
ulps of the largest output and 1e-6 on the mass, for ``attn_density``
two bf16 ulps and 1e-5 of the largest density (the sums run in another
order); bf16 level (2% of the logit range) between the card and the
CPU for the model, whose bf16 matmuls round differently.
"""
import ctypes
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (README.md: run on the card)")
    from repro_torch.models.common import configure_numerics
    dev = torch.device("cuda")
    configure_numerics(dev)        # fp32-accumulated bf16 products
    return dev


def _x(shape, bits, dtype, device):
    rng = np.random.default_rng(shape[0] * shape[1] + bits)
    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
    x[:, 0] = 0                                   # the 1e-8 scale floor
    return x.to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("shape", [(16, 131072), (16, 384), (32, 100),
                                   (4, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_codec_matches_plain_version(card, bits, shape, dtype):
    from repro_torch.kernels import chunk_quant, ref
    x = _x(shape, bits, getattr(torch, dtype), card)
    p_k, s_k = chunk_quant.quantize(x, bits)
    p_r, s_r = ref.quantize_ref(x, bits)
    assert torch.equal(p_k, p_r) and torch.equal(s_k, s_r)
    for out in (torch.bfloat16, torch.float32):
        d_k = chunk_quant.dequantize(p_r, s_r, bits, shape[0], out)
        d_r = ref.dequantize_ref(p_r, s_r, bits, shape[0], out)
        iv = torch.int16 if out == torch.bfloat16 else torch.int32
        assert torch.equal(d_k.view(iv), d_r.view(iv))


@pytest.mark.cuda
def test_cuda_wrappers_count_launches_and_refuse_bad_input(card):
    from repro_torch.kernels import chunk_quant
    chunk_quant.reset_launches()
    x = _x((16, 256), 4, torch.bfloat16, card)
    p, s = chunk_quant.quantize(x, 4)
    chunk_quant.dequantize(p, s, 4, 16)
    assert (chunk_quant.quantize.launches,
            chunk_quant.dequantize.launches) == (1, 1)
    with pytest.raises(ValueError):
        chunk_quant.quantize(x.half(), 4)
    with pytest.raises(ValueError):
        chunk_quant.quantize(x.t(), 4)
    assert chunk_quant.quantize.launches == 1


@pytest.mark.cuda
def test_llmservice_on_card_runs_the_codec_kernels(card):
    """The reduced llama2-7b served on the card under a tight budget
    launches both codec kernels, and its teacher-forced logits agree
    with the CPU run of the same port."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import chunk_quant
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sc = LLMSConfig(max_ctx_len=64, memory_budget=12_000,
                    swap_dir=tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    chunk_quant.reset_launches()
    with LLMService(model, params, sc, device="cuda") as svc:
        stubs = [svc.newLLMCtx() for _ in range(3)]
        for _ in range(2):
            for st in stubs:
                _, toks = svc.callLLM(st, rng.integers(1, 512, 14).tolist(), 4)
                assert len(toks) == 4
        assert svc.stats()["disk_bytes_read"] > 0
    assert chunk_quant.quantize.launches > 0
    assert chunk_quant.dequantize.launches > 0

    cpu = build_model(cfg, device="cpu")
    pc = {k: ({n: w.cpu() for n, w in v.items()} if isinstance(v, dict)
              else v.cpu()) for k, v in params.items()}
    toks = torch.tensor(rng.integers(1, 512, 16))[None]
    pos = torch.arange(16)
    outs = []
    for m, p, dev in ((cpu, pc, "cpu"), (model, params, "cuda")):
        cache = m.init_cache(1, 32)
        _, x, _ = m.recompute(p, toks.to(dev), pos.to(dev), cache, 16)
        outs.append((x[:, -1] @ p["head"]).float().cpu())
    span = float(outs[0].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 0.02 * span + 1e-3


def _mixed_case(B, S, H, KV, hd, quant_share, device, seed=0, cs=16):
    """A mixed cache on ``device``: bf16 K/V, decode-grid int8 codes and
    scales, a quant mask set on whole 16-token chunks with the given
    share, n_valid per row in [1, S] with S and 1 included."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g)              # noqa: E731
    q, k, v = (r(B, H, hd).bfloat16(), r(B, S, KV, hd).bfloat16(),
               r(B, S, KV, hd).bfloat16())
    k_q, k_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    v_q, v_s = ref.quantize_token_head_ref(r(B, S, KV, hd) * 2)
    chunks = torch.rand((B, -(-S // cs)), generator=g) < quant_share
    qm = chunks.repeat_interleave(cs, dim=1)[:, :S].contiguous()
    nv = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32)
    nv[0] = S
    if B > 1:
        nv[1] = 1
    return [t.to(device) for t in (q, k, v, k_q, v_q, k_s, v_s, qm, nv)]


@pytest.mark.cuda
@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (256, 4)])
@pytest.mark.parametrize("quant_share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("B,S,H,KV,hd", [(4, 512, 32, 32, 128),
                                         (2, 4096, 32, 8, 128),
                                         (3, 4100, 4, 4, 16),
                                         (1, 16, 4, 2, 16)])
def test_cuda_decode_mqattn_matches_plain_version(card, B, S, H, KV, hd,
                                                  quant_share, window,
                                                  n_sinks, select):
    """The kernel against its plain PyTorch version on the card, both
    forms, with and without the mass.  out within 2^-7 * max|out| (two
    bf16 ulps: the sums run in another order), mass within 1e-6; a
    rerun is bit-identical (no atomics)."""
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import ref
    args = _mixed_case(B, S, H, KV, hd, quant_share, card, seed=S + B)
    o_r, m_r = ref.decode_mqattn_plain(*args, window, n_sinks,
                                       want_mass=True, select=select)
    o_k, m_k = kmq.decode_mqattn(*args, window, n_sinks, want_mass=True,
                                 select=select)
    o_n = kmq.decode_mqattn(*args, window, n_sinks, select=select)
    torch.cuda.synchronize()
    tol = 2 ** -7 * float(o_r.float().abs().max())
    assert float((o_k.float() - o_r.float()).abs().max()) <= tol
    assert float((m_k - m_r).abs().max()) <= 1e-6
    assert torch.equal(o_n, o_k)
    o_k2, m_k2 = kmq.decode_mqattn(*args, window, n_sinks, want_mass=True,
                                   select=select)
    assert torch.equal(o_k2, o_k) and torch.equal(m_k2, m_k)


@pytest.mark.cuda
def test_cuda_decode_mqattn_counts_launches_and_refuses_bad_input(card):
    from repro_torch.kernels import decode_mqattn as kmq
    kmq.reset_launches()
    args = _mixed_case(1, 64, 4, 2, 16, 0.5, card)
    kmq.decode_mqattn(*args)
    assert kmq.decode_mqattn.launches == 1
    bad = list(args)
    bad[1] = args[1].float()                       # k must be bf16
    with pytest.raises(ValueError):
        kmq.decode_mqattn(*bad)
    bad = list(args)
    bad[8] = args[8].long()                        # n_valid must be int32
    with pytest.raises(ValueError):
        kmq.decode_mqattn(*bad)
    assert kmq.decode_mqattn.launches == 1


@pytest.mark.cuda
def test_llmservice_quant_resident_on_card_runs_decode_mqattn(card):
    """The reduced llama2-7b served with quant_resident=True on the card
    launches the mixed-cache kernel and admits QUANT pages."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sc = LLMSConfig(policy="vllm_sq", max_ctx_len=64, quant_resident=True,
                    swap_dir=tempfile.mkdtemp())
    rng = np.random.default_rng(0)
    kmq.reset_launches()
    with LLMService(model, params, sc, device="cuda") as svc:
        st = svc.newLLMCtx()
        for _ in range(2):
            _, toks = svc.callLLM(st, rng.integers(1, 512, 20).tolist(), 4)
            assert len(toks) == 4
        assert svc.stats()["quant_resident_chunks"] > 0
        assert svc.stats()["pool_pages8_used"] > 0
    assert kmq.decode_mqattn.launches > 0


# --------------------------------------------------------------------- #
# attn_density: extend attention with the Eq.-1 density
#
# Tolerance: out within 2^-7 * max|out| (two bf16 ulps: the sums and the
# online (m, l) run in another order, and the served form rounds p to
# bf16, where a p near a rounding boundary may round the other way);
# density within 1e-5 * max|density| (fp32 probabilities summed in
# another order).  Reruns are bit-identical (no atomics).
# --------------------------------------------------------------------- #
def _extend_case(B, Sq, Sk, H, KV, hd, seq_len, n_pad, device, seed=0,
                 pad_pos=None, dv=None):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd), v (B,Sk,KV,dv (default hd)) bf16
    and q_pos: the Sq - n_pad positions just below seq_len, then n_pad
    bucket-pad rows at ``pad_pos`` (default Sk - 1)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).bfloat16()   # noqa: E731
    n = Sq - n_pad
    pad = Sk - 1 if pad_pos is None else pad_pos
    qp = torch.tensor(list(range(seq_len - n, seq_len)) + [pad] * n_pad,
                      dtype=torch.int32)
    return [t.to(device) for t in (r(B, Sq, H, hd), r(B, Sk, KV, hd),
                                   r(B, Sk, KV, hd if dv is None else dv),
                                   qp)]


def _check_extend(args, seq_len, window, n_sinks, form):
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    o_r, d_r = ref.attn_density_plain(*args, seq_len, window, n_sinks,
                                      True, form)
    o_k, d_k = kad.attn_density(*args, seq_len, window, n_sinks, True, form)
    o_n, d_n = kad.attn_density(*args, seq_len, window, n_sinks, False,
                                form)
    o_2, d_2 = kad.attn_density(*args, seq_len, window, n_sinks, True, form)
    torch.cuda.synchronize()
    assert d_n is None and torch.isfinite(o_k.float()).all()
    assert float((o_k.float() - o_r.float()).abs().max()) <= \
        2 ** -7 * float(o_r.float().abs().max())
    assert float((d_k - d_r).abs().max()) <= 1e-5 * float(d_r.abs().max())
    assert torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
    assert torch.equal(d_2, d_k)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (512, 4), (16, 0)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,seq_len,n_pad", [
    (1, 64, 512, 32, 32, 128, 200, 24),      # serving's extend, G = 1
    (1, 64, 512, 32, 8, 128, 48, 16),        # G = 4
    (1, 64, 512, 32, 4, 128, 200, 24),       # G = 8
    (2, 40, 100, 4, 2, 16, 90, 3),           # ragged tiles, B = 2
])
def test_cuda_attn_density_matches_plain_version(card, B, Sq, Sk, H, KV, hd,
                                                 seq_len, n_pad, window,
                                                 n_sinks, form):
    """The kernel against its plain PyTorch version on the card, both
    forms, with and without the density; window 16 with no sinks leaves
    the pad rows with no visible key (uniform p)."""
    args = _extend_case(B, Sq, Sk, H, KV, hd, seq_len, n_pad, card,
                        seed=Sq + KV)
    _check_extend(args, seq_len, window, n_sinks, form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (512, 4), (16, 0)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dqk,dv,seq_len,n_pad", [
    (1, 64, 512, 16, 16, 192, 128, 200, 24),  # MLA's recompute, S = 512
    (1, 64, 256, 16, 16, 192, 128, 148, 24),  # and over 256
    (1, 256, 512, 16, 16, 192, 128, 200, 56),  # lmk's whole recompute
    (1, 128, 512, 16, 16, 192, 128, 100, 28),  # the 128-row bucket
    (1, 16, 512, 16, 16, 192, 128, 48, 0),     # one restored chunk
    (1, 640, 1024, 16, 16, 192, 128, 1000, 0),  # 64-row tiles at 192/128
    (2, 37, 100, 4, 4, 24, 16, 90, 4),        # the reduced MLA, ragged
    (1, 50, 200, 16, 2, 150, 64, 180, 8),     # G 8, V padded to 128
])
def test_cuda_attn_density_at_mla_head_dims(card, B, Sq, Sk, H, KV, dqk,
                                            dv, seq_len, n_pad, window,
                                            n_sinks, form):
    """Query/key head dim Dqk beside value head dim Dv (MLA's recompute:
    128 + 64 and 128) against the plain version, both forms, with and
    without the density; out (B, Sq, H, Dv).  The 640-row case runs the
    kernel's 64-row tiles, the others its 16-row ones."""
    from repro_torch.kernels import attn_density as kad
    assert kad.plan(B, Sq, H, KV)[0] == (64 if Sq == 640 else 16)
    args = _extend_case(B, Sq, Sk, H, KV, dqk, seq_len, n_pad, card,
                        seed=Sq + dqk, dv=dv)
    _check_extend(args, seq_len, window, n_sinks, form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (64, 4), (16, 0)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dqk,dv,seq_len,n_pad", [
    (1, 64, 512, 10, 1, 256, 256, 200, 24),    # 16-row tiles, seq_len < Sk
    (1, 1400, 1400, 10, 1, 256, 256, 1400, 0),  # 64-row tiles
    (2, 37, 100, 4, 2, 256, 256, 90, 4),       # ragged Sq, B = 2
    (1, 20, 64, 4, 4, 200, 136, 40, 10),       # half 1 holds 8 columns
    (1, 24, 80, 2, 1, 256, 100, 70, 0),        # Dv <= 128: one half
])
def test_cuda_attn_density_at_head_dim_256(card, B, Sq, Sk, H, KV, dqk, dv,
                                           seq_len, n_pad, window, n_sinks,
                                           form):
    """The HDQ-256 instantiation (recurrentgemma's local MQA: Dqk = Dv =
    256, V in two 128-column halves, one block each) against the plain
    version, both forms, with and without the density; the 1400-row
    case runs the 64-row tiles, the others the 16-row ones."""
    from repro_torch.kernels import attn_density as kad
    assert kad.head_plan(dqk, dv)[0] == 256
    assert kad.plan(B, Sq, H, KV)[0] == (64 if Sq == 1400 else 16)
    args = _extend_case(B, Sq, Sk, H, KV, dqk, seq_len, n_pad, card,
                        seed=Sq + dv, dv=dv)
    _check_extend(args, seq_len, window, n_sinks, form)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
def test_cuda_attn_density_v_halves_meet_at_column_128(card, form):
    """V's column 127 (the last of half 0) holds 1 and column 128 (the
    first of half 1) holds -2 at every key: every output row is a convex
    combination of them, so out[..., 127] = 1 and out[..., 128] = -2
    within a bf16 ulp (the served form's p is rounded to bf16) in both
    16- and 64-row tiles, under a window with sinks; and the two
    columns equal the plain version's."""
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    for Sq, Sk, seq_len in ((64, 512, 200), (1400, 1400, 1400)):
        q, k, v, qp = _extend_case(1, Sq, Sk, 10, 1, 256, seq_len, 0, card,
                                   seed=Sq)
        v[..., 127], v[..., 128] = 1.0, -2.0
        o_k, _ = kad.attn_density(q, k, v, qp, seq_len, 64, 4, True, form)
        o_r, _ = ref.attn_density_plain(q, k, v, qp, seq_len, 64, 4, True,
                                        form)
        torch.cuda.synchronize()
        for col, want in ((127, 1.0), (128, -2.0)):
            got = o_k[..., col].float()
            assert float((got - want).abs().max()) <= 2 ** -7 * abs(want)
            assert float((got - o_r[..., col].float()).abs().max()) <= \
                2 ** -7 * abs(want)


@pytest.mark.cuda
def test_cuda_attn_density_pallas_form_at_width(card):
    """The Pallas kernel's own setting (q_pos = arange, seq_len = Sk) at
    (1, 1024, 32, 32, 128), causal and windowed."""
    args = _extend_case(1, 1024, 1024, 32, 32, 128, 1024, 0, card, seed=3)
    for window, n_sinks in ((0, 0), (256, 4)):
        _check_extend(args, 1024, window, n_sinks, "flash")


@pytest.mark.cuda
def test_cuda_attn_density_counts_launches_and_refuses_bad_input(card):
    from repro_torch.kernels import attn_density as kad
    kad.reset_launches()
    q, k, v, qp = _extend_case(1, 8, 32, 4, 2, 16, 20, 2, card)
    kad.attn_density(q, k, v, qp, 20)
    assert kad.attn_density.launches == 1
    with pytest.raises(ValueError):
        kad.attn_density(q.float(), k, v, qp, 20)
    with pytest.raises(ValueError):
        kad.attn_density(q, k, v, qp.long(), 20)
    for dqk, dv in ((264, 16), (16, 264)):        # beyond 256 / 256
        qb, kb, vb, _ = _extend_case(1, 8, 32, 4, 2, dqk, 20, 2, card, dv=dv)
        with pytest.raises(ValueError, match="head dims"):
            kad.attn_density(qb, kb, vb, qp, 20)
    with pytest.raises(ValueError):               # k and v disagree on Sk
        kad.attn_density(q, k, v[:, :16].contiguous(), qp, 20)
    assert kad.attn_density.launches == 1


# --------------------------------------------------------------------- #
# decode_qattn: the all-int8 cache (tolerances as decode_mqattn above)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (256, 4)])
@pytest.mark.parametrize("B,S,H,KV,hd", [(1, 512, 32, 32, 128),
                                         (4, 4096, 32, 32, 128),
                                         (3, 4100, 4, 4, 16),
                                         (2, 96, 8, 2, 32)])
def test_cuda_decode_qattn_matches_plain_version(card, B, S, H, KV, hd,
                                                 window, n_sinks, select):
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    a = _mixed_case(B, S, H, KV, hd, 1.0, card, seed=S + B)
    args = [a[0], a[3], a[4], a[5], a[6], a[8]]
    o_r, m_r = ref.decode_qattn_plain(*args, window, n_sinks,
                                      want_mass=True, select=select)
    o_k, m_k = kdq.decode_qattn(*args, window, n_sinks, want_mass=True,
                                select=select)
    o_n = kdq.decode_qattn(*args, window, n_sinks, select=select)
    torch.cuda.synchronize()
    tol = 2 ** -7 * float(o_r.float().abs().max())
    assert float((o_k.float() - o_r.float()).abs().max()) <= tol
    assert float((m_k - m_r).abs().max()) <= 1e-6
    assert torch.equal(o_n, o_k)
    o_2, m_2 = kdq.decode_qattn(*args, window, n_sinks, want_mass=True,
                                select=select)
    assert torch.equal(o_2, o_k) and torch.equal(m_2, m_k)


@pytest.mark.cuda
@pytest.mark.parametrize("pos_kind", ["scalar", "rows"])
def test_cuda_int8_decode_step_matches_cpu(card, pos_kind):
    """The reduced llama2-7b's all-int8 ``decode_step`` on the card, fed
    the same tokens as the same port on the CPU: logits within 2% of
    their range, L ``decode_qattn`` launches a step."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    cpu = build_model(cfg, device="cpu")
    pc = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    pg = {k: ({n: w.cuda() for n, w in v.items()} if isinstance(v, dict)
              else v.cuda()) for k, v in pc.items()}
    caches = [m.init_cache(2, 64, dtype=torch.int8) for m in (cpu, gpu)]
    if pos_kind == "rows":
        caches = [dict(c, pos=torch.tensor([0, 7], device=c["k"].device))
                  for c in caches]
    rng = np.random.default_rng(1)
    kdq.reset_launches()
    for step in range(6):
        tok = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 1)))
        outs = []
        for i, (m, p) in enumerate(((cpu, pc), (gpu, pg))):
            o, mass = m.decode_step(p, tok.to(m.device), caches[i],
                                    want_density=True)
            caches[i] = o.cache
            outs.append((o.logits.cpu(), mass.cpu()))
        span = float(outs[0][0].abs().max())
        assert float((outs[0][0] - outs[1][0]).abs().max()) <= \
            0.02 * span + 1e-3
        assert float((outs[0][1] - outs[1][1]).abs().max()) <= 1e-3
    assert kdq.decode_qattn.launches == 6 * cfg.n_layers


@pytest.mark.cuda
def test_cuda_recompute_runs_attn_density(card):
    """Serving's extend on the card goes through the kernel: one launch
    per layer of ``recompute``, the density finite and non-negative."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import attn_density as kad
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    cache = model.init_cache(1, 64)
    toks = torch.randint(1, cfg.vocab, (1, 16), device="cuda")
    pos = torch.tensor(list(range(12)) + [63] * 4, device="cuda")
    kad.reset_launches()
    _, x, dens = model.recompute(params, toks, pos, cache, 12,
                                 want_density=True)
    torch.cuda.synchronize()
    assert kad.attn_density.launches == cfg.n_layers
    assert dens.shape == (1, 64) and torch.isfinite(dens).all()
    assert float(dens.min()) >= 0.0


# --------------------------------------------------------------------- #
# attn_density's flash form at Dqk = Dv = 64 and 128: csrc/attn_flash.cu
# (the wgmma + TMA forward, the key-major density pass) against its plain
# two-pass version, at the tolerances of _check_extend (out within 2^-7
# of max|out|, density within 1e-5 of its largest value) and the row
# stats at STATS_TOL; reruns and the out without the density or with
# the stats bit-identical.
# --------------------------------------------------------------------- #
FLASH_GROUPS = {1: (4, 4), 3: (15, 5), 5: (10, 2), 8: (16, 2)}
FLASH_SETTINGS = {
    # name: (Sq, Sk, q_pos, seq_len, window, n_sinks)
    "causal, Sq off the tiles": (300, 300, list(range(300)), 300, 0, 0),
    "offset, seq_len < Sk": (200, 520, list(range(300, 500)), 500, 0, 0),
    "window + sinks": (700, 700, list(range(700)), 700, 256, 4),
    "pads that see no key": (64, 512, list(range(160, 200)) + [511] * 24,
                             200, 16, 0),
}


def _check_flash(args, seq_len, window, n_sinks):
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import ref
    kad.reset_launches()
    o_k, d_k = kad.attn_density(*args, seq_len, window, n_sinks, True,
                                "flash")
    o_n, d_n = kad.attn_density(*args, seq_len, window, n_sinks, False,
                                "flash")
    o_s, d_s, m_k, l_k = kad.attn_density(*args, seq_len, window, n_sinks,
                                          False, "flash", True)
    o_2, d_2 = kad.attn_density(*args, seq_len, window, n_sinks, True,
                                "flash")
    torch.cuda.synchronize()
    assert (kad.attn_density.launches, kad.attn_density.flash_launches,
            kad.attn_density.flash_density_launches) == (4, 4, 2)
    o_r, d_r = ref.attn_flash_plain(*args, seq_len, window, n_sinks, True)
    _, _, m_r, l_r = ref.attn_flash_plain(*args, seq_len, window, n_sinks,
                                          False, True)
    assert d_n is None and d_s is None and torch.isfinite(o_k.float()).all()
    assert float((o_k.float() - o_r.float()).abs().max()) <= \
        2 ** -7 * float(o_r.float().abs().max())
    assert float((d_k - d_r).abs().max()) <= \
        1e-5 * max(float(d_r.abs().max()), 1e-30)
    seen = m_r > ref.NEG_INF / 2
    assert torch.equal(m_k[~seen], m_r[~seen])
    if seen.any():
        assert float((m_k - m_r)[seen].abs().max()) <= \
            1e-5 * max(1.0, float(m_r[seen].abs().max()))
    assert float(((l_k - l_r).abs() / l_r).max()) <= 1e-5
    assert torch.equal(o_n, o_k) and torch.equal(o_s, o_k)
    assert torch.equal(o_2, o_k) and torch.equal(d_2, d_k)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(FLASH_SETTINGS))
@pytest.mark.parametrize("G", sorted(FLASH_GROUPS))
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_attn_flash_matches_plain_version(card, hd, G, setting):
    """The new flash kernels at hd 64 and 128, G 1, 3, 5 and 8: Sq G
    off the 128-row tiles, queries at an offset over more keys with
    seq_len < Sk, a window with sinks, and pad rows that see no key
    beside rows that see keys; with and without the density and with
    the row stats."""
    H, KV = FLASH_GROUPS[G]
    Sq, Sk, qp, seq_len, window, n_sinks = FLASH_SETTINGS[setting]
    g = torch.Generator().manual_seed(Sq + Sk + hd + G)
    r = lambda *s: torch.randn(s, generator=g).bfloat16().to(card)  # noqa
    args = [r(2, Sq, H, hd), r(2, Sk, KV, hd), r(2, Sk, KV, hd),
            torch.tensor(qp, dtype=torch.int32, device=card)]
    _check_flash(args, seq_len, window, n_sinks)


@pytest.mark.cuda
def test_cuda_attn_density_routes_by_form_and_head_dims(card):
    """Each route launches its kernel: the flash form at 64/64 and
    128/128 through csrc/attn_flash.cu (its counter), the served form
    and the flash form at other head dims through csrc/attn_density.cu
    (the flash counter stays); one call counts one launch whatever the
    kernel; the new route refuses a base that is not 16-byte aligned
    (TMA) and launches nothing then."""
    from repro_torch.kernels import attn_density as kad
    for dqk, dv, form, want in ((64, 64, "flash", 1), (128, 128, "flash", 1),
                                (64, 64, "served", 0),
                                (128, 128, "served", 0),
                                (192, 128, "flash", 0), (256, 256, "flash", 0),
                                (16, 16, "flash", 0), (128, 64, "flash", 0)):
        args = _extend_case(1, 40, 100, 8, 2, dqk, 90, 4, card, dv=dv)
        for density in (False, True):
            kad.reset_launches()
            kad.attn_density(*args, 90, 0, 0, density, form)
            assert (kad.attn_density.launches,
                    kad.attn_density.flash_launches,
                    kad.attn_density.flash_density_launches) == \
                (1, want, want * density)
    q, k, v, qp = _extend_case(1, 40, 100, 8, 2, 64, 90, 4, card)
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=card)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    kad.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        kad.attn_density(q_off, k, v, qp, 90, 0, 0, True, "flash")
    assert kad.attn_density.launches == 0


# --------------------------------------------------------------------- #
# Edge cases of the tile plan (attn_density) and the split plan
# (decode_mqattn), and the plans the CUDA sources compute against the
# wrappers' ``plan`` (tested on the CPU in tests/test_torch_plans.py).
# Tolerances as above.
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (8, 0), (16, 2)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,seq_len,n_pad", [
    (2, 37, 100, 4, 4, 16, 90, 4),       # Sq G and Sk off the tiles, hd 16
    (1, 50, 200, 16, 2, 80, 180, 8),     # G 8 (2 queries a tile), hd 80
    (1, 24, 300, 64, 1, 64, 250, 0),     # G 64: a query over 4 tiles
    (1, 10, 40, 2, 1, 20, 35, 0),        # hd 20: element-wise loads
    (1, 20, 64, 4, 4, 32, 40, 10),       # pads that see nothing beside
])                                       # rows that see keys in a tile
def test_cuda_attn_density_edge_cases(card, B, Sq, Sk, H, KV, hd, seq_len,
                                      n_pad, window, n_sinks, form):
    args = _extend_case(B, Sq, Sk, H, KV, hd, seq_len, n_pad, card,
                        seed=Sq + hd)
    _check_extend(args, seq_len, window, n_sinks, form)


@pytest.mark.cuda
@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("B,S,H,KV,hd,n_valid,window,n_sinks", [
    (1, 512, 32, 32, 128, [100], 0, 0),        # n_valid inside a split
    (1, 512, 32, 32, 128, [512], 128, 4),      # splits between sinks and
    (1, 512, 32, 32, 128, [512], 64, 0),       # window, or before it
    (4, 512, 32, 32, 128, [512, 1, 200, 77], 0, 0),
    (4, 512, 32, 32, 128, [512, 1, 200, 77], 128, 4),
    (1, 16, 4, 2, 16, [16], 8, 2),             # one split
    (2, 300, 8, 2, 20, [300, 131], 64, 3),     # hd 20: element-wise loads
])
def test_cuda_decode_mqattn_edge_cases(card, B, S, H, KV, hd, n_valid,
                                       window, n_sinks, select):
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import ref
    args = _mixed_case(B, S, H, KV, hd, 0.5, card, seed=S + B + hd)
    args[8] = torch.tensor(n_valid, dtype=torch.int32, device=card)
    o_r, m_r = ref.decode_mqattn_plain(*args, window, n_sinks,
                                       want_mass=True, select=select)
    o_k, m_k = kmq.decode_mqattn(*args, window, n_sinks, want_mass=True,
                                 select=select)
    o_n = kmq.decode_mqattn(*args, window, n_sinks, select=select)
    o_2, m_2 = kmq.decode_mqattn(*args, window, n_sinks, want_mass=True,
                                 select=select)
    torch.cuda.synchronize()
    tol = 2 ** -7 * float(o_r.float().abs().max())
    assert float((o_k.float() - o_r.float()).abs().max()) <= tol
    assert float((m_k - m_r).abs().max()) <= 1e-6
    valid = ref._valid_keys(args[8], B, S, window, n_sinks, card)
    assert bool((m_k[~valid] == 0).all())   # exactly 0 at invalid keys
    assert torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
    assert torch.equal(m_2, m_k)


@pytest.mark.cuda
def test_cuda_kernel_plans_match_the_wrappers(card):
    """The CUDA sources' tile and split plans equal the wrappers'
    ``plan`` and ``flash_plan``, which size the scratch buffers."""
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    la, lm = kad._lib(), kmq._lib()
    lf = kad._flash_lib()
    got = (ctypes.c_int * 5)()
    for B, Sq, H, KV in ((1, 64, 32, 32), (1, 512, 32, 32), (2, 37, 4, 4),
                         (1, 24, 64, 1), (4, 64, 32, 32), (1, 2048, 32, 8)):
        assert la.attn_density_rows(B, Sq, H, KV) == kad.plan(B, Sq, H, KV)[0]
        assert lf.attn_flash_plan(B, Sq, H, KV, got) == 0
        assert tuple(got) == kad.flash_plan(B, Sq, H, KV)
    for B, S, KV in ((1, 512, 32), (1, 4096, 32), (4, 512, 32), (3, 4100, 4),
                     (1, 16, 2), (2, 300, 2), (1, 65536, 32)):
        assert lm.decode_mqattn_splits(B, S, KV) == kmq.plan(B, S, KV)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("B,S,H,KV,hd,n_valid,window,n_sinks", [
    (1, 512, 32, 32, 128, [100], 0, 0),        # n_valid inside a split
    (1, 512, 32, 32, 128, [512], 128, 4),      # splits between sinks and
    (1, 512, 32, 32, 128, [512], 64, 0),       # window, or before it
    (4, 512, 32, 32, 128, [512, 1, 200, 77], 0, 0),
    (4, 512, 32, 32, 128, [512, 1, 200, 77], 128, 4),
    (1, 16, 4, 2, 16, [16], 8, 2),             # one split
    (2, 300, 8, 2, 20, [300, 131], 64, 3),     # hd 20: element-wise loads
])
def test_cuda_decode_qattn_edge_cases(card, B, S, H, KV, hd, n_valid,
                                      window, n_sinks, select):
    """The all-int8 cache over the split plan's edge cases (those of
    ``test_cuda_decode_mqattn_edge_cases``, every position quant), both
    forms: tolerances as above, the mass exactly 0 at invalid keys,
    reruns bit-identical."""
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import ref
    a = _mixed_case(B, S, H, KV, hd, 1.0, card, seed=S + B + hd)
    args = [a[0], a[3], a[4], a[5], a[6],
            torch.tensor(n_valid, dtype=torch.int32, device=card)]
    o_r, m_r = ref.decode_qattn_plain(*args, window, n_sinks,
                                      want_mass=True, select=select)
    o_k, m_k = kdq.decode_qattn(*args, window, n_sinks, want_mass=True,
                                select=select)
    o_n = kdq.decode_qattn(*args, window, n_sinks, select=select)
    o_2, m_2 = kdq.decode_qattn(*args, window, n_sinks, want_mass=True,
                                select=select)
    torch.cuda.synchronize()
    tol = 2 ** -7 * float(o_r.float().abs().max())
    assert float((o_k.float() - o_r.float()).abs().max()) <= tol
    assert float((m_k - m_r).abs().max()) <= 1e-6
    valid = ref._valid_keys(args[5], B, S, window, n_sinks, card)
    assert bool((m_k[~valid] == 0).all())   # exactly 0 at invalid keys
    assert torch.equal(o_n, o_k) and torch.equal(o_2, o_k)
    assert torch.equal(m_2, m_k)


@pytest.mark.cuda
def test_cuda_decode_qattn_counts_launches_and_refuses_bad_input(card):
    from repro_torch.kernels import decode_qattn as kdq
    kdq.reset_launches()
    a = _mixed_case(1, 64, 4, 2, 16, 1.0, card)
    args = [a[0], a[3], a[4], a[5], a[6], a[8]]
    kdq.decode_qattn(*args, want_mass=True, select=True)
    assert kdq.decode_qattn.launches == 1
    bad = list(args)
    bad[1] = args[1].float()                       # k_q must be int8
    with pytest.raises(ValueError):
        kdq.decode_qattn(*bad)
    assert kdq.decode_qattn.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantize_leaves_matches_plain_version(card, bits, dtype):
    """One launch quantizes leaves of different F (a chunk of llama2-7b's
    width, one off the 16-byte vectors' alignment, one ragged) bit for
    bit as per-leaf ``quantize_ref``; so does a chunk of nine leaves in
    two launches."""
    from repro_torch.kernels import chunk_quant, ref
    dt = getattr(torch, dtype)
    xs = [_x((16, F), bits, dt, card) for F in (131072, 384, 100)]
    chunk_quant.reset_launches()
    buf, outs = chunk_quant.quantize_leaves(xs, bits)
    assert chunk_quant.quantize.launches == 1
    for x, (p, s) in zip(xs, outs):
        p_r, s_r = ref.quantize_ref(x, bits)
        assert torch.equal(p, p_r) and torch.equal(s, s_r)
    many = [_x((16, 64 + 8 * i), bits, dt, card) for i in range(9)]
    _, outs = chunk_quant.quantize_leaves(many, bits)
    assert chunk_quant.quantize.launches == 3
    for x, (p, s) in zip(many, outs):
        p_r, s_r = ref.quantize_ref(x, bits)
        assert torch.equal(p, p_r) and torch.equal(s, s_r)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_cuda_codec_compresses_a_chunk_in_one_launch(card, bits):
    """``ChunkCodec.compress_blocks`` on the card: one quantize launch a
    chunk, and the payload byte-equal to the CPU codec's."""
    from repro_torch.core.chunks import ChunkCodec
    from repro_torch.kernels import chunk_quant
    blocks = {n: _x((16, F), bits, torch.bfloat16, card)
              for n, F in (("k", 4096), ("v", 4096))}
    chunk_quant.reset_launches()
    pc = ChunkCodec(("k", "v"), 16, card).compress_blocks(blocks, bits)
    assert chunk_quant.quantize.launches == 1
    pp = ChunkCodec(("k", "v"), 16, "cpu").compress_blocks(
        {n: b.cpu() for n, b in blocks.items()}, bits)
    assert pc.shapes == pp.shapes and pc.nbytes == pp.nbytes
    for n in pp.data:
        for x, y in zip(pc.data[n], pp.data[n]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


@pytest.mark.cuda
def test_cuda_decode_qattn_plan_matches_the_wrapper(card):
    from repro_torch.kernels import decode_qattn as kdq
    lib = kdq._lib()
    for B, S, KV in ((1, 512, 32), (4, 4096, 32), (3, 4100, 4), (1, 16, 2),
                     (2, 300, 2)):
        assert lib.decode_mqattn_splits(B, S, KV) == kdq.plan(B, S, KV)[0]


# --------------------------------------------------------------------- #
# the router on the card
# --------------------------------------------------------------------- #
def _router_replay(device, quant=False):
    """The reduced smollm-360m (port init from seed 0 on the CPU, its
    tied head scaled 16x) behind the port's ServiceRouter on ``device``:
    a markov trace of 16 calls over 6 contexts, 2 apps at 1:1,
    decode_batch 4, slice_steps 4, prediction on, a budget of three raw
    chunks.  -> (log of completions (ctx, tokens, preemptions, bits) and
    evictions in order, every greedy pick in the order made as
    ((ctx, its call's index on the ctx, step), logits row on the CPU),
    run_trace's stats)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.scheduler import ServiceRouter
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.launch.serve import run_trace
    from repro_torch.models.registry import build_model
    from repro_torch.trace.synth import synthesize
    cfg = reduced(get_config("smollm-360m"))
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params["embed"] = (params["embed"].float() * 16).bfloat16()
    params = {k: ({n: w.to(device) for n, w in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    model = build_model(cfg, device=device)
    raw_chunk = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    sc = LLMSConfig(max_ctx_len=128, memory_budget=3 * raw_chunk,
                    decode_batch=4, quant_resident=quant,
                    swap_dir=tempfile.mkdtemp())
    events = synthesize(6, 16, cfg.vocab, pattern="markov", scale=0.05,
                        seed=2)
    log, picks = [], []
    rows, calls, steps = [], {}, {}
    with LLMService(model, params, sc, device=device) as svc:
        exe, res = svc.exe, svc.res
        begin, decode_round = svc.begin_call, svc._decode_round_paged

        def on_call(stub, request):
            rows[:] = [stub.ctx_id]
            calls[stub.ctx_id] = calls.get(stub.ctx_id, 0) + 1
            return begin(stub, request)

        def on_round(live, fed):
            rows[:] = [st.ctx.cid for st in live]
            return decode_round(live, fed)

        svc.begin_call, svc._decode_round_paged = on_call, on_round
        for entry in ("paged_extend", "paged_decode"):
            fn = getattr(exe, entry)

            def rec(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                lg = torch.as_tensor(np.asarray(out[1], np.float32))
                for cid, row in zip(rows, lg.reshape(-1, lg.shape[-1])):
                    call = (cid, calls[cid] - 1)
                    steps[call] = steps.get(call, -1) + 1
                    picks.append((call + (steps[call],), row))
                return out

            setattr(exe, entry, rec)
        evict = res.evict

        def ev(key):
            log.append(("evict", tuple(int(k) for k in key)))
            return evict(key)

        res.evict = ev
        with ServiceRouter(svc, predict=True, slice_steps=4) as router:
            def done(job, cancelled):
                cid = job["stub"].ctx_id
                ch = sorted(svc.contexts[cid].chunks.items())
                log.append(("done", cid, tuple(job["stream"].tokens),
                            job["stream"].n_preempts,
                            tuple(m.bits for _, m in ch),
                            tuple(m.quant for _, m in ch)))

            router.on_complete = done
            stats = run_trace(router, events, n_apps=2, priority_mix="1:1",
                              max_new=6)
    return log, picks, stats


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "quant"])
def test_cuda_router_matches_cpu(card, quant):
    """The port's router on the card against the same port on the CPU:
    equal bit plans, quant flags and evictions, and equal tokens wherever
    the CPU run's top-2 gap exceeds the card-vs-CPU logit difference at
    that step.  Both runs make their greedy picks in the same order, call
    by call.  If a pick differs, it must be a near-tie: the logits of the
    two picked tokens moved between the runs by no more than any logit
    did over all the picks before it (the runs' ordinary difference on
    equal inputs); and the logs must agree up to that call's completion,
    which differs from the CPU run's in its tokens only.  A same-seed
    rerun on the card is identical."""
    log_c, pk_c, st_c = _router_replay("cpu", quant)
    log_g, pk_g, st_g = _router_replay("cuda", quant)
    log_r, pk_r, _ = _router_replay("cuda", quant)
    assert log_r == log_g
    assert [k for k, _ in pk_r] == [k for k, _ in pk_g]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(pk_r, pk_g))
    assert st_g["failed_calls"] == st_c["failed_calls"] == 0
    assert st_g["router"]["tokens_per_round"] > 1.0
    assert len(pk_c) == len(pk_g)
    flip, err_before = None, 0.0
    for (key_c, a), (key_g, b) in zip(pk_c, pk_g):
        assert key_c == key_g
        assert torch.isfinite(b).all()
        d = (a - b).abs()
        t_c, t_g = int(a.argmax()), int(b.argmax())
        if t_c != t_g:
            flip = key_c
            break
        err_before = max(err_before, float(d.max()))
    if flip is None:
        assert log_g == log_c
    else:
        gap = float(a[t_c] - a[t_g])
        moved = (float(d[t_c]), float(d[t_g]))
        assert max(moved) <= err_before, (flip, gap, moved, err_before)
        cid, k = flip[:2]
        n = [i for i, e in enumerate(log_c)
             if e[0] == "done" and e[1] == cid][k]
        assert log_g[:n] == log_c[:n]
        assert log_g[n][:2] == log_c[n][:2] and log_g[n][2] != log_c[n][2]
        assert log_g[n][3:] == log_c[n][3:]


@pytest.mark.cuda
def test_cuda_serve_main_on_the_card(card, capsys):
    """``python -m repro_torch.launch.serve`` without ``--device`` runs
    on the card: the reduced smollm-360m from its seeded init, the
    threaded router, quant-resident, every call served."""
    import json
    from repro_torch.launch import serve
    stats = serve.main(["--reduced", "--calls", "8", "--contexts", "3",
                        "--max-ctx", "512", "--concurrency", "2",
                        "--decode-batch", "4", "--slice-steps", "4",
                        "--quant-resident"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == stats["failed_calls"] == 0
    assert printed["device"].startswith("cuda")
    assert printed["router"]["foreground"]["calls"] \
        + printed["router"]["background"]["calls"] == 8


# --------------------------------------------------------------------- #
# the MLA + MoE family (deepseek-v2-lite-16b)
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_cuda_mla_matches_cpu(card, layout):
    """The reduced deepseek-v2-lite on the card (``attn_density`` at Dqk
    24 / Dv 16, one launch a layer of each recompute) against the same
    port on the CPU: a recompute with the density, then four absorbed
    decode steps; logits and latents at bf16 level (2% of range), the
    density and the masses within 1e-3.  The check is
    ``chip_smoke.py``'s ``_check_mla``, which raises where they
    differ."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    diffs = smoke._check_mla((layout,))[layout]
    assert set(diffs) == {"logits", "latents", "density", "mass"}


@pytest.mark.cuda
def test_cuda_rwkv6_matches_cpu(card):
    """The reduced rwkv6 on the card against the same port on the CPU
    from the same weights: the chunked-parallel prefill, 8 sequential
    decode steps and a recompute continuing the carried state (logits
    within 2% of their range and the wkv state within 1%: bf16
    projections feed the state), and ``_wkv_chunked`` on the same fp32
    inputs at the full width's heads (within 1e-5 of the range; with
    TF32 allowed, a control that must break that limit); no kernel of the port launched.  The
    check is ``chip_smoke.py``'s ``_check_rwkv6``, which raises where
    they differ."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert set(smoke._check_rwkv6()) == {"logits", "wkv", "wkv_chunked_out",
                                         "wkv_chunked_state"}


@pytest.mark.cuda
def test_cuda_serve_main_serves_mla_at_full_width(card, capsys):
    """``launch.serve.main --arch deepseek-v2-lite-16b`` on the card at
    full width (27 layers, 64 experts, vocab 102,400; ~32 GB of random
    bf16 weights): slot caches, every call served, attn_density in every
    recompute."""
    import json
    from repro_torch.kernels import attn_density as kad
    from repro_torch.launch import serve
    kad.reset_launches()
    stats = serve.main(["--arch", "deepseek-v2-lite-16b", "--calls", "4",
                        "--contexts", "2", "--max-ctx", "512",
                        "--max-new", "4", "--decode-batch", "2"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == stats["failed_calls"] == 0
    assert printed["device"].startswith("cuda") and not printed["paged_pool"]
    assert kad.attn_density.launches > 0
    assert kad.attn_density.launches % 27 == 0
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# the slot engine (paged_pool=False): the Fig.-8 pipelined restore
# --------------------------------------------------------------------- #
def _slot_service(policy="llms", **kw):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.service import LLMService, LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sc = LLMSConfig(policy=policy, paged_pool=False, max_ctx_len=64,
                    swap_dir=tempfile.mkdtemp(), **kw)
    return LLMService(model, params, sc, device="cuda"), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["llms", "swap", "lmk"])
def test_cuda_slot_policies_restore_on_the_card(card, policy):
    """The reduced llama2-7b on slot caches under a tight budget: under
    ``llms`` (unprofiled: the heaviest half of each restore recomputes)
    at least one switch-in runs the layer-pipelined restore, with
    attn_density launched while it runs; ``swap`` reads whole-state
    snapshots back and ``lmk`` recomputes killed contexts.  A rerun
    gives the same tokens."""
    from repro_torch.kernels import attn_density as kad
    runs = []
    for _ in range(2):
        svc, cfg = _slot_service(policy, memory_budget=12_000)
        exe, pipes = svc.exe, []
        run_pipe = exe.run_pipelined

        def counted(*a, **k):
            ad0 = kad.attn_density.launches
            out = run_pipe(*a, **k)
            pipes.append((kad.attn_density.launches - ad0,
                          dict(exe.last_pipelined)))
            return out

        exe.run_pipelined = counted
        rng = np.random.default_rng(0)
        with svc:
            stubs = [svc.newLLMCtx() for _ in range(3)]
            toks = [svc.callLLM(stubs[i % 3], rng.integers(1, 512, 14)
                                .tolist(), 4)[1] for i in range(9)]
            st = svc.stats()
        assert all(len(t) == 4 for t in toks) and not st["paged_pool"]
        if policy == "llms":
            assert pipes and all(n == cfg.n_layers for n, _ in pipes)
            assert all(p["wall_s"] >= p["feed_wait_s"] >= 0
                       for _, p in pipes)
        if policy != "lmk":
            assert st["disk_bytes_read"] > 0
        runs.append(toks)
    assert runs[0] == runs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["window", "mixed"])
def test_cuda_pipelined_equals_io_then_recompute(card, quant, tmp_path):
    """On the card, from one prefilled cache: chunks 0 and 3 read from
    chunk files (8 and 16 bits) and chunk 2 recomputed give the same K/V
    bit for bit through the layer-pipelined restore (page-locked feed
    buffers, copies without blocking) and through whole-file inserts
    followed by ``extend_nod``."""
    from repro_torch.core.restore import (LayerFeed, read_chunk_file,
                                          write_chunk_file)
    svc, cfg = _slot_service(quant_resident=quant, memory_budget=1 << 30)
    with svc:
        exe, res, cs = svc.exe, svc.res, svc.exe.cs
        toks = np.random.default_rng(3).integers(1, 512, 64).astype(np.int32)
        full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
        if quant:
            qc = res._make_payload(full, 1, 8, quant=True)
            exe.codec.scatter_quant(
                full, exe._t(exe.chunk_positions([1])),
                {n: torch.from_numpy(qc.data[n][0]).cuda() for n in "kv"},
                {n: torch.from_numpy(qc.data[n][1]).cuda() for n in "kv"})
        io_idx, re_idx, paths = [0, 3], [2], []
        for i, bits in zip(io_idx, (8, 16)):
            p = str(tmp_path / f"c{i}")
            write_chunk_file(p, res._make_payload(full, i, bits),
                             exe.n_layers)
            paths.append(p)
        hole = exe._t(exe.chunk_positions(io_idx + re_idx))
        miss_b = exe.bucket_pad(exe.chunk_positions(re_idx), exe.pad_slot)
        toks_b = exe.bucket_pad(toks[exe.chunk_positions(re_idx)], 0)

        def holes():
            c = {k: v.clone() for k, v in full.items()}
            for n in "kv":
                c[n][:, :, hole] = 0
            return c

        a = holes()
        feed = LayerFeed(paths, exe.codec.leaves, exe.n_layers, cs,
                         exe.leaf_dims, alloc=exe.host_alloc)
        _, h_a = exe.run_pipelined(feed, toks_b, miss_b,
                                   exe.chunk_positions(io_idx), a, 64)
        feed.close()
        b = holes()
        for i, p in zip(io_idx, paths):
            exe.codec.insert(b, i * cs, res._payload_blocks(
                read_chunk_file(p)))
        _, h_b, _ = exe.extend_nod(toks_b, miss_b, b, 64)
        torch.cuda.synchronize()
        assert torch.equal(h_a, h_b)
        for n in "kv":
            assert torch.equal(a[n][:, :, :64], b[n][:, :, :64]), n
        if quant:
            assert torch.equal(a["quant_mask"], b["quant_mask"])


# --------------------------------------------------------------------- #
# the prefill, the MoE family (llama4-maverick) and the VLM family
# --------------------------------------------------------------------- #
def _smoke():
    """``chip_smoke.py`` as a module (its card-vs-CPU checks)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama2-7b", "deepseek-v2-lite-16b"])
def test_cuda_prefill_matches_cpu(card, name):
    """``prefill`` of the reduced dense and MLA models on the card
    (``attn_density`` in the served form and, with a window, the flash
    form, one launch a layer) against the same port on the CPU: logits
    and K/V (latents) within 2% of their range, the density within
    1e-3; MLA's routing held to the CPU's at expert near-ties.  The
    check is ``chip_smoke.py``'s ``_check_prefill``, which raises where
    they differ."""
    out = _smoke()._check_prefill((name,))[name]
    assert set(out) == {"served", "flash", "flash_density"}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["window", "mixed"])
def test_cuda_moe_matches_cpu(card, layout):
    """The reduced llama4-maverick on the card (``attn_density`` in the
    recompute; over the mixed cache ``decode_mqattn`` in each decode
    step) against the same port on the CPU: logits and K/V within 2% of
    their range, the density and the masses within 1e-3, routing held to
    the CPU's at expert near-ties.  The check is ``chip_smoke.py``'s
    ``_check_moe``."""
    diffs = _smoke()._check_moe((layout,))[layout]
    assert set(diffs) == {"logits", "kv", "density", "mass"}


@pytest.mark.cuda
def test_cuda_vlm_matches_cpu(card):
    """The reduced llama-3.2-vision (gates opened) on the card against
    the same port on the CPU: two prefills with patches (served and
    flash forms of ``attn_density``) and 8 decode steps; logits, K/V and
    image K/V within 2% of their range, the density within 1e-3.  The
    check is ``chip_smoke.py``'s ``_check_vlm``."""
    diffs = _smoke()._check_vlm()
    assert {"logits", "xk", "xv", "density"} <= set(diffs)


@pytest.mark.cuda
def test_cuda_encdec_matches_cpu(card):
    """The reduced whisper-base (biases drawn) on the card against the
    same port on the CPU: a prefill with frames and the density (one
    attn_density launch a decoder layer) and 8 decode steps; logits,
    K/V and cross K/V within 2% of their range, the density within
    1e-3.  The check is ``chip_smoke.py``'s ``_check_encdec``."""
    diffs = _smoke()._check_encdec()
    assert {"logits", "xk", "xv", "density"} <= set(diffs)


@pytest.mark.cuda
def test_cuda_rglru_matches_cpu(card):
    """The reduced recurrentgemma-2b on the card against the same port
    on the CPU: prefills of 96 (served form under the window) and 2,100
    tokens (flash form) with the density and 8 decode steps; logits,
    K/V, conv and lru state within 2% of their range, the density
    within 1e-3.  The check is ``chip_smoke.py``'s ``_check_rglru``."""
    diffs = _smoke()._check_rglru()
    assert {"logits", "conv", "lru", "long_logits", "density"} <= set(diffs)


@pytest.mark.cuda
def test_cuda_serve_main_serves_moe(card, capsys):
    """``launch.serve.main --arch llama4-maverick-400b-a17b --reduced
    --quant-resident`` on the card: slot caches, every call served,
    attn_density in every extend and decode_mqattn over the mixed slot
    cache."""
    import json
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.launch import serve
    kad.reset_launches()
    kmq.reset_launches()
    stats = serve.main(["--arch", "llama4-maverick-400b-a17b", "--reduced",
                        "--calls", "6", "--contexts", "3", "--max-ctx",
                        "512", "--max-new", "4", "--decode-batch", "2",
                        "--quant-resident"])
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert printed["failed_calls"] == stats["failed_calls"] == 0
    assert printed["device"].startswith("cuda") and not printed["paged_pool"]
    assert kad.attn_density.launches > 0 and kad.attn_density.launches % 4 == 0
    assert kmq.decode_mqattn.launches > 0


# --------------------------------------------------------------------- #
# The training path: attn_density's row stats (the forward of
# flash_attention), flash_attention's gradients, the train step and
# launch.train.main.  Tolerances: out as above; m within 1e-5 of
# max(1, max |m|) and l within 1e-5 relative (fp32 in both, sums in
# another order); gradients and losses as chip_smoke.py's checks.
# --------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("window,n_sinks", [(0, 0), (16, 2), (8, 0)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dqk,dv,seq_len,n_pad", [
    (2, 37, 100, 4, 4, 16, 16, 90, 4),       # G 1, hd 16, ragged tiles
    (1, 50, 200, 16, 2, 80, 80, 180, 8),     # G 8, hd 80
    (1, 24, 300, 64, 1, 64, 64, 250, 0),     # G 64
    (1, 64, 512, 32, 8, 128, 128, 200, 24),  # G 4, hd 128
    (1, 640, 1024, 16, 16, 192, 128, 1000, 0),  # 64-row tiles at 192/128
    (1, 64, 512, 10, 1, 256, 256, 200, 24),  # HDQ 256: V in halves
    (1, 1400, 1400, 10, 1, 256, 256, 1400, 0),  # and on 64-row tiles
    (1, 20, 64, 4, 4, 32, 32, 40, 10),       # pads that see no key
])
def test_cuda_attn_density_row_stats_match_plain_version(
        card, B, Sq, Sk, H, KV, dqk, dv, seq_len, n_pad, window, n_sinks):
    """The row-stats variant (``return_stats``) against its plain
    version: out, m and l; a rerun bit-identical (``chip_smoke.py``'s
    ``_stats_check``).  Pads past seq_len under a window see no key: m =
    NEG_INF, l = Sk in both."""
    args = _extend_case(B, Sq, Sk, H, KV, dqk, seq_len, n_pad, card,
                        seed=Sq + dqk, dv=dv)
    _smoke()._stats_check(args, seq_len, window, n_sinks, "edge case")


@pytest.mark.cuda
def test_cuda_row_stats_count_launches_and_refuse_other_forms(card):
    from repro_torch.kernels import attn_density as kad
    args = _extend_case(1, 16, 64, 4, 2, 16, 64, 0, card)
    kad.reset_launches()
    kad.attn_density(*args, 64, 0, 0, False, "flash", True)
    assert (kad.attn_density.launches, kad.attn_density.stats_launches,
            kad.attn_density.density_launches) == (1, 1, 0)
    for want, form in ((True, "flash"), (False, "served")):
        with pytest.raises(ValueError, match="row stats"):
            kad.attn_density(*args, 64, 0, 0, want, form, True)
    assert kad.attn_density.launches == 1


@pytest.mark.cuda
def test_cuda_flash_attention_grads_match_cpu(card):
    """``flash_attention``'s out and dq, dk, dv on the card (the row-stats
    kernel forward) against the CPU (its plain version): out within two
    bf16 ulps, gradients within 2% of their largest values
    (``chip_smoke.py``'s ``_check_flash_grads``)."""
    errs = _smoke()._check_flash_grads()
    assert len(errs) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name,S", [("smollm-360m", 24),
                                    ("smollm-360m", 2100),
                                    ("recurrentgemma-2b", 2100)])
def test_cuda_loss_and_grads_match_cpu(card, name, S):
    """The reduced model's ``loss`` and per-leaf gradients on the card
    against the CPU, the row-stats kernel launched twice an attention
    layer above 2,048 tokens (``chip_smoke.py``'s
    ``_check_train_families``)."""
    out = _smoke()._check_train_families(((name, S),))
    assert out[f"{name} S {S}"][3] == (0 if S < 2048 else
                                       8 if name == "smollm-360m" else 2)


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(card):
    """One ``make_train_step`` step of the reduced smollm-360m (fp32 and
    8-bit moments) on the card against the CPU from the same weights:
    loss and grad norm within 1e-3 relative, the updated parameters
    within 2 lr + 2 bf16 ulps (Adam's first step moves an entry by about
    lr times the sign of its gradient)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.train import batch_to, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import OptConfig, init_state, tree_leaves
    cfg = reduced(get_config("smollm-360m"))
    batch = SyntheticLM(vocab=cfg.vocab, seq=32, batch=4).batch_for_step(0)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    for quantized in (False, True):
        opt = OptConfig(lr=1e-3, warmup_steps=1, quantized=quantized)
        s_c, m_c = make_train_step(cpu, opt)(init_state(params, opt),
                                             batch_to(batch, "cpu"))
        p_g = {k: (v.cuda() if not isinstance(v, dict) else
                   {n: t.cuda() for n, t in v.items()})
               for k, v in params.items()}
        s_g, m_g = make_train_step(gpu, opt)(init_state(p_g, opt),
                                             batch_to(batch, "cuda"))
        for k in ("loss", "grad_norm"):
            assert abs(float(m_g[k]) - float(m_c[k])) <= \
                1e-3 * abs(float(m_c[k]))
        for a, b in zip(tree_leaves(s_c["params"]),
                        tree_leaves(s_g["params"])):
            a, b = a.float(), b.float().cpu()
            ulp = 2.0 ** (float(torch.log2(a.abs().max()).floor()) - 7)
            assert float((a - b).abs().max()) <= 2 * 1e-3 + 2 * ulp


@pytest.mark.cuda
def test_cuda_train_main_on_the_card(card, tmp_path):
    """``launch.train.main`` on the card (its default device), the
    reduced smollm-360m at 2,100 tokens (flash_attention: 2 row-stats
    launches a layer and step) with a checkpoint and a resume; finite
    losses, the resumed steps within 1e-4 of the uninterrupted run's."""
    from repro_torch.kernels import attn_density as kad
    from repro_torch.launch import train
    base = ["--reduced", "--seq", "2100", "--batch", "1", "--ckpt-every",
            "2"]
    kad.reset_launches()
    full = train.main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "a")])
    assert kad.attn_density.stats_launches == 4 * 2 * 4
    train.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")])
    rest = train.main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "b"), "--resume"])
    assert np.isfinite(full["losses"]).all() and len(rest["losses"]) == 2
    np.testing.assert_allclose(rest["losses"], full["losses"][2:], rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_name,seq,batch,kv,kernel", [
    ("decode_32k", 4096, 128, "int8", "decode_qattn"),
    ("long_500k", 9000, 1, "int8", "decode_qattn"),
    ("prefill_32k", 2100, 32, "bf16", "attn_density_with_density"),
    ("train_4k", 2100, 32, "bf16", "attn_density_stats")])
def test_cuda_dryrun_share_runs_the_kernels(card, shape_name, seq, batch,
                                            kv, kernel):
    """``launch.dryrun``'s --run on the card for the reduced smollm-360m
    at shorter sequences: the share's entry launches its kernel once a
    layer (the train step: twice a layer on each split) and passes its
    holds against the plain versions."""
    from repro_torch.configs import SHAPES, ShapeSpec, get_config, reduced
    from repro_torch.launch import dryrun
    cfg = reduced(get_config("smollm-360m"))
    shape = ShapeSpec(shape_name, SHAPES[shape_name].kind, seq, batch)
    rec = dryrun.run_cell("smollm-360m", shape_name, False, None,
                          kv_dtype=kv, run=True, device="cuda", cfg=cfg,
                          shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    one = rec["one_card"]
    per_layer = 2 * rec["n_micro"] if kernel == "attn_density_stats" else 1
    assert one["launches"][kernel] == per_layer * cfg.n_layers
    assert one["peak_bytes"] > 0 and one["reduced"] == []


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["served", "flash"])
@pytest.mark.parametrize("seq_len", [48, 200, 512])
def test_cuda_attn_density_reads_seq_len_on_the_device(card, seq_len, form):
    """The tile kernel given ``seq_len`` as a 0-d int32 CUDA tensor (the
    pointer its launches read, as serving's extend passes it) gives the
    bytes of the same call by value, out and density, at serving's
    extend shape (the flash form at head dim 80, where it runs the tile
    kernel too)."""
    from repro_torch.kernels import attn_density as kad
    hd = 128 if form == "served" else 80
    assert kad.route(form, hd, hd) == "mma"
    args = _extend_case(1, 64, 512, 32, 8, hd, seq_len, 24, card, seed=3)
    dev_len = torch.tensor(seq_len, dtype=torch.int32, device=card)
    c = [a.contiguous() for a in args[:3]] + [args[3].to(torch.int32)]
    for want in (True, False):
        by_value = kad.attn_density(*c, seq_len, 0, 0, want, form)
        on_device = kad.attn_density(*c, dev_len, 0, 0, want, form)
        for a, b in zip(by_value, on_device):
            assert (a is None and b is None) or torch.equal(a, b)
    if form == "served":
        with pytest.raises(ValueError):       # a 0-d int64 is refused
            kad.attn_density(*c, dev_len.long(), 0, 0, True, form)


def _graph_executor(quant, device="cuda"):
    """The reduced llama2-7b's executor on the card (seeded weights) with
    its arenas filled with seeded random pages, and page-table rows of
    four contexts whose chunks up to position 40 hold distinct bf16
    pages (chunk 0 also an int8 page, in the quant mask, under
    quant_resident).  -> (exe, arenas, (pt16, pt8 | None, qmask |
    None))."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.executor import ModelExecutor
    from repro_torch.core.service import LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config("llama2-7b"))
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sc = LLMSConfig(max_ctx_len=64, decode_batch=4, quant_resident=quant,
                    pool_pages_16=40, pool_pages_8=12)
    exe = ModelExecutor(model, params, sc, device)
    arenas = exe.init_arenas()
    g = torch.Generator(device=device).manual_seed(1)
    for n, t in arenas.items():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=device, dtype=torch.int8))
        elif t.dtype == torch.float32:
            t.copy_(torch.rand(t.shape, generator=g, device=device) * 0.007
                    + 0.01)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=device))
    C = exe.pages_per_ctx
    pt16 = np.zeros((4, C), np.int32)
    pt16[:, :3] = np.arange(1, 13).reshape(4, 3)
    rows = (pt16, None, None)
    if quant:
        pt8 = np.zeros((4, C), np.int32)
        pt8[:, 0] = np.arange(1, 5)
        qmask = np.zeros((4, C), bool)
        qmask[:, 0] = True
        rows = (pt16, pt8, qmask)
    return exe, arenas, rows


def _graph_calls(exe, arenas, rows):
    """Two token buckets of paged_extend and two batch buckets of
    paged_decode."""
    pt16, pt8, qmask = rows
    rng = np.random.default_rng(2)
    for M, n0 in ((13, 20), (30, 4)):              # buckets 16 and 32
        exe.paged_extend(arenas, rng.integers(1, 512, M), n0, pt16[:1],
                         None if pt8 is None else pt8[:1],
                         None if qmask is None else qmask[:1])
    for n in (1, 3):                               # buckets 1 and 4
        exe.paged_decode(arenas, rng.integers(1, 512, n).tolist(),
                         [33 + i for i in range(n)], pt16[:n],
                         None if pt8 is None else pt8[:n],
                         None if qmask is None else qmask[:n])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_graph_replay_equals_eager_body(card, quant):
    """Every bucket is captured with the arenas; every call on the card
    is a replay of its bucket's graph, and each graph replayed on its
    last staged inputs gives its eager body's logits, density or mass
    and arena bytes, bit for bit."""
    exe, arenas, rows = _graph_executor(quant)
    # every bucket captured with the arenas, before any call
    assert exe.graphs.stats()["captures"] == {
        f"{e}/{b}/{quant}": 1 for e, bs in (("extend", exe.tok_buckets),
                                            ("decode", exe.batch_buckets))
        for b in bs}
    _graph_calls(exe, arenas, rows)
    before = {n: t.clone() for n, t in arenas.items()}
    # chip_smoke.py's gate: replays = calls, and every graph replayed
    # against its eager body bit for bit (it raises where they differ)
    stats = _smoke().graph_check(exe, arenas, "test")
    assert stats["calls"] == stats["replays"] == 4
    assert sorted(stats["held"]) == sorted(stats["captures"])
    for n, t in arenas.items():                # the arenas put back
        assert torch.equal(t.view(torch.uint8), before[n].view(torch.uint8))


@pytest.mark.cuda
def test_cuda_graph_replays_credit_launch_counts(card):
    """A captured call counts what its eager body counts (attn_density
    once a layer an extend, decode_mqattn once a layer a quant-resident
    round); warm-up and capture count nothing."""
    from repro_torch import kernels
    exe, arenas, rows = _graph_executor(True)
    L = exe.n_layers
    kernels.reset_launch_counts()
    _graph_calls(exe, arenas, rows)                # 4 replays
    got = kernels.launch_counts()
    assert got["attn_density"] == got["attn_density_with_density"] == 2 * L
    assert got["decode_mqattn"] == 2 * L
    _graph_calls(exe, arenas, rows)                # replays only
    got = kernels.launch_counts()
    assert got["attn_density"] == 4 * L and got["decode_mqattn"] == 4 * L
    for key in exe.graphs.keys():
        kernels.reset_launch_counts()
        exe.graphs.entry(key).eager()
        eager = {k: n for k, n in kernels.launch_counts().items() if n}
        assert eager == exe.graphs.entry(key).launches, key


@pytest.mark.cuda
def test_cuda_capture_of_a_host_sync_raises(card):
    """A body that reads a device value on the host (``.item()``) makes
    the capture raise: nothing runs it eagerly in the graph's place."""
    from repro_torch import kernels
    from repro_torch.core import graphs
    cache = graphs.GraphCache("cuda")
    arenas = {"k16": torch.zeros(4, device="cuda")}

    def body(inp):
        return (inp["x"] * int(inp["x"].sum().item()),)

    before = kernels.launch_counts()
    with pytest.raises(RuntimeError):
        cache.run(arenas, ("extend", 16, False), {"x": ((4,), torch.int64)},
                  lambda: graphs.capturable(body), {"x": np.arange(4)})
    assert cache.replays == 0 and kernels.launch_counts() == before
    entry = cache.entry(("extend", 16, False))
    assert entry is None or entry.graph is None
    torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# the slot engine's CUDA graphs (core/graphs.py over the slot caches)
# --------------------------------------------------------------------- #
def _slot_executor(name, quant=False, device="cuda"):
    """The reduced ``name``'s slot-engine executor on the card (seeded
    weights), ``decode_batch`` 2: its slot caches and, on the card,
    every slot's graphs made by ``init_slots``.  -> exe."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.executor import ModelExecutor
    from repro_torch.core.service import LLMSConfig
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config(name))
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    sc = LLMSConfig(paged_pool=False, max_ctx_len=64, decode_batch=2,
                    quant_resident=quant)
    exe = ModelExecutor(model, params, sc, device)
    exe.init_slots()
    return exe


def _slot_calls(exe):
    """On each decode slot: an extend (a bucket, or for a family that is
    not pad_safe an exact length), two decode tokens; on the scratch
    slot the extend_nod of a restore where the family recomputes, and
    an extend.  -> the number of calls."""
    rng = np.random.default_rng(3)
    n = 0
    for slot in range(exe.decode_slots):
        cache = exe.fresh_cache(0, slot)
        exe.extend(cache, rng.integers(1, 512, 13 + 11 * slot), 0)
        for tok in rng.integers(1, 512, 2):
            exe.decode(cache, int(tok))
        n += 3
    scratch = exe.fresh_cache(40, exe.scratch_slot)
    if exe.recomputable and exe.chunked_cache:
        pos = exe.bucket_pad(np.arange(16, 32, dtype=np.int32),
                             exe.pad_slot)
        exe.extend_nod(rng.integers(1, 512, len(pos)), pos, scratch, 40)
        n += 1
    exe.extend(scratch, rng.integers(1, 512, 9), 40)
    return n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name,quant", [("llama2-7b", False),
                                        ("llama2-7b", True),
                                        ("deepseek-v2-lite-16b", False),
                                        ("rwkv6-1.6b", False)])
def test_cuda_slot_graph_replay_equals_eager_body(card, name, quant):
    """Every slot's graphs are captured when the slots are made (a
    family that is not pad_safe: its decode; its extends at their first
    length); every slot call on the card is a replay, none runs eagerly,
    and each graph replayed on its last staged inputs gives its eager
    body's outputs and every slot-cache byte, bit for bit
    (``chip_smoke.graph_check``)."""
    exe = _slot_executor(name, quant)
    ahead = {f"{e}/{b}/{quant}/{s}" for s in exe.slot_caches
             for e, b in exe._slot_ahead(s)}
    assert set(exe.graphs.stats()["captures"]) == ahead
    n = _slot_calls(exe)
    before = {s: {k: t.clone() for k, t in c.items()}
              for s, c in exe.slot_caches.items()}
    stats = _smoke().graph_check(exe, None, "test")
    assert stats["calls"] == stats["replays"] == n
    assert stats["eager_calls"] == 0
    assert stats["late_captures"] == (0 if exe.pad_safe else 3)
    for s, c in exe.slot_caches.items():       # the slots put back
        for k, t in c.items():
            assert torch.equal(t, before[s][k]), (s, k)


@pytest.mark.cuda
def test_cuda_slot_graph_replays_credit_launch_counts(card):
    """A slot replay counts what its eager body counts: attn_density once
    a layer an extend or extend_nod, decode_mqattn once a layer a decode
    over the mixed cache; capture and warm-up count nothing."""
    from repro_torch import kernels
    exe = _slot_executor("llama2-7b", quant=True)
    L = exe.n_layers
    kernels.reset_launch_counts()
    _slot_calls(exe)                   # 3 extends, 1 extend_nod, 4 tokens
    got = kernels.launch_counts()
    assert got["attn_density"] == 4 * L
    assert got["attn_density_with_density"] == 3 * L
    assert got["decode_mqattn"] == 4 * L
    for key in exe.graphs.keys():
        kernels.reset_launch_counts()
        exe.graphs.entry(key).eager()
        eager = {k: n for k, n in kernels.launch_counts().items() if n}
        assert eager == exe.graphs.entry(key).launches, key


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama2-7b", "deepseek-v2-lite-16b",
                                  "rwkv6-1.6b"])
def test_cuda_slot_decode_replays_without_a_host_sync(card, name):
    """A slot decode's replay (its inputs staged) does not synchronize
    with the host: ``ring_update`` writes at the position on the
    device."""
    exe = _slot_executor(name)
    cache = exe.fresh_cache(5, 0)
    exe.decode(cache, 7)
    entry = exe.graphs.entry(("decode", 1, False, 0))
    entry.stage({"toks": np.int64([[9]])})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        entry.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(cache["pos"]) == 7


@pytest.mark.cuda
def test_cuda_capture_is_not_broken_by_dropped_graphs(card):
    """Graphs of a dropped executor that only the cyclic collector can
    free are not collected inside another executor's capture (destroying
    a graph while the stream captures invalidates the capture), however
    often the collector runs."""
    import gc
    old = _slot_executor("llama2-7b")
    old.cycle = old                # unreachable only through the collector
    del old
    threshold = gc.get_threshold()
    gc.set_threshold(50, 1, 1)     # a full collection every 50 allocations
    try:
        exe = _slot_executor("llama2-7b")
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    assert sum(exe.graphs.stats()["captures"].values()) == sum(
        len(exe._slot_ahead(s)) for s in exe.slot_caches)
    cache = exe.fresh_cache(0, 0)
    exe.extend(cache, np.arange(1, 14), 0)
    assert exe.graphs.replays == 1


# --------------------------------------------------------------------- #
# the Fig.-8 pipelined restore as captured graphs: csrc/feed_gate.cu
# --------------------------------------------------------------------- #
@pytest.mark.cuda
def test_cuda_feed_gate_matches_plain_version(card):
    """The gate kernel and ``feed_gate_plain`` on the same page-locked
    words give the same status: 0 on the generation (also generation 0
    on a zero word), 1 on its negative, 2 on an older generation past
    the deadline (having waited at least that long), none where the
    status is already set; and 0 for a word another thread publishes
    while the kernel waits, the wait about as long as that thread's
    delay."""
    import threading
    from repro_torch.kernels import feed_gate as kfg
    from repro_torch.kernels.ref import feed_gate_plain
    L = 8
    flags = torch.zeros((L,), dtype=torch.int32, pin_memory=True)
    publish = kfg.publisher(flags)

    def gate(dev, layer, gen, deadline_ms, status0=0):
        status = torch.full((1,), status0, dtype=torch.int32, device=dev)
        wait = torch.zeros((L,), dtype=torch.int64, device=dev)
        fn = kfg.feed_gate if dev.type == "cuda" else feed_gate_plain
        fn(flags, layer, torch.tensor(gen, dtype=torch.int32, device=dev),
           torch.tensor(int(deadline_ms * 1e6), dtype=torch.int64,
                        device=dev), status, wait)
        torch.cuda.synchronize()
        return int(status[0]), int(wait[layer]) / 1e6

    cpu = torch.device("cpu")
    for layer, word, gen, deadline, status0, want in (
            (0, 5, 5, 5000, 0, 0), (1, -5, 5, 5000, 0, 1),
            (2, 4, 5, 20, 0, 2), (3, 0, 0, 0, 0, 0), (4, 4, 5, 5000, 1, 1)):
        publish(layer, word)
        (sk, wk), (sp, wp) = (gate(card, layer, gen, deadline, status0),
                              gate(cpu, layer, gen, deadline, status0))
        assert sk == sp == want, (layer, sk, sp)
        if want == 2:
            assert wk >= 20 and wp >= 20
        if status0:
            assert wk == wp == 0
    publish(5, 4)
    timer = threading.Timer(0.05, publish, (5, 5))
    timer.start()
    status, waited = gate(card, 5, 5, 5000)
    timer.join()
    assert status == 0 and 25 <= waited < 1000


def _pipelined_setup(svc, tmp_path, quant):
    """A prefilled reduced llama2-7b cache (64 tokens; chunk 1 int8 in
    the mixed cache), chunks 0 and 3 in chunk files, chunk 2 to
    recompute.  -> (holes(), paths, toks_b, miss_b, io_pos_b, pad)."""
    from repro_torch.core.restore import write_chunk_file
    exe, res = svc.exe, svc.res
    toks = np.random.default_rng(3).integers(1, 512, 64).astype(np.int32)
    full, _, _ = exe.extend(exe.fresh_cache(0), toks, 0)
    if quant:
        qc = res._make_payload(full, 1, 8, quant=True)
        exe.codec.scatter_quant(
            full, exe._t(exe.chunk_positions([1])),
            {n: torch.from_numpy(qc.data[n][0]).cuda() for n in "kv"},
            {n: torch.from_numpy(qc.data[n][1]).cuda() for n in "kv"})
    paths = []
    for i, bits in ((0, 8), (3, 16)):
        paths.append(str(tmp_path / f"c{i}"))
        write_chunk_file(paths[-1], res._make_payload(full, i, bits),
                         exe.n_layers)
    hole = exe._t(exe.chunk_positions([0, 2, 3]))
    for n in "kv":
        full[n][:, :, hole] = 0
    miss_b = exe.bucket_pad(exe.chunk_positions([2]), exe.pad_slot)
    toks_b = exe.bucket_pad(toks[exe.chunk_positions([2])], 0)
    return ((lambda: {k: v.clone() for k, v in full.items()}), paths,
            toks_b, miss_b, exe.chunk_positions([0, 3]), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["window", "mixed"])
def test_cuda_pipelined_graph_equals_eager_body(card, quant, tmp_path):
    """A pipelined restore into a slot is one replay of the graph its
    service captured ahead, with no host sync in it; it equals the same
    body run eagerly on a private clone (its gates waiting on the card
    while the host queues the rest) and the I/O-then-recompute restore,
    bit for bit, the quant mask included; the replay credits what the
    eager body counts: attn_density and feed_gate once a layer."""
    from repro_torch import kernels
    from repro_torch.core.restore import read_chunk_file
    svc, cfg = _slot_service(quant_resident=quant, memory_budget=1 << 30)
    with svc:
        exe, L = svc.exe, cfg.n_layers
        holes, paths, toks_b, miss_b, io_pos_b, pad = _pipelined_setup(
            svc, tmp_path, quant)
        key = ("pipelined", (len(toks_b), len(io_pos_b) // exe.cs), quant, 0)
        assert "/".join(map(str, key)) in exe.graphs.stats()["captures"]
        slot = exe.fresh_cache(0, 0)
        for k, t in holes().items():
            slot[k].copy_(t)
        r0, e0 = exe.graphs.replays, exe.eager_calls
        kernels.reset_launch_counts()
        feed = exe.layer_feed(paths, pad)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, h_a = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, slot,
                                       64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        feed.close()
        graphed = {k: n for k, n in kernels.launch_counts().items() if n}
        assert exe.graphs.replays == r0 + 1 and exe.eager_calls == e0
        assert graphed == {"attn_density": L, "feed_gate": L}
        assert exe.last_pipelined["wall_s"] >= \
            exe.last_pipelined["feed_wait_s"] >= 0

        c = holes()
        kernels.reset_launch_counts()
        feed = exe.layer_feed(paths, pad)
        _, h_c = exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, c, 64)
        feed.close()
        assert exe.eager_calls == e0 + 1
        assert {k: n for k, n in kernels.launch_counts().items()
                if n} == graphed
        b = holes()
        for i, p in ((0, paths[0]), (3, paths[1])):
            exe.codec.insert(b, i * exe.cs, svc.res._payload_blocks(
                read_chunk_file(p)))
        _, h_b, _ = exe.extend_nod(toks_b, miss_b, b, 64)
        torch.cuda.synchronize()
        assert torch.equal(h_a, h_c) and torch.equal(h_a, h_b)
        for k in slot:
            assert torch.equal(slot[k], c[k]), k
        for n in "kv":
            assert torch.equal(slot[n][:, :, :64], b[n][:, :, :64]), n
        if quant:
            assert torch.equal(slot["quant_mask"], b["quant_mask"])


@pytest.mark.cuda
def test_cuda_pipelined_restore_raises_and_never_hangs(card, tmp_path):
    """On the card, a flipped byte in a layer's segment (status 1)
    raises ``RuntimeError`` from the chunk's ``ChunkCorruptError`` and
    leaves the quant mask as it was; a feed that never publishes (queued
    behind a job holding its pool's one worker; status 2) raises
    ``SwapTimeoutError`` within its deadline; the next restore runs."""
    from concurrent.futures import ThreadPoolExecutor
    import threading
    import time
    from repro_torch.core.faults import ChunkCorruptError, SwapTimeoutError
    from repro_torch.core.restore import _read_header, _segment_size
    svc, cfg = _slot_service(quant_resident=True, memory_budget=1 << 30,
                             swap_deadline_s=0.5)
    with svc:
        exe = svc.exe
        holes, paths, toks_b, miss_b, io_pos_b, pad = _pipelined_setup(
            svc, tmp_path, True)
        good = holes()
        good["quant_mask"][..., :16] = True    # chunk 0: restored from disk
        slot = exe.fresh_cache(0, 0)
        for k, t in good.items():
            slot[k].copy_(t)
        mask = slot["quant_mask"].clone()
        bad = str(tmp_path / "bad")
        with open(paths[1], "rb") as f:
            blob = bytearray(f.read())
            f.seek(0)
            header, base = _read_header(f)
        blob[base + (cfg.n_layers // 2) * _segment_size(header)] ^= 0x40
        with open(bad, "wb") as f:
            f.write(bytes(blob))
        feed = exe.layer_feed([paths[0], bad], pad)
        with pytest.raises(RuntimeError, match="LayerFeed I/O failed") as e:
            exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, slot, 64)
        assert isinstance(e.value.__cause__, ChunkCorruptError)
        assert torch.equal(slot["quant_mask"], mask)

        pool, held = ThreadPoolExecutor(max_workers=1), threading.Event()
        pool.submit(held.wait)
        try:
            feed = exe.layer_feed(paths, pad, pool=pool)
            t0 = time.perf_counter()
            with pytest.raises(SwapTimeoutError):
                exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, slot, 64)
            assert time.perf_counter() - t0 < 10
            assert torch.equal(slot["quant_mask"], mask)
            held.set()
            for k, t in good.items():
                slot[k].copy_(t)
            feed = exe.layer_feed(paths, pad, pool=pool)
            exe.run_pipelined(feed, toks_b, miss_b, io_pos_b, slot, 64)
            feed.close()
        finally:
            held.set()
            pool.shutdown(wait=True)
        assert not slot["quant_mask"][..., :16].any()
        assert torch.equal(slot["quant_mask"][..., 16:], mask[..., 16:])
