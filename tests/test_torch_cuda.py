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
                 pad_pos=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) bf16 and q_pos: the Sq - n_pad
    positions just below seq_len, then n_pad bucket-pad rows at
    ``pad_pos`` (default Sk - 1)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).bfloat16()   # noqa: E731
    n = Sq - n_pad
    pad = Sk - 1 if pad_pos is None else pad_pos
    qp = torch.tensor(list(range(seq_len - n, seq_len)) + [pad] * n_pad,
                      dtype=torch.int32)
    return [t.to(device) for t in (r(B, Sq, H, hd), r(B, Sk, KV, hd),
                                   r(B, Sk, KV, hd), qp)]


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
    ``plan``, which sizes the scratch buffers."""
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import decode_mqattn as kmq
    la, lm = kad._lib(), kmq._lib()
    for B, Sq, H, KV in ((1, 64, 32, 32), (1, 512, 32, 32), (2, 37, 4, 4),
                         (1, 24, 64, 1), (4, 64, 32, 32), (1, 2048, 32, 8)):
        assert la.attn_density_rows(B, Sq, H, KV) == kad.plan(B, Sq, H, KV)[0]
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
