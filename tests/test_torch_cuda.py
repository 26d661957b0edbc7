"""Tests of the port that need the card (marker ``cuda``); they skip
where ``torch.cuda.is_available()`` is false.  This file imports
neither JAX nor the JAX package, so it also runs on a machine with no
JAX, without the suite's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none for the codec kernels (bit-exact against their plain
PyTorch versions); bf16 level (2% of the logit range) between the card
and the CPU for the model, whose bf16 matmuls round differently.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (README.md: run on the card)")
    return torch.device("cuda")


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
