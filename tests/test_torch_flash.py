"""The flash form's kernel pair at head dims 64 and 128
(``csrc/attn_flash.cu``) on the CPU: which kernel ``route`` picks for
each caller, the plan the wrapper sizes its scratch by, and the plain
two-pass version (``kernels/ref.py::attn_flash_plain``) against the
flash form's plain version and the reference's oracle and interpret-mode
Pallas kernel.  The kernels run on the card only
(tests/test_torch_cuda.py, ``chip_smoke.py``).

Tolerances.  Against ``attn_density_plain(form="flash")`` on bf16
inputs: out within 2^-7 of max|out| (the kernels' PV takes p rounded to
bf16: two bf16 ulps), the density within 1e-5 of its largest value
(fp32 sums in another order), m equal and l within 1e-6 relative (sums
of the same fp32 terms).  Against the reference's oracle and Pallas
kernel on fp32 inputs: out within 2^-7 of max|out| (the bf16 p), the
density within the reference test's atol 2e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels import attn_density as jad
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import attn_density as kad
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


@pytest.mark.parametrize("form,dqk,dv,want", [
    ("flash", 64, 64, "wgmma"), ("flash", 128, 128, "wgmma"),
    ("served", 64, 64, "mma"), ("served", 128, 128, "mma"),
    ("flash", 192, 128, "mma"), ("served", 192, 128, "mma"),
    ("flash", 256, 256, "mma"), ("flash", 16, 16, "mma"),
    ("flash", 32, 32, "mma"), ("flash", 80, 80, "mma"),
    ("flash", 128, 64, "mma"), ("flash", 64, 128, "mma"),
])
def test_route_by_form_and_head_dims(form, dqk, dv, want):
    assert kad.route(form, dqk, dv) == want


# each family's (Dqk, Dv) as its prefill or training attention passes
# them, and the kernel its flash form runs
FAMILY_ROUTES = {
    "llama2-7b": "wgmma", "smollm-360m": "wgmma", "qwen2.5-14b": "wgmma",
    "qwen3-32b": "wgmma", "deepseek-67b": "wgmma",
    "llama-3.2-vision-90b": "wgmma", "whisper-base": "wgmma",
    "llama4-maverick-400b-a17b": "wgmma",
    "deepseek-v2-lite-16b": "mma", "recurrentgemma-2b": "mma",
}


@pytest.mark.parametrize("arch", sorted(FAMILY_ROUTES))
def test_route_of_every_family(arch):
    """The flash form of every family with attention: the dense, VLM,
    encdec and MoE families at hd 64 or 128 on the new kernel; MLA
    (128 + 64 and 128) and recurrentgemma (256) on the tile kernel; the
    served form of all of them on the tile kernel."""
    cfg = get_config(arch)
    if cfg.mla is not None:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.head_dim
    assert kad.route("flash", dqk, dv) == FAMILY_ROUTES[arch]
    assert kad.route("served", dqk, dv) == "mma"


@pytest.mark.parametrize("B,Sq,H,KV,want", [
    (1, 4096, 32, 32, (128, 32, 128, 128, 32)),     # llama2-7b's prefill
    (1, 4096, 64, 8, (128, 256, 128, 16, 256)),     # the VLM's, G 8
    (1, 4096, 15, 5, (128, 96, 128, 42, 98)),       # smollm-360m's, G 3
    (8, 4096, 15, 5, (128, 96, 128, 42, 98)),       # train_4k's split
    (2, 32768, 15, 5, (128, 768, 128, 42, 781)),    # prefill_32k
    (1, 448, 8, 8, (128, 4, 128, 128, 4)),          # whisper-base
    (1, 24, 64, 1, (128, 12, 128, 2, 12)),          # G 64
    (2, 37, 4, 2, (128, 1, 128, 64, 1)),            # one block of rows
])
def test_flash_plan(B, Sq, H, KV, want):
    """``flash_plan``: 128 rows a forward block, ceil(Sq G / 128) of them;
    128-key tiles; density query tiles of 128 // G whole queries (at
    most 128 rows, one TMA box of G heads) that cover every query."""
    plan = kad.flash_plan(B, Sq, H, KV)
    assert plan == want
    rows, n_blocks, keys, qt, n_qt = plan
    G = H // KV
    assert (n_blocks - 1) * rows < Sq * G <= n_blocks * rows
    assert qt * G <= kad.FLASH_COLS and (n_qt - 1) * qt < Sq <= n_qt * qt


def _bf16_case(B, Sq, Sk, H, KV, hd, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g).bfloat16()   # noqa: E731
    return r(B, Sq, H, hd), r(B, Sk, KV, hd), r(B, Sk, KV, hd)


FLASH_CASES = [
    # (B, Sq, Sk, H, KV, hd, q_pos, seq_len, window, n_sinks)
    (1, 96, 96, 4, 4, 64, None, None, 0, 0),           # causal, G 1
    (2, 80, 80, 15, 5, 64, None, None, 0, 0),          # G 3, B 2
    (1, 70, 70, 10, 2, 128, None, None, 24, 4),        # G 5, window
    (1, 40, 120, 16, 2, 128, list(range(60, 100)), 110, 0, 0),  # offset
    (1, 20, 64, 8, 1, 64, list(range(30, 40)) + [63] * 10, 40, 16, 0),
    (1, 20, 50, 4, 2, 128, list(range(100, 120)), 50, 4, 0),  # no key
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: str(c[:6]))
def test_flash_plain_matches_flash_form(case):
    """The two-pass plain version against ``attn_density_plain``'s flash
    form: G 1, 3, 5 and 8, a window with sinks, queries at an offset
    over more keys with seq_len < Sk, pads past seq_len that see no key
    under a window beside rows that see keys, and a call where no row
    sees a key (uniform p, zero density); with the density, with the row
    stats, and the same in query chunks of 7."""
    B, Sq, Sk, H, KV, hd, qp, seq_len, window, n_sinks = case
    q, k, v = _bf16_case(B, Sq, Sk, H, KV, hd, Sq + Sk + hd)
    qp = None if qp is None else torch.tensor(qp)
    o_r, d_r = tref.attn_density_plain(q, k, v, qp, seq_len, window,
                                       n_sinks, True, "flash")
    for chunk in (0, 7):
        o_t, d_t = tref.attn_flash_plain(q, k, v, qp, seq_len, window,
                                         n_sinks, True, q_chunk=chunk)
        span = float(o_r.float().abs().max())
        assert o_t.dtype == torch.bfloat16 and o_t.shape == o_r.shape
        assert float((o_t.float() - o_r.float()).abs().max()) <= \
            2 ** -7 * span
        assert float((d_t - d_r).abs().max()) <= \
            1e-5 * max(float(d_r.abs().max()), 1e-30)
        o_s, d_s, m_t, l_t = tref.attn_flash_plain(
            q, k, v, qp, seq_len, window, n_sinks, False, True, chunk)
        _, _, m_r, l_r = tref.attn_density_plain(q, k, v, qp, seq_len,
                                                 window, n_sinks, False,
                                                 "flash", True)
        assert d_s is None and torch.equal(o_s, o_t)
        assert torch.equal(m_t, m_r)
        assert float(((l_t - l_r).abs() / l_r).max()) <= 1e-6


def test_flash_plain_rows_that_see_no_key():
    """No row sees a key: out is the mean of V over all Sk keys (uniform
    p), m = NEG_INF, l = Sk, and the density is 0 (the flash form sums
    visible pairs only)."""
    q, k, v = _bf16_case(1, 20, 50, 4, 2, 64, 5)
    out, _, m, l = tref.attn_flash_plain(q, k, v, torch.arange(100, 120),
                                         50, 4, 0, False, True)
    assert bool((m == tref.NEG_INF).all()) and bool((l == 50).all())
    mean = v.float().mean(dim=1).repeat_interleave(2, dim=1)   # (1, H, D)
    assert float((out.float() - mean[:, None]).abs().max()) <= \
        2 ** -7 * float(mean.abs().max())
    _, d = tref.attn_flash_plain(q, k, v, torch.arange(100, 120), 50, 4)
    assert bool((d == 0).all())


REF_CASES = [
    dict(B=1, S=96, H=4, KV=2, hd=64, window=0, n_sinks=0),
    dict(B=2, S=64, H=6, KV=2, hd=128, window=0, n_sinks=0),
    dict(B=1, S=128, H=8, KV=1, hd=64, window=40, n_sinks=8),
    dict(B=1, S=80, H=10, KV=2, hd=128, window=24, n_sinks=0),
]


@pytest.mark.parametrize("case", REF_CASES,
                         ids=lambda c: "-".join(map(str, c.values())))
def test_flash_plain_matches_reference(case):
    """The two-pass plain version against the reference's oracle and its
    interpret-mode Pallas kernel (bq = bk = 32) with q_pos = arange(S),
    seq_len = S, fp32 inputs, at the new kernel's head dims."""
    c = case
    rng = np.random.default_rng(sum(c.values()))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q = f32(c["B"], c["S"], c["H"], c["hd"])
    k, v = (f32(c["B"], c["S"], c["KV"], c["hd"]) for _ in range(2))
    o_ref, d_ref = jref.attn_density_ref(q, k, v, c["window"], c["n_sinks"])
    o_pal, d_pal = jad.attn_density(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), c["window"],
                                    c["n_sinks"], interpret=True, bq=32,
                                    bk=32)
    o_t, d_t = tref.attn_flash_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=c["window"], n_sinks=c["n_sinks"], q_chunk=40)
    assert o_t.dtype == torch.float32 and d_t.shape == (c["B"], c["S"])
    for o_j, d_j in ((o_ref, d_ref), (o_pal, d_pal)):
        o_j = np.asarray(o_j)
        assert np.abs(o_t.numpy() - o_j).max() <= \
            2 ** -7 * np.abs(o_j).max()
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                                   atol=2e-4)


def test_flash_route_refuses_cpu_tensors_and_ops_takes_the_plain_form():
    """The wrapper refuses CPU tensors on the new route as on the old;
    ``ops.attn_density`` sends CPU tensors to ``attn_density_plain``
    whatever the route (the flash form as it was)."""
    q, k, v = _bf16_case(1, 16, 16, 4, 2, 64, 1)
    qp = torch.arange(16, dtype=torch.int32)
    assert kad.route("flash", 64, 64) == "wgmma"
    with pytest.raises(ValueError, match="CUDA"):
        kad.attn_density(q, k, v, qp, 16, form="flash")
    o, d = tops.attn_density(q, k, v, qp, 16, form="flash")
    o_r, d_r = tref.attn_density_plain(q, k, v, qp, 16, form="flash")
    assert torch.equal(o, o_r) and torch.equal(d, d_r)


def test_launch_counts_name_the_flash_kernels():
    """``launch_counts`` reads the flash kernel's calls and those with
    its density pass beside attn_density's own counts; reset sets them
    to 0."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    kad.attn_density.flash_launches = 3
    kad.attn_density.flash_density_launches = 2
    c = launch_counts()
    assert (c["attn_flash"], c["attn_flash_with_density"]) == (3, 2)
    reset_launch_counts()
    c = launch_counts()
    assert (c["attn_flash"], c["attn_flash_with_density"]) == (0, 0)
