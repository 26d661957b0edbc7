"""The port's training substrate against the JAX package: the flash
attention's custom gradient, the losses' cross entropies, the
optimizer, the data, the checkpoints, the train step and the entry
point (every family's ``loss``: ``tests/test_torch_train_families.py``).

Inputs are made from seeds with numpy and handed to both packages; the
models are the reduced configs from the reference's weights
(``_torch_parity.tiny_pair``).

Tolerances.
* ``flash_attention``'s forward, the flash form's plain version (p
  unrounded, PV in fp32), against the reference's ``_flash_fwd_impl``
  (p rounded to bf16 before PV) on the same bf16 inputs: out within two
  bf16 ulps of its largest value (as ``tests/test_torch_prefill.py``);
  the row stats m and l (fp32 in both, sums in another order) within
  rtol 1e-5 + atol 1e-6 x max|m| (m) and rtol 1e-5 (l).
* Its backward alone (``_flash_bwd``) on the reference's own saved
  residuals against ``_flash_vjp_bwd``: the same fp32 products in
  another order, rounded to bf16 at the end, so dq, dk, dv within one
  bf16 ulp of their largest value.  Through ``jax.vjp`` / autograd end
  to end (the port's forward saves its own out): within 2% of the
  largest value (out differs at bf16 level, and delta = rowsum(dout
  out) with it).
* ``cross_entropy`` (fp32) within 1e-6 relative, its logit gradient
  within 1e-7; ``blockwise_ce`` on bf16 activations: the port rounds
  each block's logits to bf16 as the reference's model declares them,
  the reference run eagerly does too, so against it the loss within
  rtol 1e-6 and the gradients within one bf16 ulp of their largest
  value.
* ``apply_updates`` against the jitted reference: the fp32 moments and
  the 8-bit codes and scales equal bit for bit while the gradient norm
  stays under ``clip_norm``; the parameters within one bf16 ulp (bf16)
  and 1e-4 of lr (fp32): ``torch.pow`` against XLA's ``pow`` in the
  bias corrections, and XLA's CPU code rounds the step of rows of some
  widths otherwise (seen at a last dim of 24, not of 40);
  when the norm clips, the clip factor (a sum over every gradient, in
  another order) may move a last bit: scales within rtol 1e-6, codes
  within 1.
* ``make_train_step`` on the reduced smollm-360m against the jitted
  reference's: loss and grad norm within rtol 1e-3 (bf16 activations),
  the updated parameters within 2 lr + 2 bf16 ulps of each other
  (Adam's first step moves every entry by about lr times the sign of
  its gradient; a sign may differ where the gradient is ~0) and equal
  in 99% of entries to one bf16 ulp.
* ``SyntheticLM`` batches and checkpoint round trips: byte for byte;
  ``launch.train.main``'s resumed run: its losses bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from repro.models import api as JA
from repro.models import common as JC
from repro.models import dense as JD
from repro.train import optimizer as JO
from repro_torch.kernels import ref as kref
from repro_torch.models import api as TA
from repro_torch.models import common as TC
from repro_torch.models import dense as TD
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as TO

# (B, Sq, Sk, H, KV, hd, dv, q_offset, block, window, n_sinks)
FLASH = {
    "gqa": (1, 40, 40, 4, 2, 16, 16, 0, 16, 0, 0),
    "window_sinks": (2, 40, 40, 4, 1, 16, 16, 0, 16, 12, 2),
    "sk_not_a_block_multiple": (1, 37, 37, 6, 3, 32, 32, 0, 16, 0, 0),
    "q_offset": (1, 20, 40, 4, 2, 16, 16, 20, 8, 0, 0),
    "dqk_ne_dv": (1, 33, 33, 4, 4, 24, 16, 0, 16, 8, 1),
}


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def _flash_inputs(case):
    B, Sq, Sk, H, KV, hd, dv, *_ = FLASH[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, dv),
             (B, Sq, H, dv))]
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    return j, [to_torch(np.asarray(a)) for a in j]


def _within_ulps(ref, port, n):
    ref, port = to_np(ref), to_np(port)
    tol = n * _bf16_ulp(float(np.max(np.abs(ref))))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("case", FLASH)
def test_flash_forward_and_row_stats_match_reference(case):
    """The forward of ``flash_attention`` (``attn_density``'s flash form
    with ``return_stats``: what the CUDA kernel computes on the card)
    against the reference's ``_flash_fwd_impl``: out, and the row max m
    and sum l in its (B, KV, G, Sq) layout; ``flash_attention`` itself
    returns the same out."""
    (jq, jk, jv, _), (q, k, v, _) = _flash_inputs(case)
    *_, q_off, block, window, n_sinks = FLASH[case]
    jout, jm, jl = JC._flash_fwd_impl(jq, jk, jv, q_off, block, window,
                                      n_sinks)
    q_pos = torch.arange(q_off, q_off + q.shape[1])
    out, dens, m, l = kref.attn_density_plain(
        q, k, v, q_pos, k.shape[1], window, n_sinks, False, "flash",
        return_stats=True)
    assert dens is None and m.shape == jm.shape and l.shape == jl.shape
    _within_ulps(jout, out, 2)
    jm = np.asarray(jm)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5,
                               atol=1e-6 * float(np.max(np.abs(jm))))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), rtol=1e-5)
    assert torch.equal(TC.flash_attention(q, k, v, q_off, block, window,
                                          n_sinks), out)


def test_row_stats_are_asked_of_the_flash_form_alone():
    q = torch.zeros((1, 4, 2, 16), dtype=torch.bfloat16)
    for kw in (dict(form="served"), dict(want_density=True, form="flash")):
        kw.setdefault("want_density", False)
        with pytest.raises(ValueError, match="row stats"):
            kref.attn_density_plain(q, q, q, return_stats=True, **kw)


@pytest.mark.parametrize("case", FLASH)
def test_flash_backward_alone_matches_reference(case):
    """``_flash_bwd`` on the reference's own saved residuals (q, k, v,
    out, m, l) and the same dout, against ``_flash_vjp_bwd``: op for op,
    so dq, dk, dv within one bf16 ulp of their largest value."""
    (jq, jk, jv, jdo), (q, k, v, do) = _flash_inputs(case)
    *_, q_off, block, window, n_sinks = FLASH[case]
    jout, jm, jl = JC._flash_fwd_impl(jq, jk, jv, q_off, block, window,
                                      n_sinks)
    ref = JC._flash_vjp_bwd(q_off, block, window, n_sinks,
                            (jq, jk, jv, jout, jm, jl), jdo)
    port = TC._flash_bwd(q, k, v, to_torch(np.asarray(jout)),
                         to_torch(np.asarray(jm)), to_torch(np.asarray(jl)),
                         do, q_off, block, window, n_sinks)
    for r, t, x in zip(ref, port, (q, k, v)):
        assert t.dtype == x.dtype and t.shape == x.shape
        _within_ulps(r, t, 1)


@pytest.mark.parametrize("case", FLASH)
def test_flash_attention_vjp_matches_reference(case):
    """``flash_attention``'s gradients through autograd against the
    reference's ``custom_vjp`` under ``jax.vjp``: within 2% of the
    largest value."""
    (jq, jk, jv, jdo), (q, k, v, do) = _flash_inputs(case)
    *_, q_off, block, window, n_sinks = FLASH[case]
    _, vjp = jax.vjp(lambda a, b, c: JC.flash_attention(
        a, b, c, q_off, block, window, n_sinks), jq, jk, jv)
    ref = vjp(jdo)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = TC.flash_attention(*leaves, q_off, block, window, n_sinks)
    port = torch.autograd.grad(out, leaves, do)
    for r, t in zip(ref, port):
        r, t = to_np(r), to_np(t)
        np.testing.assert_allclose(t, r, rtol=0,
                                   atol=0.02 * float(np.max(np.abs(r))))


def test_train_attention_takes_the_reference_branches(monkeypatch):
    """``train_attention``: ``flash_attention`` above 2,048 tokens or
    with a window, else ``gqa_attention`` under the causal mask."""
    calls = []
    real = TC.flash_attention
    monkeypatch.setattr(TC, "flash_attention",
                        lambda *a: calls.append(a[3:]) or real(*a))
    q = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    pos = torch.arange(8)
    TC.train_attention(q, q, q, pos)
    assert calls == []
    TC.train_attention(q, q, q, pos, window=4, n_sinks=1)
    assert calls == [(0, 1024, 4, 1)]
    qs = torch.zeros((1, 2049, 1, 16), dtype=torch.bfloat16)
    TC.train_attention(qs, qs, qs, torch.arange(2049))
    assert calls[-1] == (0, 1024, 0, 0)


def test_cross_entropy_and_grad_match_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 24, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (2, 24)).astype(np.int32)
    mask = (rng.random((2, 24)) < 0.7).astype(np.float32)
    for m in (None, mask):
        f = lambda x: JA.cross_entropy(x, targets, m)  # noqa: E731
        (jl, jmet), jg = jax.value_and_grad(f, has_aux=True)(logits)
        x = torch.from_numpy(logits).requires_grad_(True)
        tl, tmet = TA.cross_entropy(
            x, torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        (tg,) = torch.autograd.grad(tl, x)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        assert float(tmet["acc"]) == float(jmet["acc"])
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)


@pytest.mark.parametrize("S,masked", [(600, False), (600, True), (40, True)])
def test_blockwise_ce_and_grads_match_reference(S, masked):
    """``blockwise_ce`` (blocks of 512: two at S = 600, the last shorter)
    on bf16 activations against the reference's, run eagerly (its bf16
    head product rounds as the port's does), and its gradients in x and
    the head."""
    rng = np.random.default_rng(S)
    x32 = rng.standard_normal((2, S, 32)).astype(np.float32)
    h32 = rng.standard_normal((32, 80)).astype(np.float32) * 0.3
    targets = rng.integers(0, 80, (2, S)).astype(np.int32)
    mask = ((rng.random((2, S)) < 0.8).astype(np.float32) if masked
            else None)
    jx, jh = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x32, h32))
    with jax.disable_jit():
        (jl, jmet), jg = jax.value_and_grad(
            lambda a, b: JD.blockwise_ce(a, b, targets, mask), (0, 1),
            has_aux=True)(jx, jh)
    x, h = (to_torch(np.asarray(a)).requires_grad_(True) for a in (jx, jh))
    tl, tmet = TD.blockwise_ce(x, h, torch.from_numpy(targets),
                               None if mask is None
                               else torch.from_numpy(mask))
    tg = torch.autograd.grad(tl, (x, h))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(tmet["acc"]), float(jmet["acc"]),
                               rtol=1e-6)
    for r, t in zip(jg, tg):
        assert t.dtype == torch.bfloat16
        _within_ulps(r, t, 1)


# --------------------------------------------------------------------- #
# the optimizer
# --------------------------------------------------------------------- #
SHAPES = {"w": (16, 40), "blk": {"a": (3, 8, 24), "b": (50,)},
          "h": (12, 64)}


def _tree(rng, scale):
    return {"w": (rng.standard_normal(SHAPES["w"]) * scale
                  ).astype(np.float32),
            "blk": {k: (rng.standard_normal(s) * scale).astype(np.float32)
                    for k, s in SHAPES["blk"].items()},
            "h": (rng.standard_normal(SHAPES["h"]) * scale
                  ).astype(np.float32)}


def _jtree(t):
    """numpy tree -> jax tree; "h" in bf16, as the models' weights."""
    j = jax.tree.map(jnp.asarray, t)
    j["h"] = j["h"].astype(jnp.bfloat16)
    return j


def _ttree(j):
    return jax.tree.map(lambda a: to_torch(np.asarray(a)), j)


def _opt_runs(quantized: bool, gscale: float, steps: int = 6):
    rng = np.random.default_rng(11 + int(quantized))
    kw = dict(lr=1e-2, warmup_steps=4, quantized=quantized)
    jcfg, tcfg = JO.OptConfig(**kw), TO.OptConfig(**kw)
    p = _jtree(_tree(rng, 0.02))
    js, ts = JO.init_state(p, jcfg), TO.init_state(_ttree(p), tcfg)
    step = jax.jit(lambda s, g: JO.apply_updates(s, g, jcfg))
    for _ in range(steps):
        g = _jtree(_tree(rng, gscale))
        js, jm = step(js, g)
        ts, tm = TO.apply_updates(ts, _ttree(g), tcfg)
    return js, jm, ts, tm


def _leaf_pairs(js, ts, key):
    return zip(jax.tree.leaves(js[key]), TO.tree_leaves(
        {k: ts[key][k] for k in sorted(ts[key])}))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "8bit"])
def test_apply_updates_matches_jitted_reference(quantized):
    """Six AdamW steps (warmup 4) from the same weights and gradients,
    the gradient norm under ``clip_norm``: the moments (fp32, or the
    8-bit codes and their scales) equal the jitted reference's bit for
    bit; the parameters within 1e-4 of lr (fp32) and one ulp (bf16);
    the learning
    rate equal, the grad norm (a sum in another order) within rtol
    1e-6."""
    js, jm, ts, tm = _opt_runs(quantized, 1e-3)
    assert float(jm["grad_norm"]) < 1.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts["step"]) == int(js["step"]) == 6
    keys = (("mu", "mu_scale", "nu", "nu_scale") if quantized
            else ("mu", "nu"))
    for key in keys:
        for a, t in _leaf_pairs(js, ts, key):
            a = np.asarray(a)
            assert t.numpy().dtype == a.dtype
            assert np.array_equal(t.numpy(), a), key
    for a, t in _leaf_pairs(js, ts, "params"):
        d = np.abs(to_np(t) - to_np(a))
        if t.dtype == torch.bfloat16:
            ulp = np.abs(np.spacing(to_np(a))) * 2.0 ** 16
            assert np.all(d <= ulp)
        else:
            assert d.max() <= 1e-4 * 1e-2      # 1e-4 of lr


def test_apply_updates_when_the_norm_clips():
    """With the gradient norm far above ``clip_norm`` the clip factor
    enters every update: the 8-bit scales within rtol 1e-6 and the codes
    within 1 of the jitted reference's."""
    js, jm, ts, tm = _opt_runs(True, 1.0)
    assert float(jm["grad_norm"]) > 10.0
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for key in ("mu_scale", "nu_scale"):
        for a, t in _leaf_pairs(js, ts, key):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-6)
    for key in ("mu", "nu"):
        for a, t in _leaf_pairs(js, ts, key):
            d = np.abs(t.numpy().astype(np.int32) - np.asarray(a, np.int32))
            assert d.max() <= 1, key


def test_codecs_round_half_to_even_like_jitted_reference():
    """``_q8`` / ``_q8v`` on rows built to land on .5 ties after the
    scale: codes and scales equal the jitted reference's."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 0.0],
                  [254.0, 1.0, 3.0, 5.0, -1.0, -3.0, 7.0, 0.0]], np.float32)
    for jf, tf, arg in ((JO._q8, TO._q8, x), (JO._q8v, TO._q8v, x * x)):
        jc, js = jax.jit(jf)(arg)
        tc, ts = tf(torch.from_numpy(arg))
        assert np.array_equal(tc.numpy(), np.asarray(jc))
        assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "8bit"])
def test_adamw_minimizes_quadratic(quantized):
    """The reference's ``test_adamw_minimizes_quadratic`` on the port."""
    cfg = TO.OptConfig(lr=0.05, weight_decay=0.0, warmup_steps=1,
                       quantized=quantized)
    rng = np.random.default_rng(0)
    state = TO.init_state(
        {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(
            np.float32))}, cfg)
    losses = []
    for _ in range(120):
        w = state["params"]["w"].detach().requires_grad_(True)
        loss = torch.sum((w - 1.0) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        state, _ = TO.apply_updates(state, {"w": g}, cfg)
        losses.append(float(loss))
    assert losses[-1] < 0.05 * losses[0]


def test_grad_clip_caps_update():
    """The reference's ``test_grad_clip_caps_update`` on the port: the
    reported norm is the unclipped one, the step is clipped."""
    cfg = TO.OptConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0,
                       warmup_steps=1)
    state = TO.init_state({"w": torch.zeros((8, 8))}, cfg)
    new, metrics = TO.apply_updates(state, {"w": torch.full((8, 8), 1e6)},
                                    cfg)
    assert float(metrics["grad_norm"]) > 1e6
    assert float(new["mu"]["w"].abs().max()) <= 1e-4


def test_apply_updates_leaves_its_input_state_as_it_was():
    cfg = TO.OptConfig(quantized=True)
    state = TO.init_state({"w": torch.ones((4, 8))}, cfg)
    before = {k: v["w"].clone() for k, v in state.items() if k != "step"}
    TO.apply_updates(state, {"w": torch.ones((4, 8))}, cfg)
    for k, v in before.items():
        assert torch.equal(state[k]["w"], v)
    assert int(state["step"]) == 0


# --------------------------------------------------------------------- #
# data and checkpoints
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("vocab,seq,batch,n_shards,shard", [
    (100, 16, 4, 2, 0), (100, 16, 4, 2, 1), (512, 33, 3, 1, 0),
    (49152, 64, 2, 4, 3)])
def test_synthetic_lm_batches_equal_reference(vocab, seq, batch, n_shards,
                                              shard):
    from repro.data.pipeline import SyntheticLM as JLM
    from repro_torch.data.pipeline import SyntheticLM as TLM
    kw = dict(vocab=vocab, seq=seq, batch=batch, n_shards=n_shards,
              shard=shard)
    j, t = JLM(**kw), TLM(**kw)
    for step in (0, 1, 7, 1000):
        a, b = j.batch_for_step(step), t.batch_for_step(step)
        assert sorted(a) == sorted(b) == ["targets", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            assert a[k].tobytes() == b[k].tobytes()
    assert not np.array_equal(t.batch_for_step(3)["tokens"],
                              TLM(**{**kw, "shard": shard + 1}
                                  ).batch_for_step(3)["tokens"])


def _state():
    g = torch.Generator().manual_seed(5)
    return {"params": {"w": torch.randn((3, 4), generator=g).to(
                torch.bfloat16),
                       "blk": {"b": torch.randn((5,), generator=g)}},
            "mu": {"w": torch.randint(-127, 128, (3, 4), generator=g,
                                      dtype=torch.int8)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a, b.view(torch.int16)
                       if b.dtype == torch.bfloat16 else b)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """bf16, fp32, int8 and a 0-d int32 leaf come back bit for bit on
    the device named; ``keep`` retains the newest checkpoints; the files
    are host numpy trees (bf16 as its 16-bit pattern under a tag)."""
    import pickle
    d = str(tmp_path / "ck")
    state = _state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, state, keep=2)
    assert ckpt.latest_step(d) == 5
    assert sorted(os.listdir(d)) == ["step_4.pkl", "step_5.pkl"]
    _same_tree(ckpt.restore(d, device="cpu"), state)
    _same_tree(ckpt.restore(d, 4, device="cpu"), state)
    with open(os.path.join(d, "step_5.pkl"), "rb") as f:
        host = pickle.load(f)
    assert host["params"]["w"][ckpt._BF16].dtype == np.uint16
    assert isinstance(host["mu"]["w"], np.ndarray)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), device="cpu")


def test_checkpoint_async_snapshots_before_it_returns(tmp_path):
    d = str(tmp_path / "ck")
    state, want = _state(), _state()
    ckpt.save_async(d, 1, state)
    state["params"]["blk"]["b"].add_(1.0)       # after the snapshot
    ckpt.flush()
    assert ckpt.latest_step(d) == 1
    _same_tree(ckpt.restore(d, device="cpu"), want)
    assert not any(f.endswith(".tmp") for f in os.listdir(d))


# --------------------------------------------------------------------- #
# the train step and the entry point
# --------------------------------------------------------------------- #
def _data_batch(cfg, seq, batch, step=0):
    from repro_torch.data.pipeline import SyntheticLM
    return SyntheticLM(vocab=cfg.vocab, seq=seq, batch=batch
                       ).batch_for_step(step)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_matches_jitted_reference(n_micro):
    """One ``make_train_step`` step of the reduced smollm-360m against the
    jitted reference's ``make_train_step`` (tolerances above)."""
    from repro.launch.train import make_train_step as jstep
    from repro_torch.launch.train import batch_to, make_train_step
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair("smollm-360m")
    kw = dict(lr=1e-3, warmup_steps=1)
    batch = _data_batch(tcfg, 16, 4)
    js, jm = jax.jit(jstep(jmodel, JO.OptConfig(**kw), n_micro=n_micro))(
        JO.init_state(jparams, JO.OptConfig(**kw)), batch)
    ts, tm = make_train_step(tmodel, TO.OptConfig(**kw), n_micro=n_micro)(
        TO.init_state(tparams, TO.OptConfig(**kw)), batch_to(batch, "cpu"))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3)
    assert float(tm["lr"]) == float(jm["lr"])
    flat_j = jax.tree_util.tree_flatten_with_path(js["params"])[0]
    flat_t = jax.tree_util.tree_flatten_with_path(ts["params"])[0]
    same = total = 0
    for (path, a), (_, t) in zip(flat_j, flat_t):
        a, t = to_np(a), to_np(t)
        bound = 2 * kw["lr"] + 2 * _bf16_ulp(float(np.abs(a).max()))
        assert np.abs(a - t).max() <= bound, path
        ulp = np.abs(np.spacing(a)) * 2.0 ** 16
        same += int(np.sum(np.abs(a - t) <= ulp))
        total += a.size
    assert same >= 0.99 * total, same / total


def test_microbatched_step_matches_plain():
    """The reference's ``test_microbatched_step_matches_plain`` on the
    port: two microbatches against one batch, parameters within 2e-2."""
    from repro_torch.launch.train import batch_to, make_train_step
    *_, tcfg, tmodel, tparams = tiny_pair("smollm-360m")
    opt = TO.OptConfig(lr=1e-3, warmup_steps=1)
    batch = batch_to(_data_batch(tcfg, 16, 4), "cpu")
    out1, _ = make_train_step(tmodel, opt, 1)(TO.init_state(tparams, opt),
                                              batch)
    out2, _ = make_train_step(tmodel, opt, 2)(TO.init_state(tparams, opt),
                                              batch)
    d = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        TO.tree_leaves(out1["params"]), TO.tree_leaves(out2["params"])))
    assert d < 2e-2


def test_training_reduces_loss():
    """The reference's ``test_training_reduces_loss`` on the port."""
    from repro_torch.launch.train import batch_to, make_train_step
    *_, tcfg, tmodel, tparams = tiny_pair("smollm-360m")
    opt = TO.OptConfig(lr=5e-3, warmup_steps=5)
    step_fn = make_train_step(tmodel, opt)
    state = TO.init_state(tparams, opt)
    first = last = None
    for step in range(120):
        state, metrics = step_fn(state, batch_to(
            _data_batch(tcfg, 32, 8, step), "cpu"))
        if step == 0:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
    assert last < first - 0.3, (first, last)


def test_train_main_resumes_bit_for_bit(tmp_path, capsys):
    """``launch.train.main`` on the CPU with ``--reduced``: six steps in
    one run, and three steps, a checkpoint, then ``--resume`` to six:
    the resumed steps' losses equal the uninterrupted run's bit for bit,
    and so do both runs' checkpoints at step 6."""
    from repro_torch.launch.train import main
    base = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-every", "3", "--quantized-opt"]
    full = main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "a")])
    part = main(base + ["--steps", "3", "--ckpt-dir", str(tmp_path / "b")])
    rest = main(base + ["--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
                        "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(full["losses"]) == 6 and full["step"] == rest["step"] == 6
    assert part["losses"] + rest["losses"] == full["losses"]
    assert np.isfinite(full["losses"]).all()
    _same_tree(ckpt.restore(str(tmp_path / "a"), 6, device="cpu"),
               ckpt.restore(str(tmp_path / "b"), 6, device="cpu"))
