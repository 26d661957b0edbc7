"""Every family's training ``loss`` on the port against the JAX package.

Both packages run the reduced config of each family from the SAME
weights (the reference's ``init(PRNGKey(0))`` carried across through
``models/convert.py``) on the same batch (``conftest.make_batch``), and
the port's loss and per-leaf gradients (``launch.train.grad_of``:
``torch.autograd.grad`` over every leaf) are held to the jitted
``jax.value_and_grad(model.loss)``.  Cases: dense (smollm-360m) at 24
tokens (``gqa_attention``) and at 2,100 (``flash_attention``: the
kernel's plain version forward, the reference's backward), MLA + MoE
(deepseek-v2-lite-16b), MoE (llama4-maverick), the VLM, whisper-base
(encdec), RWKV6 and recurrentgemma at 24 tokens and at 2,100 (flash
under its 64-token window).  MoE routing is teacher-forced
(``_forced_routing``): the jitted reference hands its router gates to
the host as it runs (``_recorded_gates``), and wherever the port's
top-k differs — only at a near-tie, which the test asserts — the port
takes the reference's experts (its gate values moved by at most the
packages' largest gate difference, its gradient through the gates
kept).  The reduced MoE models' random gates sit at near-ties: the
reference's own eager and jitted runs route differently there (their
expert gradients differ by 9% relative L2).

Tolerances.  The models are bf16: activations and weight gradients
round to bf16 at every op in the port, as in the reference run eagerly,
while jitted XLA fuses ops and skips some of those roundings.  The
reference's own eager gradients differ from its jitted ones by up to
2.8% relative L2 in a leaf (recurrentgemma; RWKV6 2.6%, the VLM's
gates 6.3%), and the port's losses sit next to the eager reference's.
* The loss within rtol 2e-4 (measured up to 6.8e-5); the accuracy
  within one token of the batch.
* Each gradient leaf: the relative L2 error ||port - ref|| / ||ref||
  within 5% (measured up to 3.5%, whisper's cross-attention ``bv``),
  and every entry within 10% of the leaf's largest magnitude (measured
  up to 4.6%).  Leaves that are one scalar a layer summed over every
  activation (the VLM's tanh gates ``gate_attn``, ``gate_ffn``: a sum
  of B x S x d products that largely cancel) within 30% of their
  largest magnitude and 30% relative L2 (measured up to 22%).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from _torch_parity import one_torch_thread, tiny_pair, to_np, to_torch  # noqa: F401
from conftest import make_batch
from repro_torch.launch.train import grad_of

LOSS_RTOL = 2e-4
LEAF_L2, LEAF_MAX = 0.05, 0.10
# one scalar a layer, a sum of B x S x d products that largely cancel
GATE_LEAVES = ("gate_attn", "gate_ffn")
GATE_TOL = 0.30
CASES = [("smollm-360m", 24), ("smollm-360m", 2100),
         ("deepseek-v2-lite-16b", 24), ("llama4-maverick-400b-a17b", 24),
         ("llama-3.2-vision-90b", 24), ("whisper-base", 24),
         ("rwkv6-1.6b", 24), ("recurrentgemma-2b", 24),
         ("recurrentgemma-2b", 2100)]


def _near_tie(ref_row, port_row, ref_pick, port_pick):
    """The reference's gap between its pick and the port's is one that
    the packages' gate differences can close: at most twice their
    largest difference in that row (each of the two gates may move by
    it, in opposite directions)."""
    gap = float(ref_row[ref_pick] - ref_row[port_pick])
    err = float(np.max(np.abs(ref_row - port_row)))
    assert 0.0 <= gap <= 2 * err, ("expert choice", gap, err)


def _choices(gates: np.ndarray, top_k: int):
    """The reference's iterated argmax over (G, gs, E) gates."""
    rem, out = gates.copy(), []
    for _ in range(top_k):
        idx = rem.argmax(-1)
        out.append(idx)
        np.put_along_axis(rem, idx[..., None], 0.0, axis=-1)
    return out


@contextlib.contextmanager
def _recorded_gates():
    """While the block runs, the reference's ``moe_dispatch`` hands its
    router gates to the host (``jax.debug.callback``) wherever it runs,
    jitted and under ``value_and_grad`` included.  Yields the list they
    land in."""
    from repro.models import moe_layer as jmoe
    jdisp, seen = jmoe.moe_dispatch, []

    def record(gates, top_k, cap):
        jax.debug.callback(lambda g: seen.append(np.asarray(g)), gates)
        return jdisp(gates, top_k, cap)

    jmoe.moe_dispatch = record
    try:
        yield seen
    finally:
        jax.effects_barrier()
        jmoe.moe_dispatch = jdisp


@contextlib.contextmanager
def _forced_routing(seen):
    """Teacher-force the port's expert choices to the reference's
    recorded ones (``_recorded_gates``): while the block runs, the
    port's ``moe_dispatch`` finds the recorded gates of the same call
    (the closest of that shape: a forward and its checkpointed
    recompute see the same gates) and, where its own iterated argmax
    differs (a near-tie, asserted), adds to its gates the constant that
    moves the reference's expert just above the port's pick, so the
    gradient through the gates is kept.  Yields the list of forced
    (call, k, group, token)."""
    from repro_torch.models import moe_layer as tmoe
    tdisp, forced = tmoe.moe_dispatch, []

    def force(gates, top_k, cap):
        mine = gates.detach().numpy()
        call = min(range(len(seen)), key=lambda i: np.inf if seen[i].shape
                   != mine.shape else np.abs(seen[i] - mine).max())
        ref = seen[call]
        delta = np.zeros_like(mine)
        for k, want in enumerate(_choices(ref, top_k)):
            got = _choices(mine + delta, top_k)[k]
            for g, s in np.argwhere(want != got):
                _near_tie(ref[g, s], mine[g, s], want[g, s], got[g, s])
                cur = mine[g, s] + delta[g, s]
                target = np.nextafter(cur[got[g, s]], np.float32(1))
                delta[g, s, want[g, s]] = target - mine[g, s, want[g, s]]
                forced.append((call, k, int(g), int(s)))
        for k, want in enumerate(_choices(ref, top_k)):
            assert (_choices(mine + delta, top_k)[k] == want).all()
        return tdisp(gates + torch.from_numpy(delta), top_k, cap)

    tmoe.moe_dispatch = force
    try:
        yield forced
    finally:
        tmoe.moe_dispatch = tdisp


def _close_leaf(path: str, ref, port):
    ref, port = to_np(ref).astype(np.float64), to_np(port).astype(np.float64)
    scale = float(np.max(np.abs(ref)))
    l2, mx = ((GATE_TOL, GATE_TOL) if path.split("'")[-2] in GATE_LEAVES
              else (LEAF_L2, LEAF_MAX))
    err = float(np.max(np.abs(port - ref)))
    assert err <= mx * scale, (path, err, scale)
    norm = float(np.linalg.norm(ref))
    assert float(np.linalg.norm(port - ref)) <= l2 * norm, (path, norm)


@pytest.mark.parametrize("name,S", CASES, ids=[f"{n}-{s}" for n, s in CASES])
def test_loss_and_grads_match_jitted_reference(name, S):
    """``model.loss`` and its gradient with respect to every parameter
    leaf, port against the jitted reference (tolerances above); the
    leaves are the same tree, leaf for leaf, in the same dtypes."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = tiny_pair(name)
    B = 1 if S > 1000 else 2
    batch = make_batch(jcfg, B, S)
    with _recorded_gates() as seen:
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            jmodel.loss, has_aux=True))(jparams, batch)
    tbatch = {k: to_torch(np.asarray(v)) for k, v in batch.items()}
    assert bool(seen) == (tcfg.moe is not None)
    with _forced_routing(seen):
        met, tgrads = grad_of(tmodel, tparams, tbatch)
    np.testing.assert_allclose(float(met["loss"]), float(jloss),
                               rtol=LOSS_RTOL)
    assert abs(float(met["acc"]) - float(jmet["acc"])) <= 1.0 / (B * S)
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(tgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_j] == \
        [jax.tree_util.keystr(p) for p, _ in flat_t]
    for (path, jg), (_, tg) in zip(flat_j, flat_t):
        assert tuple(jg.shape) == tuple(tg.shape)
        assert str(tg.dtype) == f"torch.{jg.dtype}", (path, tg.dtype)
        _close_leaf(jax.tree_util.keystr(path), jg, tg)
