"""``models/common.py:ring_update`` writes at a device index: the bytes
of the slice assignment it replaced, for a 0-d position (the serial
working cache) and a (B,) one (batched decode), with and without
``ring``, into bf16, fp32 and int8 caches (a float ``new`` into int8
converted as the reference's ``astype``), and without a host read of
the position (which would keep a slot decode out of a CUDA graph)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import common as C


def _slice_update(cache, new, pos, ring=False):
    """``ring_update`` as it was: the 0-d position read on the host and
    a slice assigned."""
    S = cache.shape[1]
    idx = pos % S if ring else pos
    if pos.dim():
        rows = torch.arange(cache.shape[0])
        cache[rows, idx] = C.cast_to(new[:, 0], cache.dtype)
    else:
        i = int(idx)
        cache[:, i:i + 1] = C.cast_to(new, cache.dtype)
    return cache


def _case(dtype, B, S, tail, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        cache = torch.randint(-127, 128, (B, S, *tail), generator=g,
                              dtype=torch.int8)
        new = torch.randn((B, 1, *tail), generator=g) * 300.0
    else:
        cache = torch.randn((B, S, *tail), generator=g).to(dtype)
        new = torch.randn((B, 1, *tail), generator=g).to(dtype)
    return cache, new


def _same_bytes(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("pos", [0, 5, 23])
def test_scalar_position_gives_the_slice_bytes(dtype, ring, pos):
    """A 0-d position, in range and (with ``ring``) past the end."""
    S = 24
    p = pos + (S if ring else 0)
    cache, new = _case(dtype, 1, S, (2, 8), seed=p)
    want = _slice_update(cache.clone(), new, torch.tensor(p), ring)
    got = C.ring_update(cache, new, torch.tensor(p), ring)
    assert got is cache                                  # in place
    assert _same_bytes(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("ring", [False, True])
def test_row_positions_give_the_slice_bytes(dtype, ring):
    """A (B,) position, each row at its own offset."""
    S = 24
    pos = torch.tensor([0, 7, 23]) + (torch.tensor([S, 2 * S, 0])
                                      if ring else 0)
    cache, new = _case(dtype, 3, S, (2, 8), seed=9)
    want = _slice_update(cache.clone(), new, pos, ring)
    got = C.ring_update(cache, new, pos, ring)
    assert got is cache and _same_bytes(got, want)


@pytest.mark.parametrize("pos_dtype", [torch.int64, torch.int32])
def test_scalar_position_is_never_read_on_the_host(monkeypatch, pos_dtype):
    """The 0-d position stays a tensor operand: a host read of it (which
    a CUDA graph capture refuses) raises here, and none happens; the
    bytes are the slice assignment's (an MLA latent of one axis)."""
    cache, new = _case(torch.bfloat16, 1, 16, (32,), seed=3)
    want = _slice_update(cache.clone(), new, torch.tensor(11))
    pos = torch.tensor(11, dtype=pos_dtype)

    def refuse(*a, **k):
        raise AssertionError("a host read of the position")

    for name in ("__int__", "__index__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = C.ring_update(cache, new, pos)
    monkeypatch.undo()
    assert _same_bytes(got, want)


def test_out_of_range_position_raises():
    """Without ``ring`` a position past the cache raises, where the
    slice assignment silently wrote nothing (no caller writes there:
    the service bounds a context at ``n_slots`` < ``s_work``, and the
    capped decoders at their cache length)."""
    cache, new = _case(torch.bfloat16, 1, 8, (4,), seed=1)
    kept = cache.clone()
    assert _same_bytes(_slice_update(cache.clone(), new, torch.tensor(8)),
                       kept)
    with pytest.raises((IndexError, RuntimeError)):
        C.ring_update(cache, new, torch.tensor(8))
    assert _same_bytes(cache, kept)


@pytest.mark.parametrize("family", ["llama2-7b", "deepseek-v2-lite-16b"])
def test_decode_step_writes_the_slice_bytes(family):
    """A model's decode over a 0-d ``pos`` writes what the slice
    assignment wrote: the dense K/V and the MLA latents of the reduced
    configs, after three steps from a random cache."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.registry import build_model
    cfg = reduced(get_config(family))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    base = model.init_cache(1, 32)
    for n, t in base.items():
        if n != "pos":
            t.copy_(torch.from_numpy(
                rng.standard_normal(t.shape).astype(np.float32)))
    runs = []
    for update in (C.ring_update, _slice_update):
        cache = {n: t.clone() for n, t in base.items()}
        cache["pos"] = torch.tensor(20)
        saved = C.ring_update
        C.ring_update = update
        try:
            outs = []
            for tok in (3, 9, 4):
                out, mass = model.decode_step(params, torch.tensor([[tok]]),
                                              cache, want_density=True)
                outs += [out.logits, mass]
                cache = dict(out.cache)
        finally:
            C.ring_update = saved
        runs.append((outs, cache))
    (oa, ca), (ob, cb) = runs
    assert all(_same_bytes(a, b) for a, b in zip(oa, ob))
    assert ca.keys() == cb.keys()
    assert all(_same_bytes(ca[n], cb[n]) for n in ca)
