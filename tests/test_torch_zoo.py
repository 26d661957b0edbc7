"""The port's model zoo (``core/zoo.py``) against the JAX package.

* The reference's per-family conformance cases (``tests/test_zoo_
  conformance.py``) on the port, for the ported families (dense, MLA +
  MoE, MoE, RWKV6, VLM): each KVSpec equals the reference's and declares a
  coherent cache; an undeclared layout is a clean error; every declared
  leaf round-trips through its codec (``ChunkCodec`` over sequence
  leaves, ``WholeStateCodec`` over state leaves); the executor honours
  the servable gate; batched decode is token-identical to serial where
  the spec promises it.
* ``ZooService``: routing by context ownership over one cid space, the
  default family, one byte budget, a zoo member's tokens equal to the
  same family served solo, and a reclaim that crosses families going
  through ``route_evict`` to the owner.
* ``mixed_zoo`` (dense llama2-7b + MLA deepseek-v2-lite + RWKV6 rwkv6,
  reduced, heads scaled 16x as in the other service tests) through
  both packages' ``build_zoo_service`` + ``run_scenario``: equal
  ``deterministic_view`` and ``tokens_sha_by_app``.  As in
  ``tests/test_torch_scenarios.py``, the bytes written are compared
  without the pickle framing of each file: chunk-file headers hold
  per-layer CRCs that pickle writes in 2 or 4 bytes, and the reference
  pickles its fp32 snapshot leaf as a read-only view of its device
  buffer, in 4 more bytes, which each read of the file counts too.
"""
import dataclasses
import pickle
import tempfile
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import one_torch_thread, scaled_head_pair  # noqa: F401
from repro import loadgen as jloadgen
from repro.core import restore as jrestore
from repro.core import swap as jswap
from repro.core.chunks import ChunkCodec as JChunkCodec
from repro.core.chunks import WholeStateCodec as JWholeStateCodec
from repro.models.kvspec import LAYOUT_MIXED, LAYOUT_WINDOW
from repro.models.registry import family_spec as jfamily_spec
from repro_torch import loadgen as tloadgen
from repro_torch.configs import get_config, reduced
from repro_torch.core import restore as trestore
from repro_torch.core import swap as tswap
from repro_torch.core.chunks import ChunkCodec, WholeStateCodec
from repro_torch.core.service import LLMSConfig, LLMService
from repro_torch.core.zoo import ZooService
from repro_torch.loadgen.metrics import deterministic_view
from repro_torch.models.registry import FAMILY_CLASSES, family_spec

ZOO_ARCHS = {"dense": "llama2-7b", "mla_moe": "deepseek-v2-lite-16b",
             "rwkv6": "rwkv6-1.6b"}
# every family's representative arch: the zoo's members, and the
# families that serve outside it (moe) or not at all (vlm, encdec,
# rglru_hybrid)
FAMILY_ARCHS = {**ZOO_ARCHS, "moe": "llama4-maverick-400b-a17b",
                "vlm": "llama-3.2-vision-90b", "encdec": "whisper-base",
                "rglru_hybrid": "recurrentgemma-2b"}
FAMILIES = sorted(FAMILY_ARCHS)
HEAD_SCALE = 16.0


def _pair(family):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params) of the family's reduced representative, head scaled."""
    return scaled_head_pair(FAMILY_ARCHS[family], HEAD_SCALE)


def test_registry_covers_the_ported_families():
    assert sorted(FAMILY_CLASSES) == FAMILIES == [
        "dense", "encdec", "mla_moe", "moe", "rglru_hybrid", "rwkv6", "vlm"]


@pytest.mark.parametrize("family", FAMILIES)
def test_spec_equals_reference_and_is_coherent(family):
    cfg = reduced(get_config(FAMILY_ARCHS[family]))
    spec = family_spec(cfg)
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    jspec = jfamily_spec(jreduced(jget(FAMILY_ARCHS[family])))
    assert spec.__dict__ == jspec.__dict__
    assert spec.family == cfg.family == family
    assert spec.seq_leaves or spec.state_leaves
    assert spec.tolerance_class in ("kv", "latent", "image", "state")
    assert spec.min_bits in (2, 4, 8, 16)
    assert LAYOUT_WINDOW in spec.layouts
    if spec.quant_resident:
        assert LAYOUT_MIXED in spec.layouts
    if spec.state_leaves and not spec.seq_leaves:
        # recurrent state is never chunk-quantized below 16 bits and
        # never pad-extended
        assert spec.min_bits == 16 and not spec.pad_safe


@pytest.mark.parametrize("family", FAMILIES)
def test_undeclared_layout_is_a_clean_error(family):
    model = _pair(family)[4]
    spec = model.kv_spec()
    with pytest.raises(ValueError, match="does not support cache layout"):
        model.init_cache(1, 32, layout="bogus")
    if LAYOUT_MIXED not in spec.layouts:
        with pytest.raises(ValueError, match="does not support cache layout"):
            model.init_cache(1, 32, layout=LAYOUT_MIXED)
    else:
        model.init_cache(1, 32, layout=LAYOUT_MIXED)


@pytest.mark.parametrize("family", FAMILIES)
def test_declared_leaves_round_trip(family):
    """Every declared leaf extracts to its canonical block and inserts
    back bit for bit, in both packages' codecs (``ChunkCodec`` over the
    sequence leaves, ``WholeStateCodec`` over the state leaves: the VLM
    has both), and the two packages extract the same blocks from the
    same cache."""
    _, jmodel, _, _, model, _ = _pair(family)
    spec = model.kv_spec()
    cache = model.init_cache(2, 32)
    g = torch.Generator().manual_seed(3)
    filled = dict(cache)
    for name in spec.seq_leaves + spec.state_leaves:
        a = cache[name]
        filled[name] = torch.randn(a.shape, generator=g).to(a.dtype)
    jfilled = {k: jax.numpy.asarray(v.float().numpy()).astype(
        jmodel.init_cache(2, 32)[k].dtype) for k, v in filled.items()
        if k != "pos"}
    seen = set()
    if spec.seq_leaves:
        codec, jcodec = (ChunkCodec(spec.seq_leaves, 16, "cpu"),
                         JChunkCodec(spec.seq_leaves, 16))
        blocks = codec.extract(filled, 0, 16)
        back = codec.extract(codec.insert(model.init_cache(2, 32), 0, blocks),
                             0, 16)
        jblocks = jcodec.extract(jfilled, 0, 16)
        seen |= _same_blocks(blocks, back, jblocks)
    if spec.state_leaves:
        codec, jcodec = (WholeStateCodec(spec.state_leaves, 16),
                         JWholeStateCodec(spec.state_leaves, 16))
        blocks = {k: v.clone() for k, v in codec.extract(filled).items()}
        back = codec.extract(codec.insert(model.init_cache(2, 32), 0, blocks))
        jblocks = jcodec.extract(jfilled)
        seen |= _same_blocks(blocks, back, jblocks)
    assert seen == set(spec.seq_leaves + spec.state_leaves)


def _same_blocks(blocks, back, jblocks):
    assert set(blocks) == set(jblocks)
    for name in blocks:
        assert torch.equal(blocks[name], back[name]), name
        np.testing.assert_array_equal(
            blocks[name].float().numpy(),
            np.asarray(jblocks[name]).astype(np.float32))
    return set(blocks)


@pytest.mark.parametrize("family", FAMILIES)
def test_executor_honors_servable_gate(family):
    from repro_torch.core.executor import ModelExecutor
    _, _, _, _, model, params = _pair(family)
    sc = LLMSConfig(policy="llms", max_ctx_len=64, chunk_tokens=16)
    spec = model.kv_spec()
    if not spec.servable:        # VLM, encdec, rglru_hybrid
        with pytest.raises(ValueError, match="not servable"):
            ModelExecutor(model, params, sc, "cpu")
        return
    exe = ModelExecutor(model, params, sc, "cpu")
    assert exe.chunked_cache == spec.chunkable
    assert exe.pad_safe == spec.pad_safe
    assert isinstance(exe.codec, ChunkCodec if spec.chunkable
                      else WholeStateCodec)
    off = model.kv_spec().__class__(**{**spec.__dict__, "servable": False})
    model.kv_spec = lambda: off
    try:
        with pytest.raises(ValueError, match="not servable"):
            ModelExecutor(model, params, sc, "cpu")
    finally:
        del model.kv_spec


@pytest.mark.parametrize("family", [f for f in FAMILIES
                                    if family_spec(reduced(get_config(
                                        FAMILY_ARCHS[f]))).batched_decode])
def test_batched_decode_is_token_identical_to_serial(family):
    """The spec bit is a promise: [B, 1] batched decode picks the same
    tokens as B serial batch-1 decodes."""
    _, _, _, cfg, model, params = _pair(family)
    B, S = 2, 8
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    cb = model.init_cache(B, 16)
    for i in range(S):
        out = model.decode_step(params, toks[:, i:i + 1], cb)
        cb = out.cache
    serial = []
    for b in range(B):
        c1 = model.init_cache(1, 16)
        for i in range(S):
            o = model.decode_step(params, toks[b:b + 1, i:i + 1], c1)
            c1 = o.cache
        serial.append(o.logits)
    serial = torch.cat(serial)
    assert torch.equal(out.logits.argmax(-1), serial.argmax(-1))
    np.testing.assert_allclose(out.logits.numpy(), serial.numpy(),
                               rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------- #
# ZooService: many families, one budget
# --------------------------------------------------------------------- #
def _zoo(fams=("dense", "rwkv6"), budget=500_000):
    members = {}
    for fam in fams:
        _, _, _, _, model, params = _pair(fam)
        members[fam] = (model, params,
                        LLMSConfig(policy="llms", max_ctx_len=64,
                                   chunk_tokens=16, memory_budget=budget))
    return ZooService(members, memory_budget=budget,
                      swap_dir=tempfile.mkdtemp(prefix="zoo_test_"),
                      device="cpu")


def test_zoo_routes_by_context_ownership():
    with _zoo() as zoo:
        with pytest.raises(ValueError, match="unknown family"):
            zoo.newLLMCtx(family="nope")
        s_d = zoo.newLLMCtx(family="dense")
        s_r = zoo.newLLMCtx(family="rwkv6")
        # one cid space across members
        assert s_d.ctx_id != s_r.ctx_id
        assert zoo.family_of(s_d.ctx_id) == "dense"
        assert zoo.family_of(s_r.ctx_id) == "rwkv6"
        _, toks_d = zoo.callLLM(s_d, [1, 2, 3, 4], max_new_tokens=3)
        _, toks_r = zoo.callLLM(s_r, [5, 6, 7, 8], max_new_tokens=3)
        assert len(toks_d) == 3 and len(toks_r) == 3
        st = zoo.stats()
        assert set(st["families"]) == {"dense", "rwkv6"}
        assert st["families"]["dense"]["total_calls"] == 1
        assert st["families"]["rwkv6"]["total_calls"] == 1
        assert st["total_calls"] == 2
        # both families' bytes are charged to the ONE budget
        assert st["families"]["dense"]["resident_bytes"] > 0
        assert st["families"]["rwkv6"]["resident_bytes"] > 0
        assert st["mem_used"] <= 500_000
        zoo.delLLMCtx(s_d)
        assert s_d.ctx_id not in zoo._owner
        with pytest.raises(KeyError, match="not owned"):
            zoo.callLLM(s_d, [1], max_new_tokens=1)


def test_zoo_default_family_is_first_member():
    with _zoo() as zoo:
        stub = zoo.newLLMCtx()
        assert zoo.family_of(stub.ctx_id) == "dense"


def test_zoo_tokens_match_solo_service():
    """The shared substrate must not change what a member generates:
    the same prompt to the same family, solo vs zoo, same tokens."""
    prompt = [9, 10, 11, 12]
    with _zoo() as zoo:
        stub = zoo.newLLMCtx(family="rwkv6")
        _, zoo_toks = zoo.callLLM(stub, prompt, max_new_tokens=4)
    _, _, _, _, model, params = _pair("rwkv6")
    sc = LLMSConfig(policy="llms", max_ctx_len=64, chunk_tokens=16,
                    memory_budget=500_000,
                    swap_dir=tempfile.mkdtemp(prefix="solo_test_"))
    with LLMService(model, params, sc, device="cpu") as svc:
        _, solo_toks = svc.callLLM(svc.newLLMCtx(), prompt, max_new_tokens=4)
    assert zoo_toks == solo_toks


def test_zoo_reclaim_crosses_families():
    """A budget of about one RWKV6 snapshot and one dense chunk: a call
    on one family reclaims the other's bytes, the key goes to its
    owner through ``route_evict`` (the owner's epoch moves, the
    reclaimer's does not), the evicted state is written to the one
    shared disk and a later call on it restores from there; closing the
    zoo leaves the shared swapper to the zoo."""
    with _zoo(budget=24_000) as zoo:
        dense, rwkv = zoo.members["dense"], zoo.members["rwkv6"]
        routed = []
        route = zoo._route_evict

        def logged(key):
            routed.append(tuple(int(k) for k in key))
            return route(key)
        for m in zoo.members.values():
            m.res.route_evict = logged
        s_r = zoo.newLLMCtx(family="rwkv6")
        s_d = zoo.newLLMCtx(family="dense")
        zoo.callLLM(s_r, list(range(1, 13)), max_new_tokens=3)
        e_r, e_d = rwkv.res.epoch, dense.res.epoch
        zoo.callLLM(s_d, list(range(1, 29)), max_new_tokens=3)
        assert (s_r.ctx_id, -1) in routed
        assert rwkv.res.epoch > e_r
        assert rwkv.contexts[s_r.ctx_id].whole is None
        assert zoo.store.nbytes((s_r.ctx_id, -1))
        read = rwkv.swapper.read
        reads = []
        rwkv.swapper.read = lambda key, timeout=None: (
            reads.append(key), read(key, timeout=timeout))[1]
        zoo.callLLM(s_r, [7, 8], max_new_tokens=2)
        assert reads == [(s_r.ctx_id, -1)]
        assert zoo.stats()["mem_used"] <= 24_000
        assert not dense._owns_swapper and not rwkv._owns_swapper
        for m in zoo.members.values():
            m.close()
        assert not zoo.swapper._shutdown
    assert zoo.swapper._shutdown


# --------------------------------------------------------------------- #
# mixed_zoo through both packages
# --------------------------------------------------------------------- #
def _framing(b, obj) -> int:
    """A pickled snapshot's bytes beyond its arrays' data."""
    return len(b) - (sum(np.asarray(v).nbytes for v in obj.values())
                     if isinstance(obj, dict) else 0)


@pytest.fixture
def framing_bytes(monkeypatch):
    """Count each package's pickle framing, written and read: whole
    chunk-file headers (restore, written), and of each snapshot file
    (swap) its bytes beyond the arrays' data (written and read)."""
    counts = {(pkg, way): 0 for pkg in ("jax", "torch")
              for way in ("written", "read")}
    for key, restore_mod, swap_mod in (("jax", jrestore, jswap),
                                       ("torch", trestore, tswap)):
        def header(obj, protocol=None, _key=key):
            b = pickle.dumps(obj, protocol=protocol)
            counts[_key, "written"] += len(b)
            return b

        def snapshot(obj, protocol=None, _key=key):
            b = pickle.dumps(obj, protocol=protocol)
            counts[_key, "written"] += _framing(b, obj)
            return b

        def snapshot_read(b, _key=key):
            obj = pickle.loads(b)
            counts[_key, "read"] += _framing(b, obj)
            return obj

        for mod, dumps, loads in ((restore_mod, header, pickle.loads),
                                  (swap_mod, snapshot, snapshot_read)):
            monkeypatch.setattr(mod, "pickle", types.SimpleNamespace(
                dumps=dumps, loads=loads,
                HIGHEST_PROTOCOL=pickle.HIGHEST_PROTOCOL))
    return counts


def _mixed_zoo(pkg, spec, events_of=None):
    lib = tloadgen if pkg == "torch" else jloadgen
    fams = [a["family"] for a in spec.apps]
    models = {}
    for f in fams:
        p = _pair(f)
        models[f] = (p[4], p[5]) if pkg == "torch" else (p[1], p[2])
    vocab = min(_pair(f)[0].vocab for f in fams)
    kw = dict(device="cpu") if pkg == "torch" else {}
    svc = lib.build_zoo_service(spec, models, **kw)
    events = lib.bind_apps_by_ctx(lib.make_events(spec, vocab), spec)
    if events_of is not None:
        events = [ev for ev in events if ev.app == events_of]
    with svc:
        rep = lib.run_scenario(spec, svc, vocab, events=events)
        stats = svc.stats()
    return rep, stats


def test_mixed_zoo_matches_reference(framing_bytes):
    """``mixed_zoo`` as the spec stands (9 contexts, 18 calls over the
    three families, one 60,000 B budget, ``quant_resident``, slot
    caches): both packages give the same ``deterministic_view`` (bytes
    written without each file's pickle framing) and ``tokens_sha_by_app``;
    every family serves its 6 calls; each app's tokens equal its family
    served solo on its share of the same events."""
    jspec = jloadgen.get_scenario("mixed_zoo")
    tspec = tloadgen.get_scenario("mixed_zoo")
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    views, reps, stats = {}, {}, {}
    for pkg, spec in (("jax", jspec), ("torch", tspec)):
        reps[pkg], stats[pkg] = _mixed_zoo(pkg, spec)
        view = deterministic_view(reps[pkg])
        io = dict(view.pop("io"))
        for way in ("written", "read"):
            io[f"disk_bytes_{way}"] -= framing_bytes[pkg, way]
        io.pop("bytes_moved_per_token")
        views[pkg] = (view, io)
    assert views["torch"] == views["jax"]
    assert reps["torch"]["tokens_sha_by_app"] == \
        reps["jax"]["tokens_sha_by_app"]
    assert {f: s["total_calls"] for f, s in
            stats["torch"]["families"].items()} == \
        {"dense": 6, "mla_moe": 6, "rwkv6": 6}
    app = {a["family"]: a["name"] for a in tspec.apps}["rwkv6"]
    solo, _ = _mixed_zoo("torch", tspec, events_of=app)
    assert solo["tokens_sha_by_app"][app] == \
        reps["torch"]["tokens_sha_by_app"][app]
