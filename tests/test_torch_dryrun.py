"""The port's dry run (``repro_torch/launch/dryrun.py``) against the JAX
package's.

* ``input_specs`` of every (arch x shape): the entry point's name and
  its arguments' names, shapes and dtypes equal the reference's
  ``jax.eval_shape`` trees, the int8 decode cache and the VLM / encdec
  batches included; ``streaming_window`` equal.  One dtype differs by
  design: the port keeps a cache's scalar ``pos`` in int64 (torch's
  index dtype, since the port's first slice), where the reference keeps
  it in int32.
* The per-device ``memory.argument_size_in_bytes`` of every cell, on the
  single-pod and the multi-pod mesh and under the sharding variants,
  equals the same spec math over the reference's trees and specs (each
  leaf's dims divided by its axes' sizes, times its item size), computed
  here without a 512-device mesh.  A decode cell holds 4 bytes more in
  the port: its 0-d ``pos`` in int64.
* Params and optimizer states of every family build on the meta device
  and allocate nothing.
* ``main(["--all"])`` on meta: no cell fails, and a cell is skipped
  exactly where ``shape_applicability`` says (whisper-base x long_500k);
  a failing cell makes ``main`` exit 1.
* ``--run --device cpu`` on the reduced smollm-360m for the int8 decode
  cells and the prefill cell, at shorter sequences: the entry's logits
  on the share's own weights and inputs equal the reference's
  ``decode_step`` / ``prefill`` on the same weights (converted), within
  the tolerances of tests/test_torch_models.py (logits atol 0.02 x
  max|ref| + rtol 0.02; densities 1e-4).
* ``--run`` on the card with no card raises.
* ``--run --device cpu`` on every assigned architecture's reduced
  config, at short shapes: a decode share's two calls in a row give
  bit-identical logits and leave the whole cache as the first left it
  (its state leaves put back, whichever they are), under both KV dtypes
  where the family serves int8; each record's hold against its plain
  run reads 0 (both runs are plain PyTorch on the CPU) and
  ``repeat_identical`` is true.  Every prefill share repeats bit for bit
  too; a train share advances its state and records None.
"""
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from _torch_parity import one_torch_thread, to_np  # noqa: F401 (fixture)
from conftest import tiny_model
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import SHAPES as JSHAPES
from repro.launch.mesh import data_axes as jdata_axes
from repro.models.registry import build_model as jbuild
from repro.sharding import rules as jrules
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_state as jinit_state
from repro_torch.configs import (ASSIGNED, REGISTRY, SHAPES, ShapeSpec,
                                 get_config, reduced, shape_applicability)
from repro_torch.launch import dryrun
from repro_torch.models.api import META
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import OptConfig, init_state, tree_leaves

ARCHS = sorted(REGISTRY)
# the one dtype the two packages' dry-run trees differ in
POS_DTYPES = ("int64", "int32")


@functools.lru_cache(maxsize=None)
def _ref(arch):
    model = jbuild(JREGISTRY[arch])
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _port_view(tree):
    return {p: (tuple(t.shape), _dtype(t)) for p, t in _flat(tree).items()}


def _ref_view(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, s in leaves:
        p = tuple(k.key for k in path)
        dt = str(s.dtype)
        if p[-1] == "pos":
            assert dt == POS_DTYPES[1]
            dt = POS_DTYPES[0]
        out[p] = (tuple(s.shape), dt)
    return out


def _skip_inapplicable(arch, shape_name):
    ok, _ = shape_applicability(get_config(arch), SHAPES[shape_name])
    if not ok:
        pytest.skip("shape inapplicable")


# --------------------------------------------------------------------- #
# input specs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch, shape_name):
    _skip_inapplicable(arch, shape_name)
    shape = SHAPES[shape_name]
    model = build_model(get_config(arch), "cpu")
    jmodel, _ = _ref(arch)
    entry, kw = model.input_specs(shape)
    jentry, jkw = jmodel.input_specs(JSHAPES[shape_name])
    assert entry == jentry
    assert _port_view(kw) == _ref_view(jkw)
    assert all(t.is_meta for t in _flat(kw).values())
    assert model.streaming_window(shape) == jmodel.streaming_window(
        JSHAPES[shape_name])
    assert model.decode_seq(shape) == jmodel.decode_seq(JSHAPES[shape_name])
    if entry == "decode":
        assert _port_view(model.cache_specs(shape, torch.int8)) == \
            _ref_view(jmodel.cache_specs(JSHAPES[shape_name], jnp.int8))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_states_build_on_meta(arch):
    """Every family's full parameter dict, and both forms of the
    optimizer state, on the meta device: shapes and dtypes as the
    reference's, nothing allocated."""
    model = build_model(get_config(arch), META)
    params = model.init(torch.Generator())
    _, jparams = _ref(arch)
    assert _port_view(params) == _ref_view(jparams)
    for q in (False, True):
        state = init_state(params, OptConfig(quantized=q))
        jstate = jax.eval_shape(functools.partial(
            jinit_state, cfg=JOptConfig(quantized=q)), jparams)
        assert _port_view(state) == _ref_view(jstate)
        assert all(t.is_meta for t in tree_leaves(state))


# --------------------------------------------------------------------- #
# per-device argument bytes
# --------------------------------------------------------------------- #
def _ref_tree_bytes(tree, specs) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    slv = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, JP))
    assert len(leaves) == len(slv)
    total = 0
    for leaf, spec in zip(leaves, slv):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = np.dtype(leaf.dtype).itemsize
        for dim, e in zip(leaf.shape, entries):
            assert dim % jrules._axsize(e) == 0
            n *= dim // jrules._axsize(e)
        total += n
    return total


def _ref_argument_bytes(arch, shape_name, multi_pod, decode_sharding,
                        kv_dtype, train_sharding) -> int:
    """The reference's ``build_cell`` arguments and in_shardings (its
    trees and rules, without the mesh) -> the bytes one device holds."""
    cfg, shape = JREGISTRY[arch], JSHAPES[shape_name]
    model, params = _ref(arch)
    dp = jdata_axes(multi_pod)
    entry, kw = model.input_specs(shape)
    p_specs = jrules.param_pspecs(cfg, params)
    if entry == "train":
        opt = JOptConfig(quantized=cfg.param_count() > 2e10)
        state = jax.eval_shape(functools.partial(jinit_state, cfg=opt),
                               params)
        mode = "train_expert2d" if train_sharding == "expert2d" else "train"
        return (_ref_tree_bytes(state, jrules.state_pspecs(cfg, state,
                                                           mode=mode))
                + _ref_tree_bytes(kw["batch"],
                                  jrules.batch_pspecs(kw["batch"], dp)))
    if entry == "prefill":
        return (_ref_tree_bytes(params, p_specs)
                + _ref_tree_bytes(kw["batch"],
                                  jrules.batch_pspecs(kw["batch"], dp)))
    n_data = 32 if multi_pod else 16
    tok_spec = JP(dp, None) if shape.global_batch >= n_data \
        else JP(None, None)
    if decode_sharding == "stationary":
        p_specs = jrules.param_pspecs(cfg, params, mode="decode")
    cache = kw["cache"]
    if kv_dtype == "int8" and model.kv_spec().int8_serving:
        cache = model.cache_specs(shape, dtype=jnp.int8)
    return (_ref_tree_bytes(params, p_specs)
            + _ref_tree_bytes(kw["tokens"], tok_spec)
            + _ref_tree_bytes(cache, jrules.cache_pspecs(cfg, cache, shape,
                                                         dp)))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_argument_bytes_equal_the_reference(arch, shape_name, multi_pod):
    _skip_inapplicable(arch, shape_name)
    kind = SHAPES[shape_name].kind
    variants = {"train": [("fsdp", "bf16", "fsdp"),
                          ("fsdp", "bf16", "expert2d")],
                "prefill": [("fsdp", "bf16", "fsdp")],
                "decode": [("fsdp", "bf16", "fsdp"),
                           ("stationary", "int8", "fsdp")]}[kind]
    for decode_sharding, kv, train_sharding in variants:
        rec = dryrun.run_cell(arch, shape_name, multi_pod, None,
                              decode_sharding, kv, "", train_sharding)
        assert rec["status"] == "ok", rec.get("error")
        want = _ref_argument_bytes(arch, shape_name, multi_pod,
                                   decode_sharding, kv, train_sharding)
        pos_extra = 4 if kind == "decode" else 0      # int64 pos
        assert rec["memory"]["argument_size_in_bytes"] == want + pos_extra
        assert sum(rec["argument_bytes_by_arg"].values()) == \
            rec["memory"]["argument_size_in_bytes"]
        assert rec["whole_argument_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"]
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert set(rec["not_measured"]) >= {"collectives", "compile_s",
                                            "temp_size_in_bytes", "flops"}


# --------------------------------------------------------------------- #
# main on meta
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("multi_pod", [False, True])
def test_main_all_on_meta(tmp_path, multi_pod):
    argv = ["--all", "--out", str(tmp_path)] + (["--multi-pod"]
                                                if multi_pod else [])
    recs = dryrun.main(argv)
    assert len(recs) == len(ASSIGNED) * len(SHAPES)
    assert not [r for r in recs if r["status"] == "fail"]
    skipped = {(r["arch"], r["shape"]) for r in recs
               if r["status"] == "skipped"}
    assert skipped == {(a, s) for a in ASSIGNED for s in SHAPES
                       if not shape_applicability(get_config(a),
                                                  SHAPES[s])[0]}
    assert skipped == {("whisper-base", "long_500k")}
    mesh = "2x16x16" if multi_pod else "16x16"
    files = sorted(os.listdir(tmp_path))
    assert len(files) == len(recs)
    with open(tmp_path / f"dryrun_qwen3-32b_train_4k_{mesh}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["entry"] == "train"
    assert "one_card" not in rec


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_cells_allocate_nothing(arch):
    for shape_name in SHAPES:
        for kv in ("bf16", "int8"):
            cell, _ = dryrun.build_cell(arch, shape_name, False,
                                        kv_dtype=kv)
            if cell is None:
                continue
            leaves = [t for a in cell.args for t in _flat(a).values()]
            assert leaves and all(t.is_meta for t in leaves)


def test_a_failing_cell_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise ValueError("broken cell")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "dryrun_smollm-360m_train_4k_16x16.json"
                      ).read_text())
    assert rec["status"] == "fail" and "broken cell" in rec["error"]


def test_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--run", "--out", ""])


def test_model_flops_match_the_smoke_formula():
    import chip_smoke
    cfg = get_config("smollm-360m")
    assert dryrun.model_flops(cfg, "train", 8, 4096) == \
        chip_smoke._train_flops(cfg, 4096, 8)
    for S, w, s in ((37, 0, 0), (300, 64, 4), (300, 64, 0), (50, 64, 4)):
        i = np.arange(S)[:, None]
        j = np.arange(S)[None, :]
        seen = j <= i
        if w:
            seen &= (j > i - w) | (j < s)
        assert dryrun._causal_pairs(S, w, s) == int(seen.sum())
    assert dryrun.model_flops(get_config("rwkv6-1.6b"), "decode", 1,
                              100) is None


# --------------------------------------------------------------------- #
# --run on the CPU against the reference
# --------------------------------------------------------------------- #
def _to_jax(tree):
    def one(t):
        a = to_np(t)
        return jnp.asarray(a).astype(jnp.bfloat16) \
            if t.dtype == torch.bfloat16 else jnp.asarray(a)
    return {k: _to_jax(v) if isinstance(v, dict) else one(v)
            for k, v in tree.items()}


def _close_bf16(a, b, frac=0.02):
    a, b = to_np(a), to_np(b)
    scale = float(np.max(np.abs(a))) or 1.0
    np.testing.assert_allclose(b, a, rtol=frac, atol=frac * scale)


ARCH = "smollm-360m"


def _share(shape):
    cfg = reduced(get_config(ARCH))
    kv = "int8" if shape.kind == "decode" else "bf16"
    cell, _ = dryrun.build_cell(ARCH, shape.name, False, kv_dtype=kv,
                                cfg=cfg, shape=shape)
    return cell, dryrun.share_inputs(cell, False, "cpu", seed=3)


@pytest.mark.parametrize("shape", [
    ShapeSpec("decode_32k", "decode", 300, 128),
    ShapeSpec("long_500k", "decode", 8400, 1)], ids=lambda s: s.name)
def test_run_int8_decode_matches_the_reference(shape):
    """The share's all-int8 decode (B = global / 16, pos = S - 1, random
    codes and scales) against the reference's jitted ``decode_step`` on
    the same weights, cache and token; long_500k under its window of
    8192 + 128 sinks, which the 8400-deep cache exceeds."""
    cell, share = _share(shape)
    assert cell.kv_dtype == torch.int8 and share.S == shape.seq_len
    assert cell.window == ((8192, 128) if shape.name == "long_500k"
                           else (0, 0))
    params, tokens, cache = share.args
    jp, jc = _to_jax(params), _to_jax(cache)
    jc["pos"] = jnp.asarray(int(cache["pos"]), jnp.int32)
    jtok = jnp.asarray(tokens.numpy(), jnp.int32)
    _, jmodel, _ = tiny_model(ARCH)
    w, s = cell.window
    jout = jax.jit(lambda p, t, c: jmodel.decode_step(
        p, t, c, window=w, n_sinks=s))(jp, jtok, jc)
    out = share.call()
    _close_bf16(jout.logits, out.logits)
    assert int(out.cache["pos"]) == shape.seq_len
    rec = dryrun.run_cell(ARCH, shape.name, False, None, kv_dtype="int8",
                          run=True, device="cpu", seed=3,
                          cfg=reduced(get_config(ARCH)), shape=shape)
    one = rec["one_card"]
    assert rec["status"] == "ok", rec.get("error")
    assert one["batch"] == max(1, shape.global_batch // 16)
    assert one["reduced"] == [] and one["peak_bytes"] is None
    assert one["max_err_vs_plain"]["same_greedy_pick"]
    assert one["max_err_vs_plain"]["decode_qattn"]["layers"] == 4
    assert one["model_flops"] == dryrun.model_flops(
        reduced(get_config(ARCH)), "decode", one["batch"], shape.seq_len,
        w, s)


def test_run_prefill_matches_the_reference():
    """The share's prefill (B 2 of 32) at 2,100 tokens, past 2048, so the
    port takes the flash form as at the cell's 32k, against the
    reference's prefill on the same weights and tokens: logits and the
    density; then the record's hold of the first attn_density call on
    its last 512 query rows."""
    shape = ShapeSpec("prefill_32k", "prefill", 2100, 32)
    cell, share = _share(shape)
    params, batch = share.args
    assert tuple(batch["tokens"].shape) == (2, 2100)
    _, jmodel, _ = tiny_model(ARCH)
    jout = jax.jit(lambda p, t: jmodel.prefill(
        p, {"tokens": t}, want_density=True))(
        _to_jax(params), jnp.asarray(batch["tokens"].numpy(), jnp.int32))
    out = share.call()
    _close_bf16(jout.logits, out.logits)
    np.testing.assert_allclose(out.density.numpy(),
                               np.asarray(jout.density), atol=1e-4)
    rec = dryrun.run_cell(ARCH, shape.name, False, None, run=True,
                          device="cpu", seed=3,
                          cfg=reduced(get_config(ARCH)), shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    hold = rec["one_card"]["max_err_vs_plain"]["attn_density"]
    assert (hold["rows"], hold["keys"]) == (512, 2100)
    assert hold["out"] == 0.0 and hold["density"] == 0.0


# --------------------------------------------------------------------- #
# --run on the CPU: every share repeats from the same state
# --------------------------------------------------------------------- #
SHORT = {"decode_32k": ShapeSpec("decode_32k", "decode", 300, 128),
         "long_500k": ShapeSpec("long_500k", "decode", 8400, 1),
         "prefill_32k": ShapeSpec("prefill_32k", "prefill", 300, 32),
         "train_4k": ShapeSpec("train_4k", "train", 64, 32)}


def _share_cases(kinds):
    """(arch, short shape, kv dtype) of every assigned architecture and
    applicable shape of ``kinds``; a decode under int8 too where the
    family serves int8."""
    for arch in sorted(ASSIGNED):
        cfg = get_config(arch)
        int8 = build_model(cfg, META).kv_spec().int8_serving
        for shape in SHORT.values():
            if shape.kind not in kinds or not shape_applicability(
                    cfg, shape)[0]:
                continue
            kvs = ("bf16", "int8") if int8 and shape.kind == "decode" \
                else ("bf16",)
            for kv in kvs:
                yield pytest.param(arch, shape, kv,
                                   id=f"{arch}-{shape.name}-{kv}")


@pytest.mark.parametrize("arch,shape,kv", list(_share_cases(("decode",))))
def test_decode_share_repeats_from_the_same_state(arch, shape, kv):
    """Two ``share.call()``s in a row: bit-identical logits, and every
    cache leaf after the second as after the first (a leaf the restore
    missed would be rewritten from a moved state); then ``run_cell``'s
    record: no fail, the hold against the plain run 0, the repeat gate
    true."""
    cfg = reduced(get_config(arch))
    cell, _ = dryrun.build_cell(arch, shape.name, False, kv_dtype=kv,
                                cfg=cfg, shape=shape)
    share = dryrun.share_inputs(cell, False, "cpu", seed=3)
    cache = share.args[2]
    first = share.call().logits
    after = {n: t.clone() for n, t in cache.items()}
    second = share.call().logits
    assert torch.equal(first, second)
    for n, t in cache.items():
        assert torch.equal(t, after[n]), n
    rec = dryrun.run_cell(arch, shape.name, False, None, kv_dtype=kv,
                          run=True, device="cpu", seed=3, cfg=cfg,
                          shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    one = rec["one_card"]
    assert one["repeat_identical"] is True
    err = one["max_err_vs_plain"]
    assert err["logits"] == 0.0 and err["logits_rel_l2"] == 0.0


def test_state_leaves_are_the_cache_leaves_without_a_sequence_axis():
    """The restore's leaves: the recurrent state of RWKV6 and
    recurrentgemma, the image / encoder K/V of the VLM and whisper, no
    leaf of the dense caches (their scales included)."""
    want = {"rwkv6-1.6b": ("wkv", "tm", "cm"),
            "recurrentgemma-2b": ("conv", "lru"),
            "llama-3.2-vision-90b": ("xk", "xv"),
            "whisper-base": ("xk", "xv"),
            "qwen2.5-14b": (), "deepseek-v2-lite-16b": ()}
    for arch, names in want.items():
        model = build_model(reduced(get_config(arch)), META)
        assert dryrun.state_leaves(model) == names, arch
    assert dryrun.state_leaves(build_model(get_config("qwen2.5-14b"), META),
                               torch.int8) == ()


@pytest.mark.parametrize("arch,shape,kv",
                         list(_share_cases(("prefill", "train"))))
def test_prefill_and_train_shares_run(arch, shape, kv):
    """Every prefill and train share runs with no fail; a prefill's last
    timed call repeats the warm one bit for bit, a train share records
    no repeat."""
    rec = dryrun.run_cell(arch, shape.name, False, None, kv_dtype=kv,
                          run=True, device="cpu", seed=3,
                          cfg=reduced(get_config(arch)), shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["one_card"]["repeat_identical"] is (
        True if shape.kind == "prefill" else None)
