"""The port's sharding rules (``repro_torch/sharding/rules.py``) against
the JAX package's.

* The four structural checks of ``tests/test_sharding.py`` carried over
  onto the port: every sharded dim of every arch's params, 8-bit train
  state and decode caches divides the production axis sizes, and
  qwen3-32b's big weights are sharded (not silently replicated).
* Leaf for leaf, the port's specs equal the reference's for every arch
  of the registry: ``param_pspecs`` in its four modes, ``state_pspecs``
  over the fp32 and the 8-bit optimizer state, ``cache_pspecs`` over the
  bf16 and the int8 decode caches of ``decode_32k`` and ``long_500k``,
  and ``batch_pspecs`` over every shape's batch on both meshes.  The
  port's trees come from models built on the meta device; the
  reference's from ``jax.eval_shape``.  The two packages' parameter,
  state and cache trees have the same nested keys (what
  ``models/convert.py`` carries across unchanged), so a leaf is matched
  by its path.  Where the reference skips a shape (whisper-base x
  long_500k), the port's test skips it too.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JP

from repro.configs import REGISTRY as JREGISTRY
from repro.models.registry import build_model as jbuild
from repro.sharding import rules as jrules
from repro.train.optimizer import OptConfig as JOptConfig
from repro.train.optimizer import init_state as jinit_state
from repro_torch.configs import (ASSIGNED, REGISTRY, SHAPES, get_config,
                                 shape_applicability)
from repro_torch.launch.mesh import data_axes, production_mesh
from repro_torch.models.api import META
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import (AXIS_SIZE, P, _axsize,
                                        batch_pspecs, cache_pspecs,
                                        param_pspecs, state_pspecs)
from repro_torch.train.optimizer import OptConfig, init_state

ARCHS = sorted(REGISTRY)
MODES = ("train", "prefill", "decode", "train_expert2d")
DECODE_SHAPES = ("decode_32k", "long_500k")


# --------------------------------------------------------------------- #
# trees of both packages
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _port(arch):
    """(model, params) of ``arch`` on the meta device."""
    model = build_model(get_config(arch), META)
    return model, model.init(torch.Generator())


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """(model, params as ShapeDtypeStructs) of the reference."""
    model = jbuild(JREGISTRY[arch])
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _flat(tree, path=()):
    """Nested dicts -> {path: leaf}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _jflat(tree, is_spec=False):
    """A reference pytree of dicts -> {path: leaf} (specs as leaves)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, JP)) if is_spec else None)[0]
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


def _same_specs(port_specs, ref_specs, where):
    got = {p: tuple(s) for p, s in _flat(port_specs).items()}
    want = {p: tuple(s) for p, s in _jflat(ref_specs, True).items()}
    assert set(got) == set(want), where
    bad = {p: (got[p], want[p]) for p in got if got[p] != want[p]}
    assert not bad, (where, bad)


def _check_tree(tree, specs, where):
    leaves, slv = _flat(tree), _flat(specs)
    assert set(leaves) == set(slv), where
    for path, leaf in leaves.items():
        entries = tuple(slv[path])
        assert len(entries) <= len(leaf.shape), (where, path, entries)
        for dim, e in zip(leaf.shape, entries):
            assert dim % _axsize(e) == 0, (where, path, leaf.shape, entries)


def _skip_inapplicable(arch, shape_name):
    ok, _ = shape_applicability(get_config(arch), SHAPES[shape_name])
    if not ok:
        pytest.skip("shape inapplicable")


# --------------------------------------------------------------------- #
# the reference's structural checks, on the port
# --------------------------------------------------------------------- #
def test_axis_sizes_match_the_production_mesh():
    for multi_pod in (False, True):
        mesh = production_mesh(multi_pod)
        assert mesh.shape == tuple(AXIS_SIZE[a] for a in mesh.axes)
        assert set(data_axes(multi_pod)) <= set(mesh.axes)
    assert AXIS_SIZE == jrules.AXIS_SIZE
    assert (production_mesh().name, production_mesh(True).name) == (
        "16x16", "2x16x16")


def test_spec_compares_as_the_reference_partition_spec():
    assert P("data", None) == JP("data", None)
    for entries in ((("a",), None, ["b", "c"], (), ("x", "y")),
                    (("pod", "data"), ("model",))):
        assert tuple(P(*entries)) == tuple(JP(*entries))
    assert P() == () and repr(P("model")) == "P('model',)"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_divisible(arch):
    _, params = _port(arch)
    _check_tree(params, param_pspecs(get_config(arch), params), arch)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_state_specs_divisible(arch):
    _, params = _port(arch)
    state = init_state(params, OptConfig(quantized=True))
    _check_tree(state, state_pspecs(get_config(arch), state), arch)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
def test_cache_specs_divisible(arch, shape_name):
    _skip_inapplicable(arch, shape_name)
    model, _ = _port(arch)
    shape = SHAPES[shape_name]
    cache = model.cache_specs(shape)
    specs = cache_pspecs(get_config(arch), cache, shape, ("data",))
    _check_tree(cache, specs, f"{arch}/{shape_name}")


def test_sharded_params_have_major_coverage():
    """The big 2D-shardable weights must be sharded (not silently
    replicated)."""
    _, params = _port("qwen3-32b")
    specs = _flat(param_pspecs(get_config("qwen3-32b"), params))
    leaves = _flat(params)
    assert any("wq" in p and tuple(s) != () for p, s in specs.items())
    sharded = sum(leaves[p].numel() for p, s in specs.items() if tuple(s))
    total = sum(leaf.numel() for leaf in leaves.values())
    assert sharded / total > 0.95


# --------------------------------------------------------------------- #
# leaf for leaf against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mode):
    cfg = get_config(arch)
    _, params = _port(arch)
    _, jparams = _ref(arch)
    assert {p: tuple(t.shape) for p, t in _flat(params).items()} == {
        p: tuple(s.shape) for p, s in _jflat(jparams).items()}
    _same_specs(param_pspecs(cfg, params, mode=mode),
                jrules.param_pspecs(JREGISTRY[arch], jparams, mode=mode),
                f"{arch} {mode}")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_equal_the_reference(arch, quantized):
    _, params = _port(arch)
    _, jparams = _ref(arch)
    state = init_state(params, OptConfig(quantized=quantized))
    jstate = jax.eval_shape(functools.partial(
        jinit_state, cfg=JOptConfig(quantized=quantized)), jparams)
    assert {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for p, t in _flat(state).items()} == {
        p: (tuple(s.shape), str(s.dtype)) for p, s in _jflat(jstate).items()}
    for mode in ("train", "train_expert2d"):
        _same_specs(state_pspecs(get_config(arch), state, mode=mode),
                    jrules.state_pspecs(JREGISTRY[arch], jstate, mode=mode),
                    f"{arch} quantized={quantized} {mode}")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, shape_name, kv):
    _skip_inapplicable(arch, shape_name)
    shape = SHAPES[shape_name]
    model, _ = _port(arch)
    jmodel, _ = _ref(arch)
    cache = model.cache_specs(
        shape, torch.int8 if kv == "int8" else torch.bfloat16)
    jcache = jmodel.cache_specs(shape,
                                jnp.int8 if kv == "int8" else jnp.bfloat16)
    for multi_pod in (False, True):
        dp = data_axes(multi_pod)
        _same_specs(cache_pspecs(get_config(arch), cache, shape, dp),
                    jrules.cache_pspecs(JREGISTRY[arch], jcache, shape, dp),
                    f"{arch} {shape_name} {kv} {dp}")


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_the_reference(arch, shape_name):
    _skip_inapplicable(arch, shape_name)
    shape = SHAPES[shape_name]
    model, _ = _port(arch)
    jmodel, _ = _ref(arch)
    batch, jbatch = model.batch_specs(shape), jmodel.batch_specs(shape)
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in jbatch.items()}
    for multi_pod in (False, True):
        dp = data_axes(multi_pod)
        _same_specs(batch_pspecs(batch, dp), jrules.batch_pspecs(jbatch, dp),
                    f"{arch} {shape_name} {dp}")
