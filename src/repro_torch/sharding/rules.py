"""Sharding rules for every family, keyed by the leaf's name.

The port's copy of the JAX package's ``sharding/rules.py``, over the
port's nested dicts of tensors (real or on the meta device) instead of
pytrees.  A spec is a ``P``: a tuple with one entry a dim, each entry a
mesh axis name, a tuple of names or ``None`` (replicated); ``P`` compares
as the tuple of its entries, as ``jax.sharding.PartitionSpec`` does.

Strategy, as the reference's:
  * 2D weight sharding: tensor-parallel over "model" on the output
    (heads / ffn-hidden / vocab / experts) and FSDP over "data" on the
    contracting d_model dim;
  * the batch over ("pod", "data"); decode caches shard the SEQUENCE
    over "model";
  * long context (batch < the data axis) shards the cache sequence over
    all axes.

A leaf without a rule replicates (small norms and biases).  One card
places nothing with these specs: the dry run reads from them the bytes
one device of the production mesh would hold (``shard_bytes``, the
counterpart of the reference's per-device
``memory_analysis().argument_size_in_bytes``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import production_mesh

# production axis sizes (kept in step with launch/mesh.py); used to DROP
# a sharded axis whose dim isn't divisible (e.g. whisper's 51865 vocab)
AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}


class P(tuple):
    """A partition spec: ``P("data", None)``; equal to any tuple, or
    ``PartitionSpec``, of the same entries.  Entries are canonical as
    ``PartitionSpec`` makes them: a list becomes a tuple, a tuple of one
    name that name, an empty tuple ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


def _axsize(entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for e in entry:
            n *= AXIS_SIZE[e]
        return n
    return AXIS_SIZE[entry]


def sanitize(spec: P, shape) -> P:
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(e if dim % _axsize(e) == 0 else None
               for dim, e in zip(shape, entries)))


# leaves whose LAST dim is the "wide" output (shard model), second-to-last
# is d_model-like (shard data/fsdp)
IN_PROJ = {"wq", "wk", "wv", "w_gate", "w_up", "w_x", "wck", "wcr", "wr",
           "wg", "w1", "s_gate", "s_up", "w_dkv", "embed_proj"}
# leaves whose LAST dim is d_model-like (shard data), second-to-last wide
OUT_PROJ = {"wo", "w_down", "w_out", "wcv", "w2", "s_down"}


def map_named(fn: Callable[[str, Any], Any], tree, name: str = ""):
    """``fn(leaf name, leaf)`` over the leaves of nested dicts; a leaf's
    name is its innermost dict key, as the reference's ``_leaf_name``."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def param_pspecs(cfg: ModelConfig, params_tree, *, fsdp: str = "data",
                 tp: str = "model", mode: str = "train"):
    """Nested dicts of tensors -> the same dicts of ``P``.

    mode "train" / "prefill": 2D FSDP x TP weights.
    mode "decode": weight-stationary: dense projections TP-sharded and
    replicated over the data axis, MoE experts 2D as (experts x
    ffn-hidden) over (model x data).
    mode "train_expert2d": training with the experts laid out as in
    "decode"."""
    decode = mode == "decode"
    expert2d = mode == "train_expert2d"

    def rule(name, nd):
        lead = (None,) * (nd - 2)
        if name == "embed":
            return P(tp, fsdp)
        if name in ("head", "projector"):
            return P(fsdp, tp)
        if name == "pos_dec":
            return P(None, fsdp)
        if name in ("w_gate", "w_up") and nd == 4:      # MoE experts
            return P(None, tp, None, fsdp) if (decode or expert2d) \
                else P(None, tp, fsdp, None)
        if name == "w_down" and nd == 4:
            return P(None, tp, fsdp, None) if (decode or expert2d) \
                else P(None, tp, None, fsdp)
        if name in ("w_uk", "w_uv"):
            return P(None, None, tp)
        if name in ("gate_a_w", "gate_x_w"):
            return P(None, None, None, tp)
        if name == "conv_k":
            return P(None, None, tp)
        if name in ("conv_b", "lam"):
            return P(None, tp)
        if name in ("w_a", "mix_w1"):
            return P(None, fsdp, None)
        if name == "w_b":
            return P(None, None, fsdp)
        if name == "mix_w2":
            return P(None, None, None, fsdp)
        if name == "router":
            return P()                                   # small, replicated
        if name in IN_PROJ and nd >= 2:
            return P(*lead, None, tp) if decode else P(*lead, fsdp, tp)
        if name in OUT_PROJ and nd >= 2:
            return P(*lead, tp, None) if decode else P(*lead, tp, fsdp)
        return P()                                       # norms, biases, u

    return map_named(lambda name, leaf: sanitize(
        rule(name, len(leaf.shape)), leaf.shape), params_tree)


def batch_pspecs(batch_tree, dp: Tuple[str, ...]):
    return map_named(lambda name, leaf: P(
        dp, *(None,) * (len(leaf.shape) - 1)), batch_tree)


def cache_pspecs(cfg: ModelConfig, cache_tree, shape: ShapeSpec,
                 dp: Tuple[str, ...], tp: str = "model"):
    """Decode-cache specs.  Leaves are (L, B, S, ...) for sequence
    caches, family-specific for states.  A batch of at least 16 shards
    over ``dp`` and the sequence over ``tp``; a smaller one (long_500k)
    shards the sequence over (dp..., tp)."""
    big_batch = shape.global_batch >= 16
    seq_shard = (tp,) if big_batch else tuple(dp) + (tp,)
    bspec = dp if big_batch else None

    def rule(name, nd):
        if name == "pos":
            return P()
        if name in ("k", "v", "ckv", "kpe", "k_scale", "v_scale"):
            return P(None, bspec, seq_shard, *(None,) * (nd - 3))
        if name in ("xk", "xv"):                          # (L,B,F,H,hd)
            return P(None, bspec, None, None, tp)
        if name == "wkv":                                 # (L,B,H,hk,hv)
            return P(None, bspec, tp, None, None)
        if name in ("tm", "cm", "lru"):                   # (L,B,d)
            return P(None, bspec, tp)
        if name == "conv":                                # (L,B,cw-1,w)
            return P(None, bspec, None, tp)
        return P()

    return map_named(lambda name, leaf: sanitize(
        rule(name, len(leaf.shape)), leaf.shape), cache_tree)


def state_pspecs(cfg: ModelConfig, state_tree, *, fsdp: str = "data",
                 tp: str = "model", mode: str = "train"):
    """Train state ({"params", "mu", "nu", ["mu_scale", "nu_scale"],
    "step"}): the moments share the parameters' specs; the 8-bit
    moments' per-row scales take the parameter's spec minus its last
    dim."""
    p_specs = param_pspecs(cfg, state_tree["params"], fsdp=fsdp, tp=tp,
                           mode=mode)
    out: Dict[str, Any] = {}
    for k in state_tree:
        if k == "step":
            out[k] = P()
        elif k in ("mu_scale", "nu_scale"):
            out[k] = map_named(lambda name, s: P(*s[:-1]), p_specs)
        else:
            out[k] = p_specs
    return out


def shard_bytes(tree, specs, multi_pod: bool) -> int:
    """The bytes one device of the production mesh holds of ``tree``
    under ``specs`` (the same nested dicts, or a tensor and its ``P``):
    each leaf's dims divided by
    the sizes of the axes its spec names, times its item size.  Raises
    for an axis the mesh lacks or a dim the axes do not divide."""
    axes = set(production_mesh(multi_pod).axes)
    total = 0

    def add(leaf, spec):
        nonlocal total
        n = leaf.element_size()
        for i, dim in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            names = e if isinstance(e, (tuple, list)) else (e,)
            if any(a is not None and a not in axes for a in names):
                raise ValueError(f"spec {spec} names an axis outside the "
                                 f"mesh {sorted(axes)}")
            if dim % _axsize(e):
                raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does "
                                 f"not split over {e}")
            n *= dim // _axsize(e)
        total += n

    _zip_leaves(add, tree, specs)
    return total


def whole_bytes(tree) -> int:
    """The bytes of every leaf of ``tree`` (nested dicts or a tensor),
    unsharded."""
    if isinstance(tree, dict):
        return sum(whole_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _zip_leaves(fn, tree, specs) -> None:
    if isinstance(tree, dict):
        if set(tree) != set(specs):
            raise ValueError(f"specs {sorted(specs)} do not match the tree "
                             f"{sorted(tree)}")
        for k, v in tree.items():
            _zip_leaves(fn, v, specs[k])
    else:
        fn(tree, specs)
