"""Dry run of every (arch x shape x mesh) cell, and one card's share of a
cell.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  For
each cell it

  1. builds the model and its inputs on the meta device
     (``input_specs``: tensors with a shape and a dtype that allocate
     nothing, as ``jax.ShapeDtypeStruct`` + ``jax.eval_shape``),
  2. picks the entry point (the train step, ``prefill`` or
     ``decode_step``) and the production specs of its arguments
     (``sharding/rules.py``),
  3. reckons the bytes one device of the 16x16 (single pod) or 2x16x16
     (multi-pod) mesh holds of those arguments (``shard_bytes``: the
     reference reads the same number from ``memory_analysis()``),

and writes one JSON record a cell under ``--out``.  What the reference
takes from XLA's compile has no counterpart on one card, and the record
says so under ``not_measured`` instead of writing a zero: the
collective bytes (no HLO, and one card runs no collective), the lower
and compile times, the temporary and code sizes, and ``cost_analysis``'s
FLOPs.  The reference's ``set_batch_axes`` and the train step's
``with_sharding_constraint`` place a batch on a mesh and have no
counterpart either.

``--run`` stands in for the compile that one card cannot do for a
256-chip program: it builds the hand kernels and runs the entry once at
the cell's shapes on ``--device`` (the card by default; it raises where
there is none), taking the cell's data-parallel share: a batch of
``max(1, global_batch // n_data)`` (n_data 16 or 32), the sequence and
the widths as the cell gives them, and the depth cut only where the
arguments would not fit the card (each cut listed under ``reduced``).
Weights come from a seeded ``torch.Generator`` on the device, tokens
from ``numpy.random.default_rng(--seed)``, and a decode cache is filled
with random codes (int8) or values (bf16) and positive scales, with
``pos = seq - 1``: one new token against a seq_len-deep cache, every
call from the same state (``pos`` and the cache's state leaves are put
back first).  The record gains a ``one_card`` block: the batch, the
cuts, the argument bytes, the peak memory, the wall time (median of 3
calls after a warm one), whether the last call's output is the warm
call's bit for bit (``repeat_identical``; a decode or prefill share
raises where it is not), each kernel's launches in one call, the model
FLOPs of the dense family and their rate, and the entry held against
its plain version (a decode's logits and greedy picks against the same
``decode_step`` with the kernels' plain versions; the first
``attn_density`` call's last 512 query rows, over all its keys, against
the plain version).  A cell that fails is recorded as ``fail`` and
``main`` exits 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape decode_32k --kv-dtype int8 --run
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config, \
    shape_applicability
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import data_axes, production_mesh
from repro_torch.launch.train import make_train_step
from repro_torch.models.api import META, resolve_device
from repro_torch.models.registry import build_model
from repro_torch.sharding.rules import (P, batch_pspecs, cache_pspecs,
                                        param_pspecs, shard_bytes,
                                        state_pspecs, whole_bytes)
from repro_torch.train.optimizer import OptConfig, init_state

# what the reference's record holds that a dry run on one card cannot
# measure, with the reason; the record lists these instead of zeros
NOT_MEASURED = {
    "collectives": "no HLO to parse, and one card runs no collective",
    "lower_s": "no XLA lowering", "compile_s": "no XLA compile",
    "temp_size_in_bytes": "no XLA compile",
    "generated_code_size_in_bytes": "no XLA compile",
    "flops": "no XLA cost_analysis (one_card.model_flops counts the "
             "dense family's model FLOPs instead)",
}
# the plain-version holds of --run: out within OUT_TOL of the plain
# out's largest magnitude (two bf16 ulps), the density (or a decode's
# mass) within DENS_TOL of its largest value, the row stats within
# STATS_TOL (m of max(1, |m|), l relative)
OUT_TOL = 2 ** -7
DENS_TOL = 1e-5
STATS_TOL = 1e-5
HOLD_ROWS = 512
# --run cuts depth where the arguments pass this share of the card's
# free memory (the rest for activations and scratch)
FIT_SHARE = 0.9


def big_arch(cfg) -> bool:
    return cfg.param_count() > 2e10


def micro_steps(cfg, shape, multi_pod: bool) -> int:
    """Gradient-accumulation factor: keep per-microbatch activation
    residency ~<= a few GiB/chip.  Heuristic: one sequence per device per
    microstep for d_model >= 4096, else split by activation volume."""
    n_data = 32 if multi_pod else 16
    seqs_per_dev = max(shape.global_batch // n_data, 1)
    S = shape.seq_len
    # per-sequence residency: saved-x (bf16, ~L/sqrt spread) + flash-bwd
    # block transients (fp32 p/ds at block=1024 across heads)
    per_seq = 2 * cfg.d_model * S + 8 * cfg.n_heads * S * 1024
    target = 4 << 30
    micro_seqs = max(1, min(seqs_per_dev, target // max(per_seq, 1)))
    while seqs_per_dev % micro_seqs:
        micro_seqs -= 1
    return max(1, seqs_per_dev // micro_seqs)


class Cell(NamedTuple):
    entry: str                      # "train" | "prefill" | "decode"
    fn: Any                         # the entry, called as fn(*args)
    args: Tuple                     # meta tensors (nested dicts)
    specs: Tuple                    # one spec tree an argument
    arg_names: Tuple[str, ...]
    model: Any
    shape: ShapeSpec
    window: Tuple[int, int]         # (window, n_sinks)
    opt: Optional[OptConfig]
    n_micro: int
    kv_dtype: torch.dtype


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               decode_sharding: str = "fsdp", kv_dtype: str = "bf16",
               train_sharding: str = "fsdp", cfg: ModelConfig = None,
               shape: ShapeSpec = None):
    """-> (Cell on the meta device, note), or (None, note) where the
    shape does not apply to the arch.  ``cfg`` and ``shape`` replace the
    registry's config of ``arch`` and ``SHAPES[shape_name]`` (a reduced
    config and a shorter sequence, in tests)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    ok, note = shape_applicability(cfg, shape)
    if not ok:
        return None, note
    model = build_model(cfg, META)
    dp = data_axes(multi_pod)
    entry, kwargs = model.input_specs(shape)
    params = model.init(torch.Generator())
    p_specs = param_pspecs(cfg, params)
    window = model.streaming_window(shape)
    common = dict(model=model, shape=shape, window=window,
                  kv_dtype=torch.bfloat16)

    if entry == "train":
        opt = OptConfig(quantized=big_arch(cfg))
        state = init_state(params, opt)
        mode = "train_expert2d" if train_sharding == "expert2d" else "train"
        n_micro = micro_steps(cfg, shape, multi_pod)
        fn = make_train_step(model, opt, n_micro=n_micro)
        return Cell("train", fn, (state, kwargs["batch"]),
                    (state_pspecs(cfg, state, mode=mode),
                     batch_pspecs(kwargs["batch"], dp)),
                    ("state", "batch"), opt=opt, n_micro=n_micro,
                    **common), note
    if entry == "prefill":
        fn = functools.partial(model.prefill,
                               want_density=model.kv_spec().density,
                               window=window[0], n_sinks=window[1])
        return Cell("prefill", fn, (params, kwargs["batch"]),
                    (p_specs, batch_pspecs(kwargs["batch"], dp)),
                    ("params", "batch"), opt=None, n_micro=1,
                    **common), note
    fn = functools.partial(model.decode_step, window=window[0],
                           n_sinks=window[1])
    n_data = 32 if multi_pod else 16
    tok_spec = P(dp, None) if shape.global_batch >= n_data else P(None, None)
    if decode_sharding == "stationary":
        p_specs = param_pspecs(cfg, params, mode="decode")
    cache = kwargs["cache"]
    if kv_dtype == "int8" and model.kv_spec().int8_serving:
        cache = model.cache_specs(shape, dtype=torch.int8)
        common["kv_dtype"] = torch.int8
    return Cell("decode", fn, (params, kwargs["tokens"], cache),
                (p_specs, tok_spec, cache_pspecs(cfg, cache, shape, dp)),
                ("params", "tokens", "cache"), opt=None, n_micro=1,
                **common), note


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = "reports_torch",
             decode_sharding: str = "fsdp", kv_dtype: str = "bf16",
             tag: str = "", train_sharding: str = "fsdp", run: bool = False,
             device="cuda", seed: int = 0, cfg: ModelConfig = None,
             shape: ShapeSpec = None) -> Dict[str, Any]:
    """One cell's record (and file under ``out_dir``): its per-device
    argument bytes on the named mesh, and with ``run`` its share run on
    ``device`` (``one_card``)."""
    mesh_name = production_mesh(multi_pod).name
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "variant": tag or "baseline"}
    try:
        cell, note = build_cell(arch, shape_name, multi_pod,
                                decode_sharding, kv_dtype, train_sharding,
                                cfg, shape)
        rec["note"] = note
        if cell is None:
            rec["status"] = "skipped"
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                  f"SKIP ({note})")
        else:
            by_arg = {n: shard_bytes(a, s, multi_pod) for n, a, s in
                      zip(cell.arg_names, cell.args, cell.specs)}
            rec.update({
                "status": "ok", "entry": cell.entry,
                "window": list(cell.window), "n_micro": cell.n_micro,
                "memory": {"argument_size_in_bytes": sum(by_arg.values())},
                "argument_bytes_by_arg": by_arg,
                "whole_argument_bytes": sum(whole_bytes(a) for a in cell.args),
                "not_measured": NOT_MEASURED,
            })
            gib = sum(by_arg.values()) / 2**30
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"args={gib:.3f}GiB a device, whole="
                  f"{rec['whole_argument_bytes'] / 2**30:.1f}GiB "
                  f"({cell.entry})")
            if run:
                rec["one_card"] = run_share(cell, multi_pod, device, seed)
    except Exception as e:          # noqa: BLE001 — report failures per cell
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL {e}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fname = f"dryrun_{arch}_{shape_name}_{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


# --------------------------------------------------------------------- #
# --run: one card's share of a cell
# --------------------------------------------------------------------- #
def _fit_depth(cfg: ModelConfig, cell: Cell, B: int, dev: torch.device
               ) -> Tuple[ModelConfig, List[str]]:
    """The config to run at batch ``B``: depth cut, in steps the family's
    layer pattern allows, while its arguments pass FIT_SHARE of the
    card's free memory (no cut off the card).  -> (cfg, cuts)."""
    if dev.type != "cuda":
        return cfg, []
    free = torch.cuda.mem_get_info(dev)[0]
    step = cfg.vision.cross_attn_every if cfg.vision else 1
    L = cfg.n_layers
    while True:
        c = cfg.with_overrides(n_layers=L)
        m = build_model(c, META)
        params = m.init(torch.Generator())
        need = whole_bytes(params)
        if cell.entry == "train":
            need = whole_bytes(init_state(params, cell.opt))
        if cell.entry == "decode":
            need += whole_bytes(m.init_cache(B, m.decode_seq(cell.shape),
                                             cell.kv_dtype))
        if need <= FIT_SHARE * free or L <= step:
            break
        L -= step
    cuts = [] if L == cfg.n_layers else [
        f"n_layers {cfg.n_layers} -> {L}: the arguments take "
        f"{need / 2**30:.2f} GiB of the card's {free / 2**30:.2f} GiB free"]
    return c, cuts


def _causal_pairs(S: int, window: int, n_sinks: int) -> int:
    """(query, key) pairs a causal prefill of S tokens attends: query i
    sees key j <= i with j > i - window or j < n_sinks."""
    i = np.arange(S, dtype=np.int64)
    if window <= 0:
        return int(np.sum(i + 1))
    near = np.minimum(i + 1, window)
    sinks = np.clip(np.minimum(n_sinks, i - window + 1), 0, None)
    return int(np.sum(near + sinks))


def model_flops(cfg: ModelConfig, entry: str, B: int, S: int,
                window: int = 0, n_sinks: int = 0) -> Optional[int]:
    """Model FLOPs of one call of a dense model, by ``chip_smoke.py``'s
    ``_train_flops``: 2 per weight and token (q, k, v, o and the three
    FFN projections a layer, and the head) and 2 x (QK + PV) over the
    attended pairs; a train step is 3x its forward (the checkpointed
    recompute not counted), a prefill takes the head at its last
    position only (what it computes), a decode one token against the
    keys it sees.  None for other families."""
    if cfg.family != "dense":
        return None
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    H, KV = cfg.n_heads, cfg.n_kv_heads
    per_layer = d * H * hd * 2 + d * KV * hd * 2 + 3 * d * cfg.d_ff
    if entry == "decode":
        keys = S if window <= 0 else min(S, window + n_sinks)
        return 2 * B * (L * per_layer + d * cfg.vocab) \
            + L * B * H * 4 * hd * keys
    T = B * S
    attn = L * B * H * 4 * hd * _causal_pairs(S, window, n_sinks)
    if entry == "prefill":
        return 2 * T * L * per_layer + 2 * B * d * cfg.vocab + attn
    return 3 * (2 * T * (L * per_layer + d * cfg.vocab) + attn)


@contextlib.contextmanager
def _first_attn_call(kept: Dict[str, Any]):
    """While open, ``kept["args"]`` takes the first ``ops.attn_density``
    call's arguments (tensors detached and cloned)."""
    from repro_torch.kernels import ops
    attn = ops.attn_density

    def keeping(*args, **kw):
        if "args" not in kept:
            kept["args"] = [a.detach().clone() if isinstance(a, torch.Tensor)
                            else a for a in args]
            kept["kw"] = dict(kw)
        return attn(*args, **kw)

    ops.attn_density = keeping
    try:
        yield
    finally:
        ops.attn_density = attn


@contextlib.contextmanager
def _plain_kernels():
    """While open, ``kernels/ops.py`` sends every tensor, on the card
    too, to the kernels' plain versions: the reference run that a --run
    entry is held against.  Nothing else takes this route."""
    from repro_torch.kernels import ops
    route = ops._route
    ops._route = lambda t: "cpu"
    try:
        yield
    finally:
        ops._route = route


def _hold_attn(kept: Dict[str, Any]) -> Optional[Dict[str, float]]:
    """The kept ``attn_density`` call's last HOLD_ROWS query rows over all
    its keys, through ``ops`` (the kernel on the card) against the plain
    version; raises beyond the tolerances.  -> the errors."""
    from repro_torch.kernels import ops, ref
    if "args" not in kept:
        return None
    names = ("q", "k", "v", "q_pos", "seq_len", "window", "n_sinks",
             "want_density", "form", "return_stats")
    a = dict(zip(names, kept["args"]))
    a.update(kept["kw"])
    a["q"], a["q_pos"] = a["q"][:, -HOLD_ROWS:].contiguous(), \
        a["q_pos"][-HOLD_ROWS:].contiguous()
    got = ops.attn_density(**a)
    want = ref.attn_density_plain(**a)
    span = float(want[0].float().abs().max())
    err = {"rows": int(a["q"].shape[1]), "keys": int(a["k"].shape[1]),
           "out": float((got[0].float() - want[0].float()).abs().max()) /
           max(span, 1e-30)}
    ok = torch.isfinite(got[0].float()).all() and err["out"] <= OUT_TOL
    if want[1] is not None:
        err["density"] = float((got[1] - want[1]).abs().max()) / \
            max(float(want[1].abs().max()), 1e-30)
        ok = ok and err["density"] <= DENS_TOL
    if len(want) == 4:
        seen = want[2] > ref.NEG_INF / 2
        m_span = max(1.0, float(want[2][seen].abs().max())
                     if seen.any() else 1.0)
        err["m"] = float((got[2] - want[2]).abs().max()) / m_span
        err["l"] = float(((got[3] - want[3]).abs() / want[3]).max())
        ok = ok and err["m"] <= STATS_TOL and err["l"] <= STATS_TOL
    if not ok:
        raise AssertionError(f"attn_density on the cell's last "
                             f"{err['rows']} query rows differs from its "
                             f"plain version: {err}")
    return err


@contextlib.contextmanager
def _decode_calls(calls: List[Tuple]):
    """While open, ``calls`` takes each ``ops.decode_qattn`` call's
    arguments and result.  The cache arguments are the layer's views of
    the cache, which the call has already written: they stay as the call
    saw them."""
    from repro_torch.kernels import ops
    dq = ops.decode_qattn

    def keeping(*args, **kw):
        res = dq(*args, **kw)
        calls.append((args, kw, res))
        return res

    ops.decode_qattn = keeping
    try:
        yield
    finally:
        ops.decode_qattn = dq


def _hold_decode(calls: List[Tuple]) -> Optional[Dict[str, float]]:
    """Each kept ``decode_qattn`` call (one a layer, made by the plain
    run) again through ``ops`` (the kernel on the card) on the same
    inputs, against the kept plain result: out within OUT_TOL of its
    largest magnitude, the mass within DENS_TOL.  -> the worst errors."""
    from repro_torch.kernels import ops
    if not calls:
        return None
    worst = {"layers": len(calls), "out": 0.0, "mass": 0.0}
    for args, kw, want in calls:
        got = ops.decode_qattn(*args, **kw)
        got, want = ((got, want) if isinstance(want, tuple)
                     else ((got,), (want,)))
        span = max(float(want[0].float().abs().max()), 1e-30)
        worst["out"] = max(worst["out"], float(
            (got[0].float() - want[0].float()).abs().max()) / span)
        if len(want) > 1:
            worst["mass"] = max(worst["mass"], float(
                (got[1] - want[1]).abs().max()))
    if not (worst["out"] <= OUT_TOL and worst["mass"] <= DENS_TOL):
        raise AssertionError(f"decode_qattn differs from its plain version "
                             f"on a layer's inputs: {worst}")
    return worst


def _compare_logits(logits: torch.Tensor, plain: torch.Tensor
                    ) -> Dict[str, Any]:
    """The kernel run's logits against the plain run's, row by row: the
    largest difference, its share of the plain logits' range, the
    relative L2 distance, and each row's greedy picks with the plain
    row's top-2 gap.  Raises for non-finite logits or for a row whose
    picks differ although its top-2 gap is wider than the row's largest
    logit difference (not a near-tie)."""
    d_row = (logits - plain).abs().amax(dim=-1)
    top2 = plain.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    pick, plain_pick = logits.argmax(-1), plain.argmax(-1)
    out = {"logits": float(d_row.max()),
           "logit_range": float(plain.abs().max()),
           "logits_rel_l2": float(torch.linalg.vector_norm(logits - plain)
                                  / torch.linalg.vector_norm(plain)),
           "same_greedy_pick": bool(torch.equal(pick, plain_pick)),
           "picks": [[int(a), int(b), float(g), float(d)] for a, b, g, d in
                     zip(pick, plain_pick, gap, d_row)]}
    apart = (pick != plain_pick) & (gap > d_row)
    if not torch.isfinite(logits).all() or bool(apart.any()):
        raise AssertionError(f"decode against its plain version: {out}")
    return out


def _outputs(entry: str, out) -> Tuple:
    """The tensors of a decode or prefill call's output that a repeat
    must give bit for bit: the logits, and a prefill's density (None
    where it has none)."""
    return (out.logits, out.density) if entry == "prefill" else (
        out.logits,)


def _fill_cache(cache: Dict[str, torch.Tensor], pos: int,
                g: torch.Generator) -> None:
    """Random contents in place: int8 codes in [-127, 127], positive
    scales in [0.5, 1.5) / 127, bf16 / fp32 values N(0, 1); ``pos``."""
    for name, t in cache.items():
        if name == "pos":
            t.fill_(pos)
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=t.device, dtype=torch.int8))
        elif name.endswith("_scale"):
            t.copy_((torch.rand(t.shape, generator=g, device=t.device)
                     + 0.5) / 127)
        elif t.dtype == torch.bool:
            t.zero_()
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=t.device))


def _batch(model, spec: Dict[str, torch.Tensor], B: int, rng, g, dev
           ) -> Dict[str, torch.Tensor]:
    """A real batch of ``B`` rows for the meta ``spec``: tokens and
    targets from ``rng`` (int64), float leaves N(0, 1) from ``g``."""
    out = {}
    for name, t in spec.items():
        shape = (B, *t.shape[1:])
        if t.dtype == torch.int32:
            out[name] = torch.as_tensor(
                rng.integers(1, model.cfg.vocab, shape), dtype=torch.int64,
                device=dev)
        else:
            out[name] = torch.randn(shape, generator=g, device=dev
                                    ).to(t.dtype)
    return out


def state_leaves(model, dtype=torch.bfloat16) -> Tuple[str, ...]:
    """The names of ``model``'s decode cache leaves that have no sequence
    axis, ``pos`` aside: those of one shape in a cache 1 and a cache 2
    positions long (two meta caches, so no list a family).  A
    ``decode_step`` writes a sequence leaf at ``pos`` only, but may
    rewrite these whole: RWKV6's ``wkv`` / ``tm`` / ``cm``,
    recurrentgemma's ``conv`` / ``lru``."""
    meta = type(model)(model.cfg, META)
    one, two = (meta.init_cache(1, n, dtype) for n in (1, 2))
    return tuple(n for n in one
                 if n != "pos" and one[n].shape == two[n].shape)


def _cache_restorer(cache: Dict[str, torch.Tensor], names):
    """-> a function that puts ``pos`` and the leaves ``names`` of
    ``cache`` back, in place, as they are now (a copy of each kept).
    The sequence leaves are not copied: a decode at the same ``pos``
    from the same state writes them with the same values."""
    kept = {n: cache[n].clone() for n in (*names, "pos")}

    def restore():
        for n, t in kept.items():
            cache[n].copy_(t)
    return restore


class Share(NamedTuple):
    model: Any
    cuts: List[str]
    B: int
    S: int
    args: Tuple                     # the entry's real arguments
    call: Any                       # () -> the entry's output


def share_inputs(cell: Cell, multi_pod: bool, device="cuda", seed: int = 0
                 ) -> Share:
    """The model, weights and inputs of the cell's data-parallel share on
    ``device``, and the call that runs its entry on them.  A decode call
    first puts back ``pos`` and every ``state_leaves`` leaf as
    ``_fill_cache`` left them, so every call computes the same token
    from the same state."""
    dev = resolve_device(device)
    shape = cell.shape
    n_data = 32 if multi_pod else 16
    B = max(1, shape.global_batch // n_data)
    cfg, cuts = _fit_depth(cell.model.cfg, cell, B, dev)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    window, n_sinks = cell.window
    if cell.entry == "train":
        batch = _batch(model, cell.args[1], B, rng, g, dev)
        state = {"s": init_state(params, cell.opt)}
        step = make_train_step(model, cell.opt, n_micro=cell.n_micro)

        def call():
            state["s"], metrics = step(state["s"], batch)
            return metrics
        return Share(model, cuts, B, batch["tokens"].shape[1],
                     (state["s"], batch), call)
    if cell.entry == "prefill":
        batch = _batch(model, cell.args[1], B, rng, g, dev)

        def call():
            return model.prefill(params, batch,
                                 want_density=model.kv_spec().density,
                                 window=window, n_sinks=n_sinks)
        return Share(model, cuts, B, batch["tokens"].shape[1],
                     (params, batch), call)
    S = model.decode_seq(shape)
    cache = model.init_cache(B, S, cell.kv_dtype)
    _fill_cache(cache, S - 1, g)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab, (B, 1)),
                             dtype=torch.int64, device=dev)
    restore = _cache_restorer(cache, state_leaves(model, cell.kv_dtype))

    def call():
        restore()
        return model.decode_step(params, tokens, cache, window=window,
                                 n_sinks=n_sinks)
    return Share(model, cuts, B, S, (params, tokens, cache), call)


def run_share(cell: Cell, multi_pod: bool, device="cuda", seed: int = 0
              ) -> Dict[str, Any]:
    """The cell's data-parallel share on ``device``, at full width, after
    the hand kernels are built.  -> the ``one_card`` block of the
    record.  A decode or prefill share raises where its last timed
    call's output is not its warm call's bit for bit; a train step
    advances its state by design and is exempt (``repeat_identical``
    None)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels import build
        for name in build.SOURCES:
            build.load(name)
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (
        lambda: None)
    model, cuts, B, S, args, call = share_inputs(cell, multi_pod, dev, seed)
    cfg = model.cfg
    window, n_sinks = cell.window
    arg_bytes = sum(whole_bytes(a) for a in args)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kept: Dict[str, Any] = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    with _first_attn_call(kept):
        out = call()
    sync()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    # a train step advances its state by design: no repeat to hold
    warm = None if cell.entry == "train" else _outputs(cell.entry, out)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = call()
        sync()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    wall = sorted(walls)[1]
    repeat = None
    if warm is not None:
        repeat = all(a is b or (a is not None and b is not None
                                and torch.equal(a, b))
                     for a, b in zip(warm, _outputs(cell.entry, out)))
        if not repeat:
            raise AssertionError(
                f"{cfg.name} x {cell.shape.name} ({cell.entry}, "
                f"{str(cell.kv_dtype).split('.')[-1]} cache): the last "
                f"timed call's output differs from the warm call's")

    err: Dict[str, Any] = {}
    if cell.entry == "train":
        loss, gnorm = float(out["loss"]), float(out["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train step: loss {loss}, grad norm "
                                 f"{gnorm}")
        err.update(loss=loss, grad_norm=gnorm)
    elif cell.entry == "prefill":
        if not torch.isfinite(out.logits).all() or tuple(
                out.logits.shape) != (B, cfg.vocab):
            raise AssertionError("prefill logits not finite or of the "
                                 "wrong shape")
        if out.density is not None and not torch.isfinite(out.density).all():
            raise AssertionError("prefill density not finite")
    else:
        calls: List[Tuple] = []
        with _plain_kernels(), _decode_calls(calls):
            plain = call().logits
        err["decode_qattn"] = _hold_decode(calls)
        err.update(_compare_logits(out.logits, plain))
    err["attn_density"] = _hold_attn(kept)
    del kept
    flops = model_flops(cfg, cell.entry, B, S, window, n_sinks)
    block = {
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else str(dev)),
        "batch": B, "seq": S, "n_layers": cfg.n_layers, "reduced": cuts,
        "argument_bytes": arg_bytes, "peak_bytes": peak,
        "first_call_s": first_s, "wall_s": wall, "wall_s_all": walls,
        "repeat_identical": repeat,
        "launches": launches,
        "model_flops": flops,
        "model_flops_per_s": None if flops is None else flops / wall,
        "max_err_vs_plain": err,
    }
    print(f"[dryrun] one card ({block['device']}): {cell.entry} B {B} S {S} "
          f"L {cfg.n_layers}{' ' + str(cuts) if cuts else ''}: wall "
          f"{wall:.4f} s (first {first_s:.2f} s, repeat identical "
          f"{repeat}), peak "
          f"{None if peak is None else round(peak / 2**30, 2)} GiB, "
          f"launches {launches}, vs plain {err}")
    return block


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports_torch")
    ap.add_argument("--decode-sharding", default="fsdp",
                    choices=("fsdp", "stationary"))
    ap.add_argument("--train-sharding", default="fsdp",
                    choices=("fsdp", "expert2d"))
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--run", action="store_true",
                    help="also run each cell's data-parallel share once on "
                         "--device")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> List[Dict[str, Any]]:
    """Every asked cell's record; SystemExit(1) if any failed."""
    args = parse_args(argv)
    if args.run:
        resolve_device(args.device)     # no card: raise before any cell
    archs = list(ASSIGNED) if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None \
        else [args.shape]
    results = [run_cell(a, s, args.multi_pod, args.out,
                        args.decode_sharding, args.kv_dtype, args.tag,
                        args.train_sharding, args.run, args.device,
                        args.seed)
               for a in archs for s in shapes]
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skipped" for r in results)
    fail = sum(r["status"] == "fail" for r in results)
    print(f"[dryrun] done: {ok} ok / {skip} skipped / {fail} failed "
          f"of {len(results)}")
    if fail:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
