"""From-scratch optimizers: AdamW and 8-bit block-quantized AdamW.

Mirror of the JAX package's ``train/optimizer.py`` over nested dicts of
tensors.  The 8-bit variant stores both moments as int8 codes with
per-row fp32 scales (symmetric, max-abs over the last dim; the second
moment in the sqrt domain) — the same codec family as the paper's KV
chunks, applied to optimizer state.

The reference runs ``apply_updates`` under ``jax.jit``, and the port
computes what the jitted reference computes on the CPU, op for op:

* XLA rewrites a division by a constant into a product with the
  constant's fp32 reciprocal: ``max|x| * fl32(1/127)`` for the scales,
  ``step * fl32(1/warmup)`` for the schedule;
* its CPU backend contracts a product into the sum that takes it (one
  rounding: ``_fma``) — the moments' ``b1 * m + (1 - b1) * g`` and the
  parameter step — and writes ``(m / bc1) / (sqrt(v / bc2) + eps)`` as
  ``m / (bc1 (sqrt(v / bc2) + eps))``;
* its square root is correctly rounded (``_sqrt``);
* ``jnp.round`` and ``torch.round`` both round half to even.

So for the same gradients the moments — the 8-bit codes and scales
byte for byte — equal the jitted reference's, as long as the gradient
norm stays under ``clip_norm`` (``tests/test_torch_train.py``).  Two
things can move a last bit: the norm (a sum over every gradient, in
another order than XLA's), which reaches everything through the clip
factor once it clips; and ``1 - beta ** step`` (``torch.pow`` against
XLA's ``pow``), which reaches only the parameters, as does XLA's CPU
code for rows of some widths, which rounds the parameter step
otherwise (seen at a last dim of 24, not of 40; within 1e-4 of lr).

Both variants are pure functions: they return new tensors and leave the
state they are given as it was.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

Tree = Any


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    quantized: bool = False          # 8-bit moments


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in the order of the dicts' keys (insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def _fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in fp32 with one rounding, as XLA's CPU backend
    contracts the moment updates ``b1 * m + (1 - b1) * g`` (an fma of the
    first product into the sum; the second product is rounded first).
    The product of two fp32 values is exact in fp64, so the fp64 sum
    rounds once before the cast (a second rounding could only move a
    result that lands on an fp32 midpoint)."""
    f64 = torch.float64
    a = a.to(f64) if torch.is_tensor(a) else float(np.float32(a))
    return (a * b.to(f64) + c.to(f64)).to(torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root, as XLA computes it: the
    fp64 root of an fp32 value rounds to the right fp32 value, where
    ``torch.sqrt`` of fp32 on the CPU misses it by an ulp in about one
    value in 160."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _recip(c: float) -> float:
    """fl32(1 / c): the factor XLA puts in place of a division by c."""
    return float(np.float32(1) / np.float32(c))


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8, scale fp32 per row) symmetric over the last dim."""
    s = torch.clamp_min(x.abs().amax(dim=-1) * _recip(127.0), 1e-12)
    codes = torch.clamp(torch.round(x / s[..., None]), -127, 127)
    return codes.to(torch.int8), s.to(torch.float32)


def _dq8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale[..., None]


def _q8v(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-moment codec: quantize sqrt(v), not v.  v's intra-row
    dynamic range is squared, so linear int8 rounds small entries to 0
    and m/(sqrt(v)+eps) explodes; in the sqrt domain an entry survives
    down to (max/254)^2 of the row max instead of max/254."""
    r = _sqrt(torch.clamp_min(x, 0.0))
    s = torch.clamp_min(r.amax(dim=-1) * _recip(127.0), 1e-12)
    codes = torch.clamp(torch.round(r / s[..., None]), 0, 127)
    return codes.to(torch.int8), s.to(torch.float32)


def _dq8v(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    r = codes.to(torch.float32) * scale[..., None]
    return r * r


def init_state(params: Tree, cfg: OptConfig) -> Dict[str, Tree]:
    """Zero moments (fp32, or int8 codes with fp32 row scales) beside
    ``params``, on each parameter's device, and step 0."""
    def zeros(dtype, drop_last=False):
        return lambda p: torch.zeros(p.shape[:-1] if drop_last else p.shape,
                                     dtype=dtype, device=p.device)

    dev = tree_leaves(params)[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if not cfg.quantized:
        return {"params": params,
                "mu": tree_map(zeros(torch.float32), params),
                "nu": tree_map(zeros(torch.float32), params),
                "step": step}
    return {"params": params,
            "mu": tree_map(zeros(torch.int8), params),
            "mu_scale": tree_map(zeros(torch.float32, True), params),
            "nu": tree_map(zeros(torch.int8), params),
            "nu_scale": tree_map(zeros(torch.float32, True), params),
            "step": step}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in key order) of each leaf's sum of
    squares in fp32."""
    sq = sum(torch.sum(torch.square(x.to(torch.float32)))
             for x in tree_leaves(tree))
    return _sqrt(sq)


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max(step.to(torch.float32)
                           * _recip(max(cfg.warmup_steps, 1)), 1.0)
    return cfg.lr * warm


def apply_updates(state: Dict[str, Tree], grads: Tree, cfg: OptConfig
                  ) -> Tuple[Dict[str, Tree], Dict[str, torch.Tensor]]:
    """One AdamW step (grad clip + warmup schedule built in).
    -> (new state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), step_f)

    def new_param(p, m, v):
        if cfg.quantized:       # a dequantized v may not be >= 0
            v = torch.clamp_min(v, 0.0)
        # XLA's form: m / (bc1 (sqrt(v / bc2) + eps)), the decay and the
        # step contracted into fmas
        p32 = p.to(torch.float32)
        u = _fma(cfg.weight_decay, p32,
                 m / (bc1 * (_sqrt(v / bc2) + cfg.eps)))
        return _fma(-lr, u, p32).to(p.dtype)

    if not cfg.quantized:
        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m = _fma(b1, m, (1 - b1) * g)
            v = _fma(b2, v, (1 - b2) * g * g)
            return new_param(p, m, v), m, v

        out = tree_map(upd, state["params"], grads, state["mu"], state["nu"])
        names = ("params", "mu", "nu")
    else:
        def upd(p, g, mq, ms, vq, vs):
            g = g.to(torch.float32) * scale
            m = _fma(b1, _dq8(mq, ms), (1 - b1) * g)
            v = _fma(b2, _dq8v(vq, vs), (1 - b2) * g * g)
            return (new_param(p, m, v), *_q8(m), *_q8v(v))

        out = tree_map(upd, state["params"], grads, state["mu"],
                       state["mu_scale"], state["nu"], state["nu_scale"])
        names = ("params", "mu", "mu_scale", "nu", "nu_scale")
    new = {n: _pick(out, i) for i, n in enumerate(names)}
    new["step"] = step
    return new, {"grad_norm": gnorm, "lr": lr}


def _pick(tree: Tree, i: int) -> Tree:
    """Entry ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
