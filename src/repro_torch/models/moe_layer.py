"""Mixture-of-experts FFN with grouped, capacity-based top-k dispatch.

Mirror of the JAX package's models/moe_layer.py, op for op: tokens go
through the router in groups of ``group_size`` (fp32 router and
softmax), an iterated argmax picks each token's top-k experts, running
``cumsum`` slot positions place it in an expert's ``capacity`` slots
(overflowing tokens are dropped: their combine weight is zero, the
Mesh-TF/GShard discipline), and one-hot dispatch / combine einsums in
x's dtype move the tokens to the experts and back.  The fused shared
expert is a SwiGLU beside it.  SiLU rounds each of its ops to bf16, as
``jax.nn.silu`` does (``common.silu``).

Capacity C = max(4, min(ceil(group_size * top_k * capacity_factor /
n_experts), group_size)).  The Switch-Transformer auxiliary loss
(E * mean_e(frac_tokens_e * mean_prob_e)) is returned as a metric.

The reference computes every product here with ``jnp.einsum`` outside
any Pallas kernel, so they stay ``torch.einsum`` on both devices.
Dispatch and combine are built from one-hots by products and sums, with
no index written in place, so ``loss`` differentiates through the gate
weights as the reference does; the aux loss is a metric that ``loss``
drops, as the reference's does.  The
dispatch is dense over experts: every expert's weights are read on
every call, whatever the router picks.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import common as C


def capacity(gs: int, moe: MoEConfig) -> int:
    c = math.ceil(gs * moe.top_k * moe.capacity_factor / moe.n_experts)
    return max(4, min(c, gs))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over n classes; an index outside [0, n)
    gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(
        torch.float32)


def moe_dispatch(gates: torch.Tensor, top_k: int, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates (G, gs, E) router probabilities.  -> (dispatch (G, gs, E,
    C) 0/1, combine (G, gs, E, C) gate weights, aux loss), all fp32."""
    G, gs, E = gates.shape
    dev = gates.device
    remaining = gates
    # per-expert running token count across the k iterations
    count_so_far = torch.zeros((G, 1, E), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((G, gs, E, cap), dtype=torch.float32, device=dev)
    combine = torch.zeros_like(dispatch)
    frac_routed = torch.zeros((G, E), dtype=torch.float32, device=dev)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # (G, gs)
        onehot = _one_hot(idx, E)                                # (G, gs, E)
        gate_k = torch.sum(remaining * onehot, dim=-1)           # (G, gs)
        remaining = remaining * (1.0 - onehot)
        pos = torch.cumsum(onehot, dim=1) - onehot + count_so_far
        count_so_far = count_so_far + torch.sum(onehot, dim=1, keepdim=True)
        pos_in_e = torch.sum(pos * onehot, dim=-1)               # (G, gs)
        keep = (pos_in_e < cap).to(torch.float32)
        slot = _one_hot(pos_in_e.to(torch.int32), cap)           # (G, gs, C)
        d_k = onehot[..., None] * slot[..., None, :] * keep[..., None, None]
        dispatch = dispatch + d_k
        combine = combine + d_k * gate_k[..., None, None]
        frac_routed = frac_routed + torch.mean(onehot, dim=1)
    # Switch aux loss: E * sum_e frac_e * mean-prob_e (averaged over groups)
    mean_prob = torch.mean(gates, dim=1)                          # (G, E)
    aux = E * torch.mean(torch.sum((frac_routed / top_k) * mean_prob, dim=-1))
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, p: Dict[str, torch.Tensor], moe: MoEConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (..., d).  p: router (d, E) fp32, w_gate / w_up (E, d, fe),
    w_down (E, fe, d), optional s_gate / s_up (d, ds), s_down (ds, d)
    fused shared expert.  -> (out (..., d), {"moe_aux": aux})."""
    orig_shape = x.shape
    d = orig_shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    gs = min(moe.group_size, T)
    G = (T + gs - 1) // gs
    pad = G * gs - T
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(G, gs, d)

    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)
    gates = torch.softmax(logits, dim=-1)                        # (G, gs, E)
    cap = capacity(gs, moe)
    dispatch, combine, aux = moe_dispatch(gates, moe.top_k, cap)

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    h = C.silu(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    out_e = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), out_e)
    y = y.reshape(G * gs, d)
    if pad:
        y = y[:T]
    y = y.reshape(orig_shape)
    if "s_gate" in p:
        y = y + C.swiglu(x, p["s_gate"], p["s_up"], p["s_down"])
    return y, {"moe_aux": aux}


MOE_KEYS = ("router", "w_gate", "w_up", "w_down", "s_gate", "s_up",
            "s_down")


def moe_residual(pl: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg) -> torch.Tensor:
    """A layer's FFN sub-layer in the MoE families (``MoEModel._ffn``,
    ``MLAModel._ffn``): x + moe_ffn(rms_norm(x, ln_ffn)) over the layer
    params' MoE leaves."""
    h = C.rms_norm(x, pl["ln_ffn"], cfg.norm_eps)
    y, _ = moe_ffn(h, {k: pl[k] for k in MOE_KEYS if k in pl}, cfg.moe)
    return x + y


def init_moe_params(generator: torch.Generator, d: int, moe: MoEConfig,
                    device, n_layers: int = 1, dtype=torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """Stacked (L, ...) MoE FFN params drawn from ``generator`` (on
    ``device``), N(0, 0.02^2) as the reference's ``init_moe_params``,
    one layer at a time and the expert leaves one expert at a time: the
    largest fp32 temporary is one expert's (d, fe) or one layer's
    shared-expert leaf (0.17 GB at llama4-maverick's width, where one
    layer's ``w_gate`` alone would be 21.5 GB in fp32).  The router is
    drawn in ``dtype`` and kept in fp32."""
    E, fe, L = moe.n_experts, moe.d_expert, n_layers
    shapes = {"router": (d, E), "w_gate": (E, d, fe), "w_up": (E, d, fe),
              "w_down": (E, fe, d)}
    if moe.d_shared:
        shapes.update(s_gate=(d, moe.d_shared), s_up=(d, moe.d_shared),
                      s_down=(moe.d_shared, d))
    p = {}
    for name, shp in shapes.items():
        w = torch.empty((L, *shp), dtype=dtype, device=device)
        for l in range(0 if w.is_meta else L):  # meta: nothing to draw
            if name.startswith("w_"):
                for e in range(E):
                    w[l, e] = C.init_linear(generator, shp[1:], device,
                                            dtype=dtype)
            else:
                w[l] = C.init_linear(generator, shp, device, dtype=dtype)
        p[name] = w.to(torch.float32) if name == "router" else w
    return p
