"""A configuration file as the port's ``ModelConfig``, and its weights.

The weights are the benchmark's inputs: made here from the seed, on the
device, in the port's parameter layout, and handed unchanged to the
program and to the plain reference.  Each leaf is one draw of a
``torch.Generator`` on the device, in the type it is served in: every
matrix N(0, 0.02^2) in bf16, norm scales 1 + N(0, 0.05^2) and biases
N(0, 0.02^2) in fp32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

STD, NORM_STD = 0.02, 0.05


def port_config(conf: Dict):
    """The port's ``ModelConfig`` for a configuration file (its published
    keys; ``conf["port"]`` names the port's architecture and family)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig, MoEConfig

    base = get_config(conf["port"]["arch"])
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    kw = dict(n_layers=conf["num_hidden_layers"], d_model=d, n_heads=H,
              n_kv_heads=conf["num_key_value_heads"],
              vocab=conf["vocab_size"], rope_theta=float(conf["rope_theta"]),
              norm_eps=float(conf["rms_norm_eps"]),
              max_seq=conf["max_position_embeddings"],
              tie_embeddings=bool(conf["tie_word_embeddings"]))
    if conf["port"]["family"] == "dense":
        kw.update(d_ff=conf["intermediate_size"], head_dim=d // H,
                  qkv_bias=bool(conf["port"].get("qkv_bias", False)))
    else:
        kw.update(
            d_ff=conf["moe_intermediate_size"],
            head_dim=conf["v_head_dim"],
            mla=MLAConfig(kv_lora_rank=conf["kv_lora_rank"],
                          q_lora_rank=conf["q_lora_rank"] or 0,
                          qk_nope_head_dim=conf["qk_nope_head_dim"],
                          qk_rope_head_dim=conf["qk_rope_head_dim"],
                          v_head_dim=conf["v_head_dim"]),
            moe=MoEConfig(
                n_experts=conf["n_routed_experts"],
                top_k=conf["num_experts_per_tok"],
                d_expert=conf["moe_intermediate_size"],
                n_shared=conf["n_shared_experts"],
                d_shared=conf["n_shared_experts"]
                * conf["moe_intermediate_size"],
                capacity_factor=base.moe.capacity_factor,
                group_size=base.moe.group_size))
    return base.with_overrides(**kw)


def shapes(cfg) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype, str]]:
    """Leaf path -> (shape, dtype, kind) of the port's parameters, kind
    ``w`` (a matrix), ``n`` (a norm scale) or ``b`` (a bias)."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    bf, f32 = torch.bfloat16, torch.float32
    out = {"embed": ((V, d), bf, "w"), "ln_f": ((d,), f32, "n")}
    if not cfg.tie_embeddings:
        out["head"] = ((d, V), bf, "w")
    lay = {"ln_attn": ((L, d), f32, "n"), "ln_ffn": ((L, d), f32, "n")}
    if cfg.family == "dense":
        H, KV, hd, ff = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
        lay.update(wq=((L, d, H * hd), bf, "w"), wk=((L, d, KV * hd), bf, "w"),
                   wv=((L, d, KV * hd), bf, "w"), wo=((L, H * hd, d), bf, "w"),
                   w_gate=((L, d, ff), bf, "w"), w_up=((L, d, ff), bf, "w"),
                   w_down=((L, ff, d), bf, "w"))
        if cfg.qkv_bias:
            lay.update(bq=((L, H * hd), f32, "b"), bk=((L, KV * hd), f32, "b"),
                       bv=((L, KV * hd), f32, "b"))
    else:
        m, moe, H = cfg.mla, cfg.moe, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        E, de, ds = moe.n_experts, moe.d_expert, moe.d_shared
        lay.update(
            ln_kv=((L, m.kv_lora_rank), f32, "n"),
            wq=((L, d, H * qk), bf, "w"),
            w_dkv=((L, d, m.kv_lora_rank + m.qk_rope_head_dim), bf, "w"),
            w_uk=((L, m.kv_lora_rank, H * m.qk_nope_head_dim), bf, "w"),
            w_uv=((L, m.kv_lora_rank, H * m.v_head_dim), bf, "w"),
            wo=((L, H * m.v_head_dim, d), bf, "w"),
            router=((L, d, E), f32, "w"),
            w_gate=((L, E, d, de), bf, "w"), w_up=((L, E, d, de), bf, "w"),
            w_down=((L, E, de, d), bf, "w"),
            s_gate=((L, d, ds), bf, "w"), s_up=((L, d, ds), bf, "w"),
            s_down=((L, ds, d), bf, "w"))
    out.update({"layers/" + k: v for k, v in lay.items()})
    return out


def make_weights(cfg, seed: int, device) -> Dict:
    """The weights of ``cfg`` from ``seed``, on ``device``, one draw a
    leaf in its served type."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    params: Dict = {"layers": {}}
    for path, (shp, dt, kind) in shapes(cfg).items():
        t = torch.randn(shp, generator=gen, dtype=dt, device=device)
        t.mul_(NORM_STD if kind == "n" else STD)
        if kind == "n":
            t.add_(1.0)
        if path.startswith("layers/"):
            params["layers"][path[7:]] = t
        else:
            params[path] = t
    return params
