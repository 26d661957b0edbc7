"""Model FLOPs a token: 2 a weight of every product it passes through
(the LM head included, the embedding lookup not), and for attention 2 a
dimension for each key it attends in QK and as many in PV.  Dense GQA,
and MLA with MoE (absorbed decode counted as the published form: the
per-head keys and values of the latent, the routed experts it is sent to
and the shared ones)."""
from typing import Iterable


def per_token_weights(cfg) -> int:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    if cfg.family == "dense":
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        lay = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * cfg.d_ff
    else:
        m, moe, H = cfg.mla, cfg.moe, cfg.n_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        lay = (d * H * qk + d * (m.kv_lora_rank + m.qk_rope_head_dim)
               + m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
               + H * m.v_head_dim * d + d * moe.n_experts
               + 3 * d * (moe.top_k * moe.d_expert + moe.d_shared))
    return L * lay + d * V


def attn_dims(cfg) -> int:
    """Per key: the QK and PV width summed over heads and layers."""
    if cfg.family == "dense":
        return cfg.n_layers * cfg.n_heads * 2 * cfg.head_dim
    m = cfg.mla
    return cfg.n_layers * cfg.n_heads * (m.qk_nope_head_dim
                                         + m.qk_rope_head_dim + m.v_head_dim)


def tokens(cfg, positions: Iterable[int]) -> float:
    """FLOPs of tokens at ``positions`` (each attends position + 1 keys)."""
    pos = list(positions)
    return float(2 * per_token_weights(cfg) * len(pos)
                 + 2 * attn_dims(cfg) * sum(p + 1 for p in pos))
