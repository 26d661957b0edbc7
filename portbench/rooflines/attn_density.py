"""Operations and bytes of the served ``attn_density`` kernel, one launch
(one layer) of an extend: a prompt of M tokens appended at n0, padded to
the token bucket Mb (the pads are queries over every visible key, and
part of the density the service defines).

Operations: for every visible (query, key) pair and head, QK, PV and the
density's second QK: 2 (2 Dqk + Dv).  Bytes, each read or written once:
Q and the output (Mb rows), K and V up to the sequence's end, the
density (fp32 a key); bf16 elsewhere."""


def dims(cfg):
    if cfg.family == "dense":
        return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim
    m = cfg.mla
    return (cfg.n_heads, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
            m.v_head_dim)


def extend_cost(cfg, n0: int, M: int, Mb: int):
    H, KV, dqk, dv = dims(cfg)
    seq = n0 + M
    pairs = sum(n0 + j + 1 for j in range(M)) + (Mb - M) * seq
    flops = 2 * (2 * dqk + dv) * H * pairs
    nbytes = 2 * (Mb * H * dqk + seq * KV * (dqk + dv) + Mb * H * dv) \
        + 4 * seq
    return float(flops), float(nbytes)
