"""Operations and bytes of one codec quantize launch: one chunk (T tokens)
of every cache leaf at ``bits``.  Bytes: each leaf's (T, F) input read
once (2 bytes an element in bf16, 4 in fp32), its packed codes (bits / 8
an element) and its fp32 scales (one a channel) written once.
Operations: about 4 an element (the absolute maximum, the divide, the
round and the clamp); the bytes bound it."""

IN_BYTES = {"__nv_bfloat16": 2, "__half": 2, "float": 4}


def leaf_widths(cfg):
    """F of each cache leaf: the whole layer stack's channels."""
    L = cfg.n_layers
    if cfg.family == "dense":
        f = L * cfg.n_kv_heads * cfg.head_dim
        return [f, f]
    m = cfg.mla
    return [L * m.kv_lora_rank, L * m.qk_rope_head_dim]


def launch_cost(cfg, T: int, bits: int, tin: str):
    b_in = IN_BYTES.get(tin, 2)
    nbytes = sum(T * F * b_in + T * F * bits // 8 + 4 * F
                 for F in leaf_widths(cfg))
    flops = sum(4 * T * F for F in leaf_widths(cfg))
    return float(flops), float(nbytes)
