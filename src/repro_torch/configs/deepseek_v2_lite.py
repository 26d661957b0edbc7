"""deepseek-v2-lite-16b [mla_moe] — MLA kv_lora=512, shared+routed MoE.

27L d_model=2048 16H d_ff=1408 vocab=102400, MoE 64e top-6.
[arXiv:2405.04434; hf]

64 routed experts top-6 with 2 shared experts (the HF checkpoint's
66-expert layout); d_ff=1408 is the routed expert hidden size.  MLA
caches the compressed KV latent (kv_lora_rank + qk_rope_head_dim = 576
dims a token and layer) instead of full K/V.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="mla_moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,   # MLA: per-head K/V reconstructed from shared latent
    d_ff=1408,
    vocab=102400,
    head_dim=128,
    rope_theta=10000.0,
    max_seq=163840,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        d_shared=2816,   # 2 shared experts fused: 2 * 1408
        capacity_factor=1.4,
        group_size=512,
    ),
    source="arXiv:2405.04434; hf",
)
