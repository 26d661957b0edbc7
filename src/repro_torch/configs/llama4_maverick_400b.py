"""llama4-maverick-400b-a17b [moe] — MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Llama-4 interleaves dense and MoE FFN layers; every layer is modelled
as MoE here (top-1 routed + one always-on shared expert of d_ff), which
matches the spec's "MoE 128e top-1" and keeps the layer stack
homogeneous.  One layer's experts are 3 x 128 x 5120 x 8192 bf16 =
32.2 GB, so one 80 GB card holds two layers at full width.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    rope_theta=500000.0,
    max_seq=524288,
    moe=MoEConfig(
        n_experts=128,
        top_k=1,
        d_expert=8192,
        n_shared=1,
        d_shared=8192,
        capacity_factor=1.25,
        group_size=1024,
    ),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
