"""qwen2.5-14b [dense] — GQA, QKV bias.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    max_seq=32768,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)
