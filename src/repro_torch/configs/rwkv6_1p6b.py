"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free.

24L d_model=2048 d_ff=7168 vocab=65536.
[arXiv:2404.05892; unverified]

State per layer: (heads, head_dim, head_dim) wkv matrix + token-shift
buffers; total context state is constant in sequence length, so all
decode shapes (including long_500k) run natively.
"""
from repro_torch.configs.base import ModelConfig, RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv6",
    n_layers=24,
    d_model=2048,
    n_heads=32,          # 2048 / 64 head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    head_dim=64,
    max_seq=524288,
    rwkv=RWKV6Config(head_dim=64, decay_lora=64, mix_lora=32, chunk_len=16),
    source="arXiv:2404.05892; unverified",
)
