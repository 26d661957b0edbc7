"""llama2-7b — the paper's primary evaluation model (paper §4).

32L d_model=4096 32H (MHA) d_ff=11008 vocab=32000, 4k context window.
[arXiv:2307.09288]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=32000,
    head_dim=128,
    rope_theta=10000.0,
    max_seq=4096,
    source="arXiv:2307.09288 (paper's own model)",
)
