"""opt-6.7b — the paper's second evaluation model (paper §4).

32L d_model=4096 32H (MHA) d_ff=16384 vocab=50272, 2k context window.
OPT uses learned positional embeddings and ReLU FFN; we model it in the
same llama-style backbone with its own dims (noted in DESIGN.md).
[arXiv:2205.01068]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-6.7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=16384,
    vocab=50272,
    head_dim=128,
    rope_theta=10000.0,
    max_seq=2048,
    source="arXiv:2205.01068 (paper's own model)",
)
