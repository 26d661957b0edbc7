"""recurrentgemma-2b [hybrid] — RG-LRU + local attn, 1:2.

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
[arXiv:2402.19427; hf]

Block pattern (rec, rec, attn): 26 layers = 8 full triples + 2 trailing
recurrent layers.  Local attention window = 2048 with a single KV head
(MQA).  The recurrent state is constant-size.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="rglru_hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    rope_theta=10000.0,
    max_seq=524288,
    rglru=RGLRUConfig(
        lru_width=2560,
        conv_width=4,
        window=2048,
        block_pattern=("rec", "rec", "attn"),
    ),
    source="arXiv:2402.19427; hf",
)
