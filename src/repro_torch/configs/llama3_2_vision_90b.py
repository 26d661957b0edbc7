"""llama-3.2-vision-90b [vlm] — cross-attn image layers.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB: the caller provides precomputed patch
embeddings (batch, 1601, 7680); the model owns only the projector and
the cross-attention layers.  100 layers = 20 blocks of (4 self-attn
layers + 1 cross-attn layer), i.e. cross-attention every 5th layer.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    max_seq=131072,
    vision=VisionConfig(n_image_tokens=1601, d_vision=7680,
                        cross_attn_every=5),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
