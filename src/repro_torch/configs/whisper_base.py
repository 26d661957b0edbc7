"""whisper-base [audio] — enc-dec, conv frontend (stub).

6L d_model=512 8H d_ff=2048 vocab=51865.
[arXiv:2212.04356; unverified]

The backbone only: the conv/mel frontend is a stub, and a batch gives
precomputed frame embeddings ``frames`` (batch, 1500, 512).  n_layers
is the decoder's; the encoder has 6 layers as well.  The decoder's
learned positions cap at 448 (``max_seq``).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    head_dim=64,
    max_seq=448,
    norm_eps=1e-5,
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    source="arXiv:2212.04356; unverified",
)
