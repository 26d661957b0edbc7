"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
the plain PyTorch versions (``ref.py``) and the dispatch (``ops.py``).

Each wrapper counts the launches of its kernel; ``launch_counts`` reads
every count and ``reset_launch_counts`` sets them to 0."""
from typing import Dict


def _wrappers():
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import chunk_quant
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import decode_qattn as kdq
    return chunk_quant, kmq, kad, kdq


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its count was last reset (the
    attn_density launches with the density, with the row stats and
    through csrc/attn_flash.cu are counted among its launches and
    apart)."""
    chunk_quant, kmq, kad, kdq = _wrappers()
    return {"quantize": chunk_quant.quantize.launches,
            "dequantize": chunk_quant.dequantize.launches,
            "decode_mqattn": kmq.decode_mqattn.launches,
            "attn_density": kad.attn_density.launches,
            "attn_density_with_density": kad.attn_density.density_launches,
            "attn_density_stats": kad.attn_density.stats_launches,
            "attn_flash": kad.attn_density.flash_launches,
            "attn_flash_with_density":
                kad.attn_density.flash_density_launches,
            "decode_qattn": kdq.decode_qattn.launches}


def reset_launch_counts() -> None:
    for k in _wrappers():
        k.reset_launches()
