"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes wrappers,
the plain PyTorch versions (``ref.py``) and the dispatch (``ops.py``).

Each wrapper counts the launches of its kernel; ``launch_counts`` reads
every count and ``reset_launch_counts`` sets them to 0.  A wrapper
counts in Python, where it launches; a replay of a captured CUDA graph
runs no Python, so the graph keeps what its capture counted and adds it
back with ``add_launch_counts`` at every replay (``core/graphs.py``)."""
from typing import Dict, Mapping


def _wrappers():
    from repro_torch.kernels import attn_density as kad
    from repro_torch.kernels import chunk_quant
    from repro_torch.kernels import decode_mqattn as kmq
    from repro_torch.kernels import decode_qattn as kdq
    from repro_torch.kernels import feed_gate as kfg
    return chunk_quant, kmq, kad, kdq, kfg


def _counters():
    """name -> (the wrapper function that holds the count, its
    attribute)."""
    chunk_quant, kmq, kad, kdq, kfg = _wrappers()
    ad = kad.attn_density
    return {"quantize": (chunk_quant.quantize, "launches"),
            "dequantize": (chunk_quant.dequantize, "launches"),
            "decode_mqattn": (kmq.decode_mqattn, "launches"),
            "attn_density": (ad, "launches"),
            "attn_density_with_density": (ad, "density_launches"),
            "attn_density_stats": (ad, "stats_launches"),
            "attn_flash": (ad, "flash_launches"),
            "attn_flash_with_density": (ad, "flash_density_launches"),
            "decode_qattn": (kdq.decode_qattn, "launches"),
            "feed_gate": (kfg.feed_gate, "launches")}


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its count was last reset (the
    attn_density launches with the density, with the row stats and
    through csrc/attn_flash.cu are counted among its launches and
    apart; ``feed_gate`` is the pipelined restore's gate, no TPU
    kernel's port)."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for k in _wrappers():
        k.reset_launches()


def set_launch_counts(counts: Mapping[str, int]) -> None:
    """Put back counts read by ``launch_counts`` (the launches made in
    between are not counted)."""
    for k, (fn, attr) in _counters().items():
        setattr(fn, attr, counts[k])


def add_launch_counts(delta: Mapping[str, int]) -> None:
    """Add ``delta`` (name -> launches, names of ``launch_counts``) to
    the counts: a graph replay's credit of the launches it ran."""
    counters = _counters()
    for k, n in delta.items():
        fn, attr = counters[k]
        setattr(fn, attr, getattr(fn, attr) + n)
