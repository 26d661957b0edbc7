"""Chunked view of a context's KV cache (paper §3.1, Fig. 4).

Mirror of the JAX package's core/chunks.py for the paged path.  A chunk
covers ``chunk_tokens`` consecutive tokens ACROSS ALL LAYERS.  The codec
canonicalizes each sequence cache leaf into a (T, F) block — T chunk
tokens, F = flattened (layers x heads x channels) — the layout the chunk
codec kernels (kernels/chunk_quant.py) operate on.  Two grids:

  * storage (``CompressedChunk``): per-channel scales, 8/4/2 bits,
    through the chunk codec kernels;
  * decode (``QuantResidentChunk``): int8 with one scale per (token,
    kv-head), the grid quant-resident decode attends in place
    (``kernels/ref.py::quantize_token_head_ref``, plain PyTorch on the
    device: the reference computes it in jnp, with no Pallas kernel).

Payloads stay numpy on the host, as in the reference: a payload written
by either package is byte-identical, and the chunk-file format
(core/restore.py) reads both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.api import resolve_device

TOKEN_AXIS = 2                     # (L, B, S, ...) for every seq leaf


@dataclass
class CompressedChunk:
    """One chunk's compressed payload: leaf -> (packed int8, scales)."""
    bits: int
    n_tokens: int
    data: Dict[str, Tuple[np.ndarray, np.ndarray]]
    shapes: Dict[str, Tuple[int, ...]]          # original leaf slice shapes

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes + s.nbytes for p, s in self.data.values())


@dataclass
class QuantResidentChunk:
    """One chunk's DECODE-GRID payload: leaf -> (codes (T, F) int8,
    scales (T, F//hd) fp32), quantized per (token, kv-head) over the
    trailing head_dim — the grid mixed-cache decode attends in place, so
    admission is a copy of these bytes into a QUANT page.  The per-leaf
    head_dim is codes.F // scales.Fs."""
    n_tokens: int
    data: Dict[str, Tuple[np.ndarray, np.ndarray]]
    shapes: Dict[str, Tuple[int, ...]]          # (T, F) block shapes
    bits: int = 8                               # decode grid is int8

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes + s.nbytes for p, s in self.data.values())


def block_shapes(blocks: Dict[str, torch.Tensor]) -> Dict[str, Tuple[int, ...]]:
    """Leaf -> (T, F) shape as plain int tuples, equal shapes sharing ONE
    tuple object as they do in the JAX package, so the pickled chunk-file
    header (which memoizes shared objects) is byte-identical too."""
    seen: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
    out = {}
    for name, blk in blocks.items():
        shp = tuple(int(s) for s in blk.shape)
        out[name] = seen.setdefault(shp, shp)
    return out


class ChunkCodec:
    """Extract / insert / (de)quantize chunks of a cache dict."""

    def __init__(self, leaves, chunk_tokens: int = 16, device="cuda"):
        self.leaves = tuple(leaves)
        self.cs = chunk_tokens
        self.device = resolve_device(device)
        if not self.leaves:
            raise ValueError("cache has no sequence leaves; the whole-state "
                             "codec is not ported (ROADMAP.md)")

    # -- canonical (T, F) view ------------------------------------------ #
    def extract(self, cache, lo: int, hi: int) -> Dict[str, torch.Tensor]:
        """Tokens [lo, hi) of each seq leaf -> (T, F) tensors (copies)."""
        out = {}
        for name in self.leaves:
            t = cache[name][:, :, lo:hi].movedim(TOKEN_AXIS, 0)  # (T, L, B..)
            out[name] = t.reshape(t.shape[0], -1)
        return out

    def insert(self, cache, lo: int, blocks: Dict[str, torch.Tensor]):
        """Write (T, F) blocks back at token offset lo, IN PLACE (the JAX
        version returns a new cache); returns ``cache``."""
        for name, blk in blocks.items():
            a = cache[name]
            T = blk.shape[0]
            shp = [T] + [s for i, s in enumerate(a.shape) if i != TOKEN_AXIS]
            t = blk.reshape(shp).movedim(0, TOKEN_AXIS)
            a[:, :, lo:lo + T] = t.to(a.dtype)
        return cache

    # -- compression ------------------------------------------------------ #
    def compress_blocks(self, blocks: Dict[str, torch.Tensor],
                        bits: int) -> CompressedChunk:
        """(T, F) blocks -> host payload through the chunk codec kernel:
        one launch for the chunk's leaves on the card, and one copy of
        their codes and scales to the host."""
        buf, outs = kops.chunk_quantize_leaves(list(blocks.values()), bits)
        host = buf.cpu().numpy()
        base = buf.data_ptr()

        def on_host(t: torch.Tensor, dtype) -> np.ndarray:
            lo = t.data_ptr() - base
            return host[lo:lo + t.numel() * t.element_size()].view(
                dtype).reshape(tuple(t.shape))

        data = {name: (on_host(p, np.int8), on_host(s, np.float32))
                for name, (p, s) in zip(blocks, outs)}
        return CompressedChunk(bits=bits,
                               n_tokens=int(next(iter(blocks.values()))
                                            .shape[0]),
                               data=data, shapes=block_shapes(blocks))

    # -- decode-grid (quant-resident) payloads -------------------------- #
    def quantize_resident_blocks(self, blocks: Dict[str, torch.Tensor],
                                 head_dims: Dict[str, int]
                                 ) -> QuantResidentChunk:
        """(T, F) float blocks -> decode-grid payload (also the re-grid of
        a dequantized 4/2-bit storage chunk)."""
        data = {}
        for name, blk in blocks.items():
            T, F = blk.shape
            codes, scale = kref.quantize_token_head_ref(
                blk.reshape(T, F // head_dims[name], head_dims[name]))
            data[name] = (codes.reshape(T, F).cpu().numpy(),
                          scale.cpu().numpy())
        return QuantResidentChunk(
            n_tokens=int(next(iter(blocks.values())).shape[0]), data=data,
            shapes=block_shapes(blocks))

    def dequantize_resident(self, qc: QuantResidentChunk,
                            dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        """Decode-grid payload -> (T, F) blocks on the codec's device (the
        values mixed-cache decode attends at its quant positions)."""
        out = {}
        for name, (codes, scale) in qc.data.items():
            T, F = codes.shape
            hd = F // scale.shape[1]
            out[name] = kref.dequantize_token_head_ref(
                torch.from_numpy(codes).to(self.device).reshape(T, -1, hd),
                torch.from_numpy(scale).to(self.device), dtype
            ).reshape(T, F)
        return out

    def decompress(self, cc: CompressedChunk) -> Dict[str, torch.Tensor]:
        """Host payload -> (T, F) bf16 blocks on the codec's device."""
        out = {}
        for name, (packed, scale) in cc.data.items():
            out[name] = kops.chunk_dequantize(
                torch.from_numpy(packed).to(self.device),
                torch.from_numpy(scale).to(self.device),
                cc.bits, cc.n_tokens)
        return out

    def raw_chunk_bytes(self, cc_or_shapes, bytes_per_elem: int = 2) -> int:
        """Uncompressed (bf16) footprint of a chunk with these shapes."""
        shapes = cc_or_shapes.shapes if isinstance(cc_or_shapes,
                                                   CompressedChunk) \
            else cc_or_shapes
        return sum(int(np.prod(s)) * bytes_per_elem for s in shapes.values())


@dataclass
class ChunkMeta:
    """Lifecycle record for one chunk (paper §3.4)."""
    idx: int
    bits: int = 16                 # 16 = uncompressed (raw bf16)
    density: float = float("inf")  # unmeasured => treated as most dense
    last_access: float = 0.0
    in_memory: bool = True
    on_disk: bool = False
    dirty: bool = True             # differs from the on-disk copy
    nbytes: int = 0
    n_covered: int = 0             # context tokens the payload encodes: a
                                   # partial chunk that grew must re-encode
                                   # even if clean (KV is append-only)
    quant: bool = False            # payload is a decode-grid
                                   # QuantResidentChunk


def chunk_ranges(n_tokens: int, cs: int) -> List[Tuple[int, int]]:
    return [(i, min(i + cs, n_tokens)) for i in range(0, n_tokens, cs)]
