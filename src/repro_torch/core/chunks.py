"""Chunked view of a context's KV cache (paper §3.1, Fig. 4).

Mirror of the JAX package's core/chunks.py for the storage codec.  A
chunk covers ``chunk_tokens`` consecutive tokens ACROSS ALL LAYERS.
The codec canonicalizes each sequence cache leaf into a (T, F) block —
T chunk tokens, F = flattened (layers x heads x channels) — the layout
the chunk codec kernels (kernels/chunk_quant.py) operate on.

Payloads stay numpy on the host, as in the reference: a
``CompressedChunk`` written by either package is byte-identical, and
the chunk-file format (core/restore.py) reads both.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops

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
    scales (T, F//hd) fp32).  The port does not produce these yet (the
    quant-resident tier is not ported, ROADMAP.md); the record exists so
    the shared chunk-file format reads such files."""
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

    def __init__(self, leaves, chunk_tokens: int = 16, device="cpu"):
        self.leaves = tuple(leaves)
        self.cs = chunk_tokens
        self.device = torch.device(device)
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
        """(T, F) blocks -> host payload through the chunk codec kernel
        (one launch per leaf on the card)."""
        data = {}
        for name, blk in blocks.items():
            packed, scale = kops.chunk_quantize(blk, bits)
            data[name] = (packed.cpu().numpy(), scale.cpu().numpy())
        return CompressedChunk(bits=bits,
                               n_tokens=int(next(iter(blocks.values()))
                                            .shape[0]),
                               data=data, shapes=block_shapes(blocks))

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
    quant: bool = False            # decode-grid payload (not ported)


def chunk_ranges(n_tokens: int, cs: int) -> List[Tuple[int, int]]:
    return [(i, min(i + cs, n_tokens)) for i in range(0, n_tokens, cs)]
