"""Chunked view of a context's KV cache (paper §3.1, Fig. 4).

Mirror of the JAX package's core/chunks.py: ``ChunkCodec`` for the
families with sequence leaves (dense ``k``/``v``, MLA's latent
``ckv``/``kpe``), ``WholeStateCodec`` for constant-size recurrent state
(RWKV6's ``wkv``/``tm``/``cm``: one blob a context).  A chunk
covers ``chunk_tokens`` consecutive tokens ACROSS ALL LAYERS.  The codec
canonicalizes each sequence cache leaf into a (T, F) block — T chunk
tokens, F = flattened (layers x heads x channels) — the layout the chunk
codec kernels (kernels/chunk_quant.py) operate on.  Two grids:

  * storage (``CompressedChunk``): per-channel scales, 8/4/2 bits,
    through the chunk codec kernels;
  * decode (``QuantResidentChunk``): int8 with one scale per (token,
    kv-head; for MLA's latents, per (token, layer) over the whole rank
    vector), the grid quant-resident decode attends in place
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
            raise ValueError("cache has no sequence leaves; constant-size "
                             "state takes WholeStateCodec")

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

    def scatter(self, cache, positions: torch.Tensor,
                blocks: Dict[str, torch.Tensor]):
        """Write (T, F) blocks at arbitrary token ``positions`` (T,), IN
        PLACE; returns ``cache``.  Repeated (pad) positions carry
        identical rows."""
        for name, blk in blocks.items():
            a = cache[name]
            T = blk.shape[0]
            shp = [T] + [s for i, s in enumerate(a.shape) if i != TOKEN_AXIS]
            a[:, :, positions] = blk.reshape(shp).movedim(0, TOKEN_AXIS).to(
                a.dtype)
        return cache

    def scatter_quant(self, cache, positions: torch.Tensor,
                      codes: Dict[str, torch.Tensor],
                      scales: Dict[str, torch.Tensor]):
        """Write decode-grid (T, F) code blocks / (T, Fs) scale blocks
        into the ``<leaf>_q`` / ``<leaf>_scale`` segments of a mixed
        cache at token ``positions`` (T,) and raise ``quant_mask`` there,
        IN PLACE; returns ``cache``.  The slot path's switch-in of the
        quant-resident tier: a copy of the payload's bytes."""
        for name in codes:
            self.scatter(cache, positions, {f"{name}_q": codes[name],
                                            f"{name}_scale": scales[name]})
        cache["quant_mask"][:, :, positions] = True
        return cache

    def extract_mixed(self, cache, lo: int, hi: int
                      ) -> Dict[str, torch.Tensor]:
        """(T, F) blocks of the TRUE cache values of tokens [lo, hi): the
        bf16 window where ``quant_mask`` is clear, the dequantized int8
        segments where it is set.  The only valid re-encode source for a
        mixed cache: its bf16 array is stale at quant-resident
        positions."""
        out = self.extract(cache, lo, hi)
        if "quant_mask" not in cache:
            return out
        qm = cache["quant_mask"]                    # (1, B, S)
        if qm.shape[1] != 1:
            raise ValueError("mixed extract expects a batch-1 slot")
        m = qm[:, :, lo:hi].reshape(-1)[:, None]    # (T, 1)
        for name in self.leaves:
            hd = cache[name].shape[-1]
            cq = cache[f"{name}_q"][:, :, lo:hi].movedim(TOKEN_AXIS, 0)
            sc = cache[f"{name}_scale"][:, :, lo:hi].movedim(TOKEN_AXIS, 0)
            T = cq.shape[0]
            dq = (cq.reshape(T, -1, hd).to(torch.float32)
                  * sc.reshape(T, -1)[..., None]).to(out[name].dtype)
            out[name] = torch.where(m, dq.reshape(T, -1), out[name])
        return out

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


class WholeStateCodec:
    """Whole-state 'chunk' codec for constant-size recurrent caches
    (``KVSpec.state_leaves`` with no ``seq_leaves``: RWKV6's ``wkv`` /
    ``tm`` / ``cm``).  The context degenerates to a single blob: extract
    and insert move the full state whatever token range is asked, so
    the layers above treat the blob as one chunk covering every token.
    No token scatter and no quant segments: those are sequence-cache
    notions."""

    def __init__(self, leaves, chunk_tokens: int = 16):
        self.leaves = tuple(leaves)
        self.cs = chunk_tokens
        if not self.leaves:
            raise ValueError("whole-state codec needs state leaves")

    def extract(self, cache, lo: int = 0, hi: int = 0
                ) -> Dict[str, torch.Tensor]:
        """Every state leaf, whole (the cache's own tensors, not
        copies)."""
        return {name: cache[name] for name in self.leaves}

    def insert(self, cache, lo, blocks: Dict[str, torch.Tensor]):
        """Write whole state leaves back, IN PLACE, cast to each leaf's
        dtype (an fp16 snapshot of a bf16 leaf); returns ``cache``."""
        for name, blk in blocks.items():
            a = cache[name]
            a.copy_(blk.reshape(a.shape).to(device=a.device, dtype=a.dtype))
        return cache

    def scatter(self, cache, positions, blocks):
        raise NotImplementedError("whole-state cache has no token scatter")

    def scatter_quant(self, cache, positions, codes, scales):
        raise NotImplementedError("whole-state cache has no quant segments")


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
