"""Paged KV-pool gather/scatter primitives (plain tensor indexing).

The unified KV pool (core/pagepool.py) stores chunk-granular pages in
fixed arenas shaped ``(L, P, cs, ...)`` — one page = one chunk's worth
of a cache leaf across all layers.  ``gather_pages`` turns a per-slot
page-index row into the dense ``(L, B, S, ...)`` layout the decode and
extend entries consume.  The JAX package has no Pallas kernel for
these either.

Unlike the JAX package, the scatter writes into the arena IN PLACE
(and returns it): the arena is the pool's one buffer per leaf, and a
functional copy of a multi-GiB arena per token would dominate decode.
Chunk admission and read-back (layout conversion included) live in
``core/executor.py``.
"""
from __future__ import annotations

import torch


def gather_pages(arena: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """arena (L, P, cs, ...); tables (B, C) page indices (page 0 is the
    scratch page) -> (L, B, C*cs, ...), a new tensor."""
    g = arena[:, tables]                       # (L, B, C, cs, ...)
    L, B, C, cs = g.shape[:4]
    return g.reshape(L, B, C * cs, *g.shape[4:])


def scatter_token(arena: torch.Tensor, pages: torch.Tensor,
                  offs: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """arena[:, pages[i], offs[i]] = val[:, i], in place.  val (L, N, ...).
    Distinct rows own distinct pages; padded rows all land on the
    scratch page 0, whose contents are never attended (a repeated pad
    position writes identical values)."""
    arena[:, pages, offs] = val.to(arena.dtype)
    return arena
