"""Unified paged KV pool — page tables and free lists over the arenas.

The executor owns the device arenas (one fixed ``(L, P, cs, ...)``
buffer per cache leaf and kind); this module owns everything about
WHICH page holds WHAT: per-context page tables at chunk granularity,
the free lists, the LRU reclaim order, and the occupancy/fault
counters ``LLMService.stats`` surfaces.

Two page kinds mirror the PR-4 mixed cache leaves:

  * ``BF16``  — full-precision pages (``<leaf>16`` arenas).  Working
    tails, freshly prefetched chunks, and dequantized admissions live
    here; decode writes new tokens into the context's bf16 tail page.
  * ``QUANT`` — int8 codes + per-(token, kv-head) scales
    (``<leaf>8``/``<leaf>8s`` arenas).  Full decode-grid chunks admit
    here once and are attended in place through the fused dequant
    select — switch-in never rescatters them.

Page 0 of every arena is the reserved scratch page: page-table entries
for chunks a context does not own point there, padded batch rows use
the all-zero table row, and decode's tail scatter for padded rows
lands there.  Its contents are garbage by design; the attention masks
(``k_pos < seq_len`` and the causal window) give those positions
exactly zero weight, so the garbage is unobservable.

Residency state becomes a page-table property: a chunk is
pool-resident iff its table entry is non-zero, and switching a context
in is a table read (plus first-admission faults), not a scatter.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import FAULTS, with_retries

BF16 = 1
QUANT = 2


class PagePool:
    """Page tables + free lists over the executor's page arenas."""

    def __init__(self, exe, ctxs):
        self.exe = exe
        self.ctxs = ctxs
        self.cs = exe.cs
        self.pages_per_ctx = exe.pages_per_ctx
        self.arenas = exe.init_arenas()
        # page 0 reserved as scratch in both kinds; hand out low pages
        # first so tiny workloads stay in a compact prefix of the arena
        self._free16: List[int] = list(range(exe.pool_pages16 - 1, 0, -1))
        self._free8: List[int] = list(range(exe.pool_pages8 - 1, 0, -1))
        # cid -> {"p16": (C,) int32, "p8": (C,) int32, "kind": (C,) u8}
        self._tables: Dict[int, Dict[str, np.ndarray]] = {}
        # (kind, page) -> (cid, chunk-index), for debugging/invariants
        self._owner: Dict[Tuple[int, int], Tuple[int, int]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self.page_faults = 0        # admissions (DRAM/disk -> pool pages)
        self.pt_switch_ins = 0      # chunk switch-ins = pure table reads
        self.admit_switch_ins = 0   # chunk switch-ins that paid an admit
        self.reclaims = 0           # whole-context reclaim evictions
        self.admit_fault_retries = 0   # injected pool.admit faults retried

    # -- tables -------------------------------------------------------- #
    def table(self, cid: int) -> Dict[str, np.ndarray]:
        t = self._tables.get(cid)
        if t is None:
            C = self.pages_per_ctx
            t = {"p16": np.zeros(C, np.int32),
                 "p8": np.zeros(C, np.int32),
                 "kind": np.zeros(C, np.uint8)}
            self._tables[cid] = t
        self._lru.setdefault(cid, None)
        return t

    def touch(self, cid: int) -> None:
        if cid in self._lru:
            self._lru.move_to_end(cid)

    def kind(self, cid: int, ci: int) -> int:
        t = self._tables.get(cid)
        return int(t["kind"][ci]) if t is not None else 0

    def rows(self, cids: Sequence[int]):
        """Stacked page-table rows for a decode/prefill batch:
        -> (pt16 (B, C) i32, pt8 (B, C) i32 | None, qmask (B, C) bool
        | None).  The quant row/mask are None outside quant-resident
        mode (the jitted entries specialize on their absence)."""
        ts = [self.table(c) for c in cids]
        pt16 = np.stack([t["p16"] for t in ts])
        if not self.exe.quant_resident:
            return pt16, None, None
        pt8 = np.stack([t["p8"] for t in ts])
        qmask = np.stack([t["kind"] == QUANT for t in ts])
        return pt16, pt8, qmask

    # -- allocation ---------------------------------------------------- #
    def _admit_check(self, cid: int, ci: int) -> None:
        """``pool.admit`` failpoint: admission is the pool's only
        externally-driven mutation, so transient faults injected here
        cover the whole alloc path.  Retried on the spot — the check
        runs before any table/free-list mutation, so a retry is safe —
        and only transient kinds are planned for this site, so a
        persistent draw (tests only) still propagates."""
        if not FAULTS.active:
            return
        tries = 0

        def _on_retry(_key, _err):
            nonlocal tries
            tries += 1

        with_retries(lambda: FAULTS.check("pool.admit", (cid, ci)),
                     attempts=3, base_s=0.0, on_retry=_on_retry)
        self.admit_fault_retries += tries

    def _pop(self, free: List[int], kind_name: str, for_cid: int) -> int:
        if not free:
            self._reclaim(for_cid)
        if not free:
            raise RuntimeError(
                f"paged KV pool exhausted ({kind_name}): every page is "
                "held by a busy context — raise pool_pages_16/"
                "pool_pages_8 or lower decode_batch")
        return free.pop()

    def _reclaim(self, for_cid: int) -> None:
        """Free the least-recently-used non-busy context's pages.  Busy
        contexts' pages are authoritative state (their latest tokens may
        exist nowhere else); non-busy contexts always have payloads or
        disk copies, so dropping their pages only costs re-admission.
        ``for_cid`` (the allocating context) is never a victim: during
        its own switch-in/prefill it is not yet marked busy."""
        for cid in list(self._lru):
            if cid == for_cid:
                continue
            ctx = self.ctxs.contexts.get(cid)
            if ctx is not None and ctx.busy:
                continue
            if self._table_empty(cid):
                self._lru.pop(cid, None)
                continue
            self.free_ctx(cid)
            self._lru.pop(cid, None)
            self.reclaims += 1
            return

    def _table_empty(self, cid: int) -> bool:
        t = self._tables.get(cid)
        return t is None or (not t["p16"].any() and not t["p8"].any())

    def alloc16(self, cid: int, ci: int) -> int:
        self._admit_check(cid, ci)
        t = self.table(cid)
        assert t["kind"][ci] == 0, (cid, ci, t["kind"][ci])
        page = self._pop(self._free16, "bf16", cid)
        t["p16"][ci] = page
        t["kind"][ci] = BF16
        self._owner[(BF16, page)] = (cid, ci)
        return page

    def alloc8(self, cid: int, ci: int) -> int:
        self._admit_check(cid, ci)
        t = self.table(cid)
        assert t["kind"][ci] == 0, (cid, ci, t["kind"][ci])
        page = self._pop(self._free8, "quant", cid)
        t["p8"][ci] = page
        t["kind"][ci] = QUANT
        self._owner[(QUANT, page)] = (cid, ci)
        return page

    # -- freeing ------------------------------------------------------- #
    def free_chunk(self, cid: int, ci: int) -> None:
        t = self._tables.get(cid)
        if t is None or t["kind"][ci] == 0:
            return
        if t["p16"][ci]:
            self._free16.append(int(t["p16"][ci]))
            self._owner.pop((BF16, int(t["p16"][ci])), None)
        if t["p8"][ci]:
            self._free8.append(int(t["p8"][ci]))
            self._owner.pop((QUANT, int(t["p8"][ci])), None)
        t["p16"][ci] = 0
        t["p8"][ci] = 0
        t["kind"][ci] = 0

    def free_ctx(self, cid: int) -> None:
        t = self._tables.get(cid)
        if t is None:
            return
        for ci in np.nonzero(t["kind"])[0]:
            self.free_chunk(cid, int(ci))

    def drop(self, cid: int) -> None:
        self.free_ctx(cid)
        self._tables.pop(cid, None)
        self._lru.pop(cid, None)

    # -- telemetry ----------------------------------------------------- #
    def stats(self) -> Dict[str, int]:
        return {
            "pool_pages16_total": self.exe.pool_pages16 - 1,
            "pool_pages16_used": (self.exe.pool_pages16 - 1
                                  - len(self._free16)),
            "pool_pages8_total": self.exe.pool_pages8 - 1,
            "pool_pages8_used": (self.exe.pool_pages8 - 1
                                 - len(self._free8)),
            "pool_page_faults": self.page_faults,
            "pool_pt_switch_ins": self.pt_switch_ins,
            "pool_admit_switch_ins": self.admit_switch_ins,
            "pool_reclaims": self.reclaims,
            "pool_admit_fault_retries": self.admit_fault_retries,
        }
