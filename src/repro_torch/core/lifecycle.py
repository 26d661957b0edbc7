"""Chunk lifecycle management (paper §3.4).

LCTRU queue — "Least Compression-Tolerable and Recently-Used" — is a
concatenation of per-compression-level sub-queues, heaviest (least
compressed) level first, each ordered by last access (LRU at the front).
Eviction pops from the heavy end: heavy chunks free the most memory per
eviction AND are the best swapping-recompute pipeline candidates
(Eq. 4: pipeline delay falls with the number of missing chunks at a
given byte size).

AoT swap-out and the working-set lock live in the service; this module
owns only the eviction order plus the Claim/Reclaim bookkeeping.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Set, Tuple

from repro_torch.analysis.markers import requires_serialized

Key = Tuple[int, int]              # (ctx_id, chunk_idx)

# heaviest first: uncompressed, then 8-bit, 4-bit, 2-bit
LEVEL_ORDER = (16, 8, 4, 2)


class LCTRUQueue:
    def __init__(self, lru_only: bool = False):
        """lru_only=True degrades to a flat LRU (the VLLM-S/SQ baselines)."""
        self.lru_only = lru_only
        self.queues: Dict[int, OrderedDict] = {
            lvl: OrderedDict() for lvl in LEVEL_ORDER}
        self.flat: OrderedDict = OrderedDict()
        self.level_of: Dict[Key, int] = {}

    def touch(self, key: Key, level: int):
        """Record an access (moves to the recently-used end)."""
        old = self.level_of.get(key)
        if old is not None:
            self.queues[old].pop(key, None)
            self.flat.pop(key, None)
        self.level_of[key] = level
        self.queues[level][key] = None
        self.flat[key] = None

    def remove(self, key: Key):
        lvl = self.level_of.pop(key, None)
        if lvl is not None:
            self.queues[lvl].pop(key, None)
            self.flat.pop(key, None)

    def pop(self, skip: Optional[Callable[[Key], bool]] = None
            ) -> Optional[Key]:
        """Pop the next eviction victim; ``skip`` protects locked keys."""
        if self.lru_only:
            for key in self.flat:
                if skip is None or not skip(key):
                    self.remove(key)
                    return key
            return None
        for lvl in LEVEL_ORDER:
            for key in self.queues[lvl]:
                if skip is None or not skip(key):
                    self.remove(key)
                    return key
        return None

    def __len__(self):
        return len(self.level_of)


class MemoryManager:
    """Byte-budget accounting over in-memory (compressed) chunks."""

    def __init__(self, budget: int, queue: LCTRUQueue):
        self.budget = budget
        self.used = 0
        self.queue = queue
        self._sizes: Dict[Key, int] = {}

    @requires_serialized
    def register(self, key: Key, nbytes: int, level: int):
        if key in self._sizes:
            self.used -= self._sizes[key]
        self._sizes[key] = nbytes
        self.used += nbytes
        self.queue.touch(key, level)

    @requires_serialized
    def unregister(self, key: Key):
        n = self._sizes.pop(key, None)
        if n is not None:
            self.used -= n
        self.queue.remove(key)

    def over_budget(self, extra: int = 0) -> bool:
        return self.used + extra > self.budget

    @requires_serialized
    def reclaim(self, need: int, evict: Callable[[Key], None],
                locked: Set[int]) -> int:
        """Evict until ``need`` extra bytes fit.  ``evict`` drops the chunk
        (clean chunks are free to drop thanks to AoT swap-out).  Returns
        bytes freed."""
        freed = 0
        while self.used + need > self.budget:
            key = self.queue.pop(skip=lambda k: k[0] in locked)
            if key is None:
                break                               # nothing evictable
            n = self._sizes.get(key, 0)
            evict(key)
            self.unregister(key)
            freed += n
        return freed
