"""Runtime lock-order witness (the analyzer's dynamic complement).

The static lock checker (``repro_torch.analysis.lockcheck``) reasons about
what the source *says*; this module watches what a run actually
*does*: every lock the core tier creates goes through
``witness_lock`` / ``witness_rlock`` / ``witness_condition``, which
return plain ``threading`` primitives unless ``LLMS_LOCK_WITNESS=1``
is set — zero overhead in production.

With the witness on, each named lock is wrapped in ``OrderedLock``:
acquiring lock B while holding lock A records the edge ``A -> B`` in a
process-global order graph, and an acquisition that would close a
cycle raises ``LockOrderError`` *before blocking* — an
about-to-deadlock interleaving fails the test run with the offending
chain in the message instead of hanging until the CI timeout.  Edges
are recorded by lock NAME (one node per lock role, not per instance),
matching the lock hierarchy DESIGN.md documents:

    scheduler.svc  >  scheduler.cv / requests.stream  >
    residency.flags  >  swap.pending  >  store.bytes  >
    faults.registry / restore.io

Re-entrant acquisition (RLock) and same-name sibling instances never
add self-edges.  CI runs the tier-1 shards and the ``smoke_ci``
scenario leg with the witness enabled.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the lock-order graph."""


def witness_active() -> bool:
    return os.environ.get("LLMS_LOCK_WITNESS", "") not in ("", "0")


# process-global order graph: name -> names acquired while it was held.
# _EDGE_SITES keeps one example (thread name) per edge for diagnostics.
_REG_LOCK = threading.Lock()
_EDGES: Dict[str, Set[str]] = {}
_EDGE_SITES: Dict[Tuple[str, str], str] = {}
_TLS = threading.local()


def _held_stack() -> List[str]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in _EDGES (caller holds _REG_LOCK)."""
    seen = {src}
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        for nxt in sorted(_EDGES.get(node, ())):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_attempt(name: str):
    """Record edges held-name -> name; raise on a would-be cycle.

    Called BEFORE the underlying acquire so a true inversion surfaces
    as an exception, not a hang."""
    held = _held_stack()
    if not held or name in held:        # re-entry / sibling: no self-edge
        return
    for prev in dict.fromkeys(held):    # distinct, order-preserving
        if prev == name:
            continue
        with _REG_LOCK:
            if name in _EDGES.get(prev, ()):
                continue
            back = _find_path(name, prev)
            if back is not None:
                chain = " -> ".join(back)
                raise LockOrderError(
                    f"lock-order inversion: acquiring '{name}' while "
                    f"holding '{prev}' (thread "
                    f"{threading.current_thread().name}), but the "
                    f"recorded order already has {chain}")
            _EDGES.setdefault(prev, set()).add(name)
            _EDGE_SITES[(prev, name)] = threading.current_thread().name


class OrderedLock:
    """Lock wrapper that feeds the order graph.  Wraps a Lock or RLock;
    also usable as the inner lock of a ``threading.Condition`` (only
    exposes acquire/release/context-manager, so Condition falls back to
    its generic ``_is_owned`` probe, which these semantics support for
    non-reentrant inner locks)."""

    def __init__(self, name: str, inner=None):
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if blocking:
            _note_attempt(self.name)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if not blocking:
                # try-acquire: only a SUCCESSFUL probe is an acquisition
                _note_attempt(self.name)
            _held_stack().append(self.name)
        return ok

    def release(self):
        self._inner.release()
        st = _held_stack()
        # remove the most recent entry for this name (balanced with the
        # per-acquisition push; tolerates out-of-order sibling release)
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self.name:
                del st[i]
                break

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._inner.locked()


def witness_lock(name: str):
    """-> ``threading.Lock()`` (witness off) or a named OrderedLock."""
    if witness_active():
        return OrderedLock(name, threading.Lock())
    return threading.Lock()


def witness_rlock(name: str):
    if witness_active():
        return OrderedLock(name, threading.RLock())
    return threading.RLock()


def witness_condition(name: str) -> threading.Condition:
    """Condition whose inner lock feeds the order graph (witness on)."""
    if witness_active():
        return threading.Condition(OrderedLock(name, threading.Lock()))
    return threading.Condition()


def order_graph() -> Dict[str, Set[str]]:
    """Snapshot of the recorded acquisition-order edges (tests/debug)."""
    with _REG_LOCK:
        return {k: set(v) for k, v in _EDGES.items()}


def reset_witness():
    """Clear the order graph (test isolation)."""
    with _REG_LOCK:
        _EDGES.clear()
        _EDGE_SITES.clear()
