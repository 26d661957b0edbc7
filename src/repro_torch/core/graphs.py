"""The executor's compile layer: one captured CUDA graph per entry,
bucket and set of buffers, for the paged pool and for the slot engine.

Counterpart of the JAX package's ``_JIT_CACHE`` (``core/executor.py``):
the reference compiles ``paged_extend`` once per token bucket and
``paged_decode`` once per batch bucket, and the slot engine's
``extend`` / ``extend_nod`` once per token bucket (a family that is
not ``pad_safe`` once per exact length) and ``decode`` once, and the
Fig.-8 restore (``recompute_pipelined``, whose layers take the disk
rows through an ordered ``io_callback``) once per shape; each call
runs one compiled program in which ``seq_len`` is a traced device
scalar and the head product is the jitted ``logits_fn``.  Here a
``GraphEntry`` per key holds

* static input buffers (tokens, positions, the page-table rows ``pt16``
  / ``pt8``, ``qmask``, and the ``seq_len`` and last-row scalars; a
  pipelined restore's I/O positions, generation and gate deadline),
  which every call fills from its host arrays;
* the body, a plain function of those buffers, the params and the
  buffers the graph reads and writes in place (the paged pool's
  arenas, or one static slot cache), marked by ``capturable``;
* on the card, the ``torch.cuda.CUDAGraph`` captured from the body;
* the static outputs (logits and density or mass; an ``extend_nod``'s
  hidden rows; a pipelined restore's hidden rows and its gates' status
  and waits).

A key is (entry name, bucket or length, quant-resident) for the paged
entries and (entry name, bucket or length, quant-resident, slot) for a
slot cache's, a pipelined restore's bucket being (token bucket, I/O
chunk bucket): the fields after the third name the buffers the graph
was captured over (``binding``: () the arenas, (slot,) that slot's
cache), since a graph bakes in their addresses.

On the card a call copies its host arrays into page-locked staging
buffers, from those into the static inputs without blocking, replays
the graph and copies the outputs to the host.  On the CPU the body runs
eagerly on the same buffers: that is the device the caller asked for,
not a fallback.

Capture.  The executor captures every bucket of its entries when it
builds its arenas or its slot caches (``ModelExecutor.init_arenas`` /
``init_slots``, ``prepare``): that is before the service's threads
start, and outside every call's latency (captured at a bucket's first
call instead, a capture put 0.1-0.2 s into that call's time to first
token).  A graph is captured on its static inputs as made, all zero:
every page-table row then points at the scratch page 0, the only page
the warm-up writes; a slot's warm-ups write into its cache, which the
executor zeroes after them.  Entries captured ahead are pinned: no
LRU eviction puts their recapture into a call.  The body runs once
on a side stream (kernels build and load there, ``cudaFuncSetAttribute``
runs, cuBLAS takes its workspace), then ``torch.cuda.graph`` captures it
on the same stream into the one memory pool that the executor's graphs
share, with ``capture_error_mode="thread_local"``.  A key not captured
then (an exact-length extend) is captured at its first call, the same
way, under the cache's lock, with the buffers the caller names
(``keep``: a live slot's cache) put back after the warm-up; these
captures are counted apart (``late_captures``, ``late_capture_s``).
Only the thread that holds the service (the router serializes every
service call) runs the model on the card; the swapper's workers and
the restore feed's thread touch host arrays only.  Nothing falls
back to the eager body on the card: a body that syncs with the host
(``.item()``, ``int()`` of a tensor, ``.cpu()``) makes the capture
raise, and the error propagates.

Launch counts.  The kernel wrappers count in Python where they launch,
and a replay runs no Python.  So each graph keeps the counts its
capture added and credits them at every replay
(``kernels.add_launch_counts``); the warm-up's and the capture's own
counts are taken back, and a capture that counted otherwise than the
eager warm-up raises.

Memory.  The graphs share one pool, so a replay may overwrite the
static outputs of another bucket's graph: every call copies its outputs
out (to the host, or into device tensors of its own) before it
returns, before any other replay.  The pool is
device memory outside the LLMS budget (``pool_bytes``: the segments the
captures reserved; the graphs' temporaries are reserved, not allocated,
between replays).

The cache is the executor's, not the process's.  A graph bakes in the
device addresses of this executor's params, arenas and slot caches, so
the reference's sharing of compiled entries across models of one
fingerprint has no sound counterpart: a new executor never sees
another's graphs.  Keys are stable values (entry name, bucket,
quant-resident, and a slot index from ``SlotAllocator``), never
``id()`` or ``data_ptr()``.  The entries captured ahead are pinned:
their number is fixed by the executor's buckets and slots (a decode
slot's decode and two entries a token bucket, the scratch slot's two
a bucket: 21 at ``max_ctx_len`` 256 and ``decode_batch`` 1, 65 at
``decode_batch`` 5; where restores pipeline, 24 pipelined restores a
decode slot and 3 on the scratch slot more: 48 and 188), and an eviction would put a recapture of 0.1-1 s
into some call.  The entries made at first use (an exact-length
family's extends; on the CPU every entry) are LRU-bounded as the
reference's cache (``GRAPH_CACHE_MAX``).  A call with buffers other
than the ones its binding holds (``init_arenas`` rebuilt the arenas)
drops that binding's graphs first.
"""
from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels

# as the reference's _JIT_CACHE_MAX
GRAPH_CACHE_MAX = 64

# (entry name, bucket or length, quant-resident[, slot])
Key = Tuple
# name -> (shape, dtype) of a static input
InputSpec = Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]


def capturable(body: Callable) -> Callable:
    """Mark ``body`` as a graph body: a plain function of the static
    inputs, the params and the arenas, which reads nothing of an engine
    object (copy it into locals first) and syncs nothing with the host.
    The cache takes only bodies marked so, and the port's analyzer
    (``python -m repro_torch.analysis``, rules J1 and J2) reads every
    function handed here.  -> ``body``."""
    body.graph_body = True
    return body


class GraphEntry:
    """One entry at one bucket: its static inputs, its body and, on the
    card, the graph captured from the body and its static outputs."""

    def __init__(self, key: Key, spec: InputSpec, body: Callable,
                 device: torch.device):
        if not getattr(body, "graph_body", False):
            raise TypeError(f"graph {key}: its body was not handed to "
                            "capturable()")
        self.key = key
        self.body = body
        self.device = device
        on_card = device.type == "cuda"
        self.inputs = {n: torch.zeros(shape, dtype=dt, device=device)
                       for n, (shape, dt) in spec.items()}
        # page-locked staging on the card: the copies to the static
        # inputs do not block the host
        self._staging = {n: torch.zeros(shape, dtype=dt, pin_memory=True)
                         for n, (shape, dt) in spec.items()} \
            if on_card else None
        # the last staging copies: the pinned buffers are not refilled
        # before they ran (a call whose outputs stay on the card does
        # not wait for its replay)
        self._staged: Optional[torch.cuda.Event] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.calls = 0                  # calls staged into this entry

    def stage(self, host: Mapping[str, np.ndarray]) -> None:
        """The host arrays (one per static input, of its shape) into the
        static inputs."""
        if self._staged is not None:
            self._staged.synchronize()
        for n, t in self.inputs.items():
            if self._staging is None:
                np.copyto(t.numpy(), host[n], casting="unsafe")
            else:
                np.copyto(self._staging[n].numpy(), host[n],
                          casting="unsafe")
                t.copy_(self._staging[n], non_blocking=True)
        if self._staging is not None:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def eager(self) -> Tuple[torch.Tensor, ...]:
        """The body on the static inputs, eagerly."""
        return tuple(self.body(self.inputs))

    def capture(self, stream: torch.cuda.Stream, pool,
                keep: Sequence[torch.Tensor] = ()) -> None:
        """Warm the body up on ``stream``, then capture it there into
        ``pool``; the launches of both are not counted, and the graph
        keeps the capture's.  The tensors of ``keep`` (a live slot's
        cache) hold their bytes again afterwards: the warm-up writes
        into the buffers the body updates."""
        before = kernels.launch_counts()
        cur = torch.cuda.current_stream(self.device)
        saved = [t.clone() for t in keep]
        stream.wait_stream(cur)
        t0 = time.perf_counter()
        try:
            with torch.cuda.stream(stream):
                self.eager()
            warm = kernels.launch_counts()
            # torch.cuda.graph empties the cache first: so does this, so
            # that the reserved bytes grow by the pool's new segments only
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            # no cyclic collection inside the capture: it would destroy
            # unreachable graphs (a dropped service's) there, which the
            # capture refuses and is invalidated by
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    outputs = self.eager()
            finally:
                if collecting:
                    gc.enable()
            cur.wait_stream(stream)
            after = kernels.launch_counts()
        finally:
            kernels.set_launch_counts(before)
            if keep:
                cur.wait_stream(stream)
                for t, s in zip(keep, saved):
                    t.copy_(s)
            del saved
        eager_n = {k: warm[k] - before[k] for k in before}
        captured = {k: after[k] - warm[k] for k in before}
        if captured != eager_n:
            raise RuntimeError(
                f"graph {self.key}: the capture counted {captured} "
                f"launches, the eager body {eager_n}")
        self.graph, self.outputs = graph, outputs
        self.launches = {k: n for k, n in captured.items() if n}
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def replay(self) -> Tuple[torch.Tensor, ...]:
        """The captured graph on the current stream; its launches
        credited.  -> the static outputs (valid until the next replay
        of any graph of the pool)."""
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        return self.outputs


def binding(key: Key) -> Tuple:
    """The buffers a key's graph was captured over: () the paged pool's
    arenas, (slot,) that slot's cache."""
    return tuple(key[3:])


class GraphCache:
    """The executor's entries by key; those captured ahead pinned, the
    others LRU-bounded; each binding tied to one set of buffers."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: "OrderedDict[Key, GraphEntry]" = OrderedDict()
        self._pinned: set = set()
        self._bound: Dict[Tuple, Dict[str, torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._stream = None
        self._pool = None
        # totals over the cache's life, dropped entries included
        self.calls = 0
        self.replays = 0
        self.captures: Dict[Key, int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.drops = 0
        # captures at a key's first call rather than ahead
        self.late_captures = 0
        self.late_capture_s = 0.0
        # entry name -> [captures, capture seconds, those at first call]
        self._by_entry: Dict[str, list] = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def entry(self, key: Key) -> Optional[GraphEntry]:
        return self._entries.get(key)

    def drop(self, bound: Tuple = ()) -> None:
        """Drop the entries of one binding (() the arenas, (slot,) a slot
        cache)."""
        gone = [k for k in self._entries if binding(k) == bound]
        for k in gone:
            del self._entries[k]
        self._pinned.difference_update(gone)
        if gone:
            self.drops += 1

    def bind(self, buffers: Mapping[str, torch.Tensor],
             bound: Tuple = ()) -> None:
        """Tie binding ``bound`` to ``buffers``; its graphs captured over
        other buffers are dropped."""
        held = self._bound.get(bound)
        if held is None or held.keys() != buffers.keys() or any(
                held[n] is not buffers[n] for n in buffers):
            self.drop(bound)
            self._bound[bound] = dict(buffers)

    def _get(self, key: Key) -> Optional[GraphEntry]:
        got = self._entries.get(key)
        if got is not None:
            self._entries.move_to_end(key)
        return got

    def _put(self, key: Key, entry: GraphEntry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        lru = [k for k in self._entries if k not in self._pinned]
        for k in lru[:max(0, len(lru) - GRAPH_CACHE_MAX)]:
            del self._entries[k]

    def _ready(self, key: Key, spec: InputSpec,
               make_body: Callable[[], Callable],
               keep: Sequence[torch.Tensor] = (),
               ahead: bool = False) -> GraphEntry:
        """Entry ``key``, made (``make_body()`` builds its body) and, on
        the card, captured where it is not yet (``keep``: as
        ``GraphEntry.capture``); ``ahead`` pins it."""
        entry = self._get(key)
        if entry is None:
            entry = GraphEntry(key, spec, make_body(), self.device)
        if self.on_card and entry.graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            entry.capture(self._stream, self._pool, keep)
            self.captures[key] = self.captures.get(key, 0) + 1
            self.capture_s += entry.capture_s
            self.pool_bytes += entry.pool_bytes
            by = self._by_entry.setdefault(key[0], [0, 0.0, 0])
            by[0] += 1
            by[1] += entry.capture_s
            if not ahead:
                self.late_captures += 1
                self.late_capture_s += entry.capture_s
                by[2] += 1
        if ahead:
            self._pinned.add(key)
        self._put(key, entry)
        return entry

    def prepare(self, buffers, key: Key, spec: InputSpec,
                make_body: Callable[[], Callable]) -> None:
        """Make and capture entry ``key`` over ``buffers`` now, ahead of
        its first call, and pin it."""
        with self._lock:
            self.bind(buffers, binding(key))
            self._ready(key, spec, make_body, ahead=True)

    def run(self, buffers, key: Key, spec: InputSpec,
            make_body: Callable[[], Callable],
            host: Mapping[str, np.ndarray],
            keep: Sequence[torch.Tensor] = (),
            to_host: bool = True) -> Sequence:
        """One call of entry ``key`` over ``buffers``: the host arrays
        staged into its static inputs, then on the card its graph
        replayed, on the CPU its body run.  -> the outputs, copied to
        the host (``to_host``), else tensors on the device that no
        later replay overwrites."""
        with self._lock:
            self.bind(buffers, binding(key))
            entry = self._ready(key, spec, make_body, keep)
            entry.stage(host)
            entry.calls += 1
            if self.on_card:
                outs = entry.replay()
                self.replays += 1
            else:
                outs = entry.eager()
            self.calls += 1
            if to_host:
                return [o.cpu().numpy() for o in outs]
            return [o.clone() if self.on_card else o for o in outs]

    def stats(self) -> Dict:
        """Calls, replays, captures by key (counted over the cache's
        life), capture seconds, those at a key's first call, the same
        three by entry name, the pool bytes the captures reserved, the
        entries held (pinned) and the drops."""
        return {"calls": self.calls, "replays": self.replays,
                "captures": {"/".join(map(str, k)): n
                             for k, n in sorted(self.captures.items())},
                "capture_s": self.capture_s,
                "late_captures": self.late_captures,
                "late_capture_s": self.late_capture_s,
                "by_entry": {n: {"captures": c, "capture_s": t,
                                 "late_captures": late}
                             for n, (c, t, late) in
                             sorted(self._by_entry.items())},
                "pool_bytes": self.pool_bytes,
                "entries": len(self._entries), "pinned": len(self._pinned),
                "drops": self.drops}
