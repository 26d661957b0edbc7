"""The executor's compile layer for the paged pool: one captured CUDA
graph per entry and bucket.

Counterpart of the JAX package's ``_JIT_CACHE`` (``core/executor.py``):
the reference compiles ``paged_extend`` once per token bucket and
``paged_decode`` once per batch bucket, and each call runs one compiled
program in which ``seq_len`` is a traced device scalar and the head
product is the jitted ``logits_fn``.  Here a ``GraphEntry`` per (entry
name, bucket, quant-resident) holds

* static input buffers (tokens, positions, the page-table rows ``pt16``
  / ``pt8``, ``qmask``, and the ``seq_len`` and last-row scalars), which
  every call fills from its host arrays;
* the body, a plain function of those buffers, the params and the
  arenas (the model's entry and its head product), marked by
  ``capturable``;
* on the card, the ``torch.cuda.CUDAGraph`` captured from the body;
* the static outputs (logits and density or mass).

On the card a call copies its host arrays into page-locked staging
buffers, from those into the static inputs without blocking, replays
the graph and copies the outputs to the host.  On the CPU the body runs
eagerly on the same buffers: that is the device the caller asked for,
not a fallback.

Capture.  The executor captures every bucket of its entries when it
builds its arenas (``ModelExecutor.init_arenas``, ``prepare``): that is
before the service's threads start, and outside every call's latency
(captured at a bucket's first call instead, a capture put 0.1-0.2 s into
that call's time to first token).  A graph is captured on its static
inputs as made, all zero: every page-table row then points at the
scratch page 0, the only page the warm-up writes.  The body runs once
on a side stream (kernels build and load there, ``cudaFuncSetAttribute``
runs, cuBLAS takes its workspace), then ``torch.cuda.graph`` captures it
on the same stream into the one memory pool that the executor's graphs
share, with ``capture_error_mode="thread_local"``.  A key not captured
then is captured at its first call, the same way, under the cache's
lock.  Only the thread that holds the service (the router serializes
every service call) runs the model on the card; the swapper's workers
and the restore feed's thread touch host arrays only.  Nothing falls
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
to the host before it returns, before any other replay.  The pool is
device memory outside the LLMS budget (``pool_bytes``: the segments the
captures reserved; the graphs' temporaries are reserved, not allocated,
between replays).

The cache is the executor's, not the process's.  A graph bakes in the
device addresses of this executor's params and arenas, so the
reference's sharing of compiled entries across models of one
fingerprint has no sound counterpart: a new executor never sees
another's graphs.  Keys are stable values (entry name, bucket,
quant-resident), never ``id()`` or ``data_ptr()``; the cache is
LRU-bounded as the reference's (``GRAPH_CACHE_MAX``).  A call with
arenas other than the bound ones (``init_arenas`` rebuilt them) drops
every graph first.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels

# as the reference's _JIT_CACHE_MAX
GRAPH_CACHE_MAX = 64

Key = Tuple[str, int, bool]
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
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    def stage(self, host: Mapping[str, np.ndarray]) -> None:
        """The host arrays (one per static input, of its shape) into the
        static inputs."""
        for n, t in self.inputs.items():
            if self._staging is None:
                np.copyto(t.numpy(), host[n], casting="unsafe")
            else:
                np.copyto(self._staging[n].numpy(), host[n],
                          casting="unsafe")
                t.copy_(self._staging[n], non_blocking=True)

    def eager(self) -> Tuple[torch.Tensor, ...]:
        """The body on the static inputs, eagerly."""
        return tuple(self.body(self.inputs))

    def capture(self, stream: torch.cuda.Stream, pool) -> None:
        """Warm the body up on ``stream``, then capture it there into
        ``pool``; the launches of both are not counted, and the graph
        keeps the capture's."""
        before = kernels.launch_counts()
        cur = torch.cuda.current_stream(self.device)
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
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                outputs = self.eager()
            cur.wait_stream(stream)
            after = kernels.launch_counts()
        finally:
            kernels.set_launch_counts(before)
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


class GraphCache:
    """The executor's entries by (entry name, bucket, quant-resident),
    LRU-bounded, bound to one set of arenas."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._entries: "OrderedDict[Key, GraphEntry]" = OrderedDict()
        self._arenas: Optional[Dict[str, torch.Tensor]] = None
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

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def entry(self, key: Key) -> Optional[GraphEntry]:
        return self._entries.get(key)

    def clear(self) -> None:
        """Drop every entry (and the pool their graphs share)."""
        if self._entries:
            self.drops += 1
        self._entries.clear()
        self._pool = None

    def bind(self, arenas: Mapping[str, torch.Tensor]) -> None:
        """Bind the cache to ``arenas``; graphs captured over other
        arenas are dropped."""
        bound = self._arenas
        if bound is None or bound.keys() != arenas.keys() or any(
                bound[n] is not arenas[n] for n in arenas):
            self.clear()
            self._arenas = dict(arenas)

    def _get(self, key: Key) -> Optional[GraphEntry]:
        got = self._entries.get(key)
        if got is not None:
            self._entries.move_to_end(key)
        return got

    def _put(self, key: Key, entry: GraphEntry) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > GRAPH_CACHE_MAX:
            self._entries.popitem(last=False)

    def _ready(self, key: Key, spec: InputSpec,
               make_body: Callable[[], Callable]) -> GraphEntry:
        """Entry ``key``, made (``make_body()`` builds its body) and, on
        the card, captured where it is not yet."""
        entry = self._get(key)
        if entry is None:
            entry = GraphEntry(key, spec, make_body(), self.device)
        if self.on_card and entry.graph is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            entry.capture(self._stream, self._pool)
            self.captures[key] = self.captures.get(key, 0) + 1
            self.capture_s += entry.capture_s
            self.pool_bytes += entry.pool_bytes
        self._put(key, entry)
        return entry

    def prepare(self, arenas, key: Key, spec: InputSpec,
                make_body: Callable[[], Callable]) -> None:
        """Make and capture entry ``key`` over ``arenas`` now, ahead of
        its first call."""
        with self._lock:
            self.bind(arenas)
            self._ready(key, spec, make_body)

    def run(self, arenas, key: Key, spec: InputSpec,
            make_body: Callable[[], Callable],
            host: Mapping[str, np.ndarray]) -> Sequence[np.ndarray]:
        """One call of entry ``key`` over ``arenas``: the host arrays
        staged into its static inputs, then on the card its graph
        replayed, on the CPU its body run.  -> the outputs, copied to
        the host."""
        with self._lock:
            self.bind(arenas)
            entry = self._ready(key, spec, make_body)
            entry.stage(host)
            if self.on_card:
                outs = entry.replay()
                self.replays += 1
            else:
                outs = entry.eager()
            self.calls += 1
            return [o.cpu().numpy() for o in outs]

    def stats(self) -> Dict:
        """Calls, replays, captures by key (counted over the cache's
        life), capture seconds, the pool bytes the captures reserved,
        the entries held and the drops."""
        return {"calls": self.calls, "replays": self.replays,
                "captures": {"/".join(map(str, k)): n
                             for k, n in sorted(self.captures.items())},
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "entries": len(self._entries), "drops": self.drops}
