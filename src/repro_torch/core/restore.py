"""Swapping-recompute pipelined restore (paper §3.3, Fig. 8).

The paper overlaps disk I/O with recompute at LAYER granularity: "the
computation thread proceeds to the next layer only after the I/O thread
for the current layer has completed".  To make that real (not
whole-chunk-then-compute), chunk files are written in a **layer-major
segmented format**: a pickled header + per-layer raw segments, so the
I/O thread can stream layer l of every swapped chunk, dequantize it in
numpy, and publish it while layer l-1 is still being recomputed.  The
executor's restore hands the feed a ``FeedSink``: the thread writes
layer l's rows into the executor's static host buffers and publishes
the restore's generation in a host word, on which the captured graph's
gate for layer l waits on the device (``kernels/feed_gate.py``); the
model-level API takes the rows from ``LayerFeed.fetch`` instead.

Layout per chunk file:
    [preamble][u64 header_len][pickle header][layer 0 segment]...
    preamble   = magic "LLMK", version, CRC32(header region), body length
    segment l  = for each leaf: packed[(F_l rows) x T'] bytes
                 + scales[F_l] fp32 bytes
where packed is stored TRANSPOSED (F, T') so a layer's rows are
contiguous on disk.  The header carries per-layer segment CRC32s, so
both the whole-file read path and the layer-streaming pipelined path
detect torn writes and bit-flips as ``ChunkCorruptError`` (DESIGN.md
§6) instead of decoding garbage.
"""
from __future__ import annotations

import os
import pickle
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.chunks import CompressedChunk, QuantResidentChunk
from repro_torch.core.faults import FAULTS, ChunkCorruptError, corrupt_file
from repro_torch.analysis.markers import requires_lock
from repro_torch.analysis.runtime import witness_lock

# ----------------------------------------------------------------------- #
# Disk throttle: benchmarks emulate a mobile storage tier (the paper's
# UFS/SATA) since the container's page cache would make I/O free.  Sleeps
# happen on the I/O threads, so pipeline overlap dynamics stay realistic.
# ----------------------------------------------------------------------- #
_BW = None          # bytes/sec, None = unthrottled
_LAT = 0.0          # per-op seconds


def set_disk_throttle(bw_bytes_per_s=None, lat_s=0.0):
    global _BW, _LAT
    _BW, _LAT = bw_bytes_per_s, lat_s


# Cumulative swap-tier traffic (process-global, thread-safe): every
# chunk/whole-state byte that crosses the disk tier passes a _throttle
# call site, so these counters are the ground truth for the scale
# harness's bytes-moved-per-token metric.  Snapshot with io_counters()
# and difference around a measured region.
_IO_LOCK = witness_lock("restore.io")
_IO = {"read": 0, "write": 0}


@requires_lock("_IO_LOCK")
def _bump_io_locked(kind: str, nbytes: int):
    _IO[kind] += int(nbytes)


def count_io(kind: str, nbytes: int):
    with _IO_LOCK:
        _bump_io_locked(kind, nbytes)


def io_counters() -> Dict[str, int]:
    with _IO_LOCK:
        return dict(_IO)


def reset_io_counters():
    with _IO_LOCK:
        _IO["read"] = _IO["write"] = 0


def _throttle(nbytes: int):
    if _BW:
        import time as _t
        _t.sleep(_LAT + nbytes / _BW)


# --------------------------------------------------------------------- #
# numpy codec (mirror of kernels/ref.py, for the I/O thread)
# --------------------------------------------------------------------- #
def np_dequantize(packed: np.ndarray, scale: np.ndarray, bits: int,
                  n_tokens: int) -> np.ndarray:
    """packed (T', F) int8 (or fp16 when bits=16) -> (T, F) fp32."""
    if bits == 16:
        return packed.astype(np.float32)
    if bits == 8:
        return packed.astype(np.float32) * scale
    per = 8 // bits
    u = packed.view(np.uint8)
    mask = (1 << bits) - 1
    half = 1 << (bits - 1)
    outs = []
    for j in range(per):
        c = ((u >> (bits * j)) & mask).astype(np.int32)
        c = np.where(c >= half, c - (1 << bits), c)
        outs.append(c)
    codes = np.stack(outs, axis=1).reshape(n_tokens, packed.shape[1])
    return codes.astype(np.float32) * scale


# --------------------------------------------------------------------- #
# segmented chunk file format
# --------------------------------------------------------------------- #
# preamble: magic, version, reserved, CRC32 of [u64 hlen][pickle header],
# total body length ([u64 hlen] + header + all segments)
_CH_MAGIC = b"LLMK"
_CH_VERSION = 2
_CH_PREAMBLE = struct.Struct("<4sHHIQ")


def write_chunk_file(path: str, cc, n_layers: int) -> int:
    """Serialize layer-major.  F must be layer-major (it is: the codec
    flattens (L, B, heads, hd) with L outermost).  Accepts both storage
    grids: CompressedChunk (per-channel scales, header grid "channel")
    and QuantResidentChunk (per-(token, kv-head) scales stored as
    (Fs, T') f32 rows per layer, header grid "token_head")."""
    grid = "token_head" if isinstance(cc, QuantResidentChunk) else "channel"
    header = {"bits": cc.bits, "n_tokens": cc.n_tokens, "n_layers": n_layers,
              "grid": grid, "leaves": {}}
    segs: List[bytes] = [b""] * n_layers
    for name, (packed, scale) in cc.data.items():
        Tp, F = packed.shape
        assert F % n_layers == 0, (name, F, n_layers)
        Fl = F // n_layers
        isz = packed.dtype.itemsize
        ssz = 0 if cc.bits == 16 else 4
        meta = {"Tp": Tp, "F": F, "Fl": Fl, "isz": isz,
                "ssz": ssz, "shape": cc.shapes[name]}
        if grid == "token_head":
            Fs = scale.shape[1]
            assert Fs % n_layers == 0, (name, Fs, n_layers)
            meta["Fs"] = Fs
            meta["Fsl"] = Fs // n_layers
            meta["sbytes"] = 4 * meta["Fsl"] * Tp
            st = np.ascontiguousarray(scale.T, dtype=np.float32)  # (Fs, T')
        header["leaves"][name] = meta
        pt = np.ascontiguousarray(packed.T)         # (F, T')
        for l in range(n_layers):
            segs[l] = segs[l] + pt[l * Fl:(l + 1) * Fl].tobytes()
            if grid == "token_head":
                Fsl = meta["Fsl"]
                segs[l] = segs[l] + st[l * Fsl:(l + 1) * Fsl].tobytes()
            elif cc.bits != 16:
                segs[l] = segs[l] + np.ascontiguousarray(
                    scale[l * Fl:(l + 1) * Fl], dtype=np.float32).tobytes()
    header["seg_crc"] = [zlib.crc32(s) for s in segs]
    FAULTS.check("disk.write", path)
    hdr = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    hregion = struct.pack("<Q", len(hdr)) + hdr
    body_len = len(hregion) + sum(len(s) for s in segs)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_CH_PREAMBLE.pack(_CH_MAGIC, _CH_VERSION, 0,
                                  zlib.crc32(hregion), body_len))
        f.write(hregion)
        for s in segs:
            f.write(s)
    action = FAULTS.corrupt_action(path)
    if action is not None:
        corrupt_file(tmp, action)
    os.replace(tmp, path)
    FAULTS.note_write_ok(path)
    total = _CH_PREAMBLE.size + body_len
    count_io("write", total)
    _throttle(total)
    return total


def _read_header(f) -> Tuple[dict, int]:
    """Parse + VERIFY the preamble and pickled header.  Detects torn
    files (size mismatch vs the recorded body length) and header
    corruption (CRC mismatch) before unpickling anything."""
    pre = f.read(_CH_PREAMBLE.size)
    if len(pre) < _CH_PREAMBLE.size:
        raise ChunkCorruptError("chunk file: truncated preamble")
    magic, ver, _, hcrc, body_len = _CH_PREAMBLE.unpack(pre)
    if magic != _CH_MAGIC:
        raise ChunkCorruptError(f"chunk file: bad magic {magic!r}")
    if ver != _CH_VERSION:
        raise ChunkCorruptError(f"chunk file: unknown version {ver}")
    size = os.fstat(f.fileno()).st_size
    if size != _CH_PREAMBLE.size + body_len:
        raise ChunkCorruptError(
            f"chunk file: torn ({size} of {_CH_PREAMBLE.size + body_len} "
            f"bytes)")
    hlen_raw = f.read(8)
    (hlen,) = struct.unpack("<Q", hlen_raw)
    hdr = f.read(hlen)
    if zlib.crc32(hlen_raw + hdr) != hcrc:
        raise ChunkCorruptError("chunk file: header CRC32 mismatch")
    header = pickle.loads(hdr)
    return header, _CH_PREAMBLE.size + 8 + hlen


def verify_chunk_file(path: str):
    """Cheap structural check (preamble, size, header CRC) without
    reading segment payloads — the pipelined restore pre-validates its
    inputs with this so a guaranteed-bad file is routed to recompute
    instead of poisoning the whole layer feed."""
    with open(path, "rb") as f:
        _read_header(f)


def _segment_size(header: dict) -> int:
    return sum(m["Fl"] * m["Tp"] * m.get("isz", 1)
               + m.get("sbytes", m.get("ssz", 4) * m["Fl"])
               for m in header["leaves"].values())


def read_chunk_layer(f, header: dict, base: int, layer: int
                     ) -> Dict[str, np.ndarray]:
    """-> leaf -> dequantized (T, Fl) fp32 for one layer."""
    seg = _segment_size(header)
    f.seek(base + layer * seg)
    buf = f.read(seg)
    count_io("read", seg)
    _throttle(seg)
    crcs = header.get("seg_crc")
    if crcs is not None and zlib.crc32(buf) != crcs[layer]:
        raise ChunkCorruptError(
            f"chunk file: layer {layer} segment CRC32 mismatch")
    out, off = {}, 0
    bits, T = header["bits"], header["n_tokens"]
    token_head = header.get("grid", "channel") == "token_head"
    for name, m in header["leaves"].items():
        dt = np.float16 if bits == 16 else np.int8
        nb = m["Fl"] * m["Tp"] * m.get("isz", 1)
        pt = np.frombuffer(buf[off:off + nb], dt).reshape(m["Fl"], m["Tp"])
        off += nb
        if token_head:
            ns = m["sbytes"]
            sc = np.frombuffer(buf[off:off + ns], np.float32
                               ).reshape(m["Fsl"], m["Tp"])
            off += ns
            codes = np.ascontiguousarray(pt.T)                  # (T, Fl)
            hd = m["Fl"] // m["Fsl"]
            out[name] = (codes.reshape(T, m["Fsl"], hd).astype(np.float32)
                         * sc.T[..., None]).reshape(T, m["Fl"])
        else:
            ns = m.get("ssz", 4) * m["Fl"]
            sc = np.frombuffer(buf[off:off + ns], np.float32)
            off += ns
            out[name] = np_dequantize(np.ascontiguousarray(pt.T), sc,
                                      bits, T)
    return out


def read_chunk_file(path: str):
    """Whole-chunk read (non-pipelined swap-in path).  Returns the
    payload in its storage grid: CompressedChunk for "channel" files,
    QuantResidentChunk for "token_head" files."""
    FAULTS.check("disk.read", path)
    with open(path, "rb") as f:
        header, base = _read_header(f)
        L = header["n_layers"]
        token_head = header.get("grid", "channel") == "token_head"
        data, shapes = {}, {}
        per_leaf_packed = {n: [] for n in header["leaves"]}
        per_leaf_scale = {n: [] for n in header["leaves"]}
        seg = _segment_size(header)
        f.seek(base)
        buf = f.read(seg * L)
        count_io("read", seg * L)
        _throttle(seg * L)
        crcs = header.get("seg_crc")
        dt = np.float16 if header["bits"] == 16 else np.int8
        for l in range(L):
            off = l * seg
            if crcs is not None and \
                    zlib.crc32(buf[off:off + seg]) != crcs[l]:
                raise ChunkCorruptError(
                    f"chunk file: layer {l} segment CRC32 mismatch")
            for name, m in header["leaves"].items():
                nb = m["Fl"] * m["Tp"] * m.get("isz", 1)
                pt = np.frombuffer(buf[off:off + nb], dt
                                   ).reshape(m["Fl"], m["Tp"])
                off += nb
                if token_head:
                    ns = m["sbytes"]
                    sc = np.frombuffer(buf[off:off + ns], np.float32
                                       ).reshape(m["Fsl"], m["Tp"])
                else:
                    ns = m.get("ssz", 4) * m["Fl"]
                    sc = np.frombuffer(buf[off:off + ns], np.float32)
                off += ns
                per_leaf_packed[name].append(pt)
                per_leaf_scale[name].append(sc)
        for name, m in header["leaves"].items():
            packed = np.concatenate(per_leaf_packed[name], axis=0).T
            scale = np.concatenate(per_leaf_scale[name], axis=0)
            if token_head:
                scale = scale.T                              # (T, Fs)
            data[name] = (np.ascontiguousarray(packed),
                          np.ascontiguousarray(scale))
            shapes[name] = tuple(m["shape"])
    if token_head:
        return QuantResidentChunk(n_tokens=header["n_tokens"], data=data,
                                  shapes=shapes)
    return CompressedChunk(bits=header["bits"], n_tokens=header["n_tokens"],
                           data=data, shapes=shapes)


# --------------------------------------------------------------------- #
# LayerFeed: the I/O thread publishing per-layer KV for the scan
# --------------------------------------------------------------------- #
def publish_plain(flags: np.ndarray) -> Callable[[int, int], None]:
    """A sink's ``publish`` over host words that only the host reads
    (the CPU): a plain store, ordered after the rows by the GIL."""
    def publish(layer: int, word: int) -> None:
        flags[layer] = word
    return publish


@dataclass(frozen=True)
class FeedSink:
    """Where a ``LayerFeed`` puts every layer's rows for a consumer that
    cannot call it back (a captured CUDA graph): ``bufs`` leaf -> (L,
    rows, *dims) fp32 host arrays (page-locked on the card), static
    across restores; ``flags`` (L,) int32 host words; ``gen`` this
    restore's generation.  After layer l's rows are written the feed
    calls ``publish(l, gen)``, and ``publish(l, -gen)`` for every layer
    it will not write.  A word of another generation means neither, so
    no word is ever reset."""
    bufs: Dict[str, np.ndarray]
    flags: np.ndarray
    gen: int
    publish: Callable[[int, int], None]

    @property
    def rows(self) -> int:
        return next(iter(self.bufs.values())).shape[1]


class LayerFeed:
    """Streams layer-l KV of every I/O chunk, one layer ahead of compute.

    paths: chunk files in POSITION order; pad_chunks: extra zero chunks
    appended so the assembled arrays match the I/O bucket size.  With a
    ``sink`` (``ModelExecutor.layer_feed``) the thread writes layer l's
    rows straight into ``sink.bufs[leaf][l]`` and publishes it there;
    it then calls nothing of torch or CUDA (the card may be waiting for
    it: a page-locked allocation could wait for the card in turn).
    Without one, each layer's arrays come from ``alloc`` (``shape ->
    zeroed fp32 array``, default ``np.zeros``), and ``attach`` can relay
    them into a sink later.  ``fetch`` serves every layer to the host
    either way.
    """

    def __init__(self, paths: Sequence[str], leaves: Sequence[str],
                 n_layers: int, chunk_tokens: int,
                 leaf_dims: Dict[str, Tuple[int, ...]],
                 pad_chunks: int = 0,
                 pool: Optional[ThreadPoolExecutor] = None,
                 alloc: Optional[Callable[[Tuple[int, ...]],
                                          np.ndarray]] = None,
                 sink: Optional[FeedSink] = None):
        self.paths = list(paths)
        self.leaves = list(leaves)
        self.n_layers = n_layers
        self.cs = chunk_tokens
        self.leaf_dims = leaf_dims          # leaf -> per-token dims e.g. (KV, hd)
        self.pad = pad_chunks
        self.n_tok = (len(self.paths) + pad_chunks) * chunk_tokens
        if sink is not None and self.n_tok > sink.rows:
            raise ValueError(f"LayerFeed: {self.n_tok} rows a layer do not "
                             f"fit the sink's {sink.rows}")
        self.sink = sink
        self._alloc = alloc or (lambda shape: np.zeros(shape, np.float32))
        self._ready: List[Optional[Dict[str, np.ndarray]]] = \
            [None] * n_layers
        self._events = [threading.Event() for _ in range(n_layers)]
        self._cancel = threading.Event()
        self._error: Optional[BaseException] = None
        self._relay: Optional[threading.Thread] = None
        self._pool = pool or ThreadPoolExecutor(max_workers=1)
        self._own_pool = pool is None
        self._fut = self._pool.submit(self._run)

    @property
    def error(self) -> Optional[BaseException]:
        """What stopped the feed (read after its layers' events)."""
        return self._error

    def _shape(self, name: str) -> Tuple[int, ...]:
        return tuple(np.atleast_1d(self.leaf_dims[name]))

    def _run(self):
        files, headers, bases = [], [], []
        sink, published = self.sink, 0
        try:
            for p in self.paths:
                FAULTS.check("disk.read", p)
                f = open(p, "rb")
                h, b = _read_header(f)
                files.append(f)
                headers.append(h)
                bases.append(b)
            n_real = len(self.paths) * self.cs
            for l in range(self.n_layers):
                if self._cancel.is_set():
                    raise RuntimeError("LayerFeed cancelled")
                if sink is None:
                    assembled = {name: self._alloc((self.n_tok,)
                                                   + self._shape(name))
                                 for name in self.leaves}
                else:
                    assembled = {name: sink.bufs[name][l, :self.n_tok]
                                 for name in self.leaves}
                    for a in assembled.values():
                        a[n_real:] = 0.0             # the pad chunks
                for ci, (f, h, b) in enumerate(zip(files, headers, bases)):
                    got = read_chunk_layer(f, h, b, l)
                    for name in self.leaves:
                        blk = got[name]          # (T, Fl) layer-major slice
                        assembled[name][ci * self.cs:(ci + 1) * self.cs] = \
                            blk.reshape((self.cs,) + self._shape(name))
                if sink is not None:
                    sink.publish(l, sink.gen)
                    published = l + 1
                self._ready[l] = assembled
                self._events[l].set()
        except BaseException as err:
            self._error = err                # fetch() chains this cause
            raise
        finally:
            for f in files:
                f.close()
            if sink is not None:             # the gates stop waiting
                for l in range(published, self.n_layers):
                    sink.publish(l, -sink.gen)
            for e in self._events:           # unblock on failure
                if not e.is_set():
                    e.set()

    def fetch(self, layer: int) -> Dict[str, np.ndarray]:
        l = int(layer)
        self._events[l].wait()
        out = self._ready[l]
        if out is None:
            raise RuntimeError("LayerFeed I/O failed") from self._error
        self._ready[l] = None                # free as consumed
        return out

    def attach(self, sink: FeedSink) -> None:
        """Relay a sink-less feed into ``sink``: a thread of its own
        fetches each layer, copies its rows into ``sink.bufs[leaf][l]``
        and publishes it (``-gen`` from the first layer it cannot
        fetch).  Like the feed's, the relay's thread calls nothing of
        torch or CUDA."""
        if self.sink is not None:
            raise ValueError("LayerFeed: already writes into a sink")
        if self.n_tok > sink.rows:
            raise ValueError(f"LayerFeed: {self.n_tok} rows a layer do not "
                             f"fit the sink's {sink.rows}")
        self.sink = sink
        self._relay = threading.Thread(target=self._run_relay,
                                       name="llms-feed-relay", daemon=True)
        self._relay.start()

    def _run_relay(self):
        sink, published = self.sink, 0
        try:
            for l in range(self.n_layers):
                got = self.fetch(l)
                for name in self.leaves:
                    sink.bufs[name][l, :self.n_tok] = got[name]
                sink.publish(l, sink.gen)
                published = l + 1
        except BaseException as err:
            if self._error is None:          # else fetch() chained it
                self._error = err
        finally:
            for l in range(published, self.n_layers):
                sink.publish(l, -sink.gen)

    def cancel(self) -> None:
        """Stop at the next layer without waiting (a restore that timed
        out); the layers not yet published are published as failed."""
        self._cancel.set()

    def done(self) -> bool:
        """Whether the feed's thread (and its relay) have ended."""
        return self._fut.done() and (self._relay is None
                                     or not self._relay.is_alive())

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` seconds for ``done``.  -> done."""
        try:
            self._fut.exception(timeout)
        except _FutTimeout:
            return False
        if self._relay is not None:
            self._relay.join(timeout)
        return self.done()

    def close(self, raise_errors: bool = True):
        try:
            self._fut.result()
        except BaseException:
            if raise_errors:
                raise
        finally:
            if self._relay is not None:
                self._relay.join()
            if self._own_pool:
                self._pool.shutdown(wait=False)
