"""Disk swap tier (paper §3.1 primitives; pickle-backed like the paper's
prototype) with an async writer used by AoT swapping (§3.4).

On a real TPU pod this is the host-DRAM/remote-store offload tier; the
interface is the same (DESIGN.md §3).  All I/O happens on a dedicated
thread pool so ``callLLM`` returns without waiting for swap-out — only
``flush()`` (or a later read of the same key) synchronizes.

Fault tolerance (DESIGN.md §6): every file carries a checksummed
preamble (magic, version, CRC32, payload length) so torn writes and
bit-flips surface as ``ChunkCorruptError`` instead of unpickling
garbage; worker jobs retry transient IO errors with bounded exponential
backoff; ``wait``/``flush`` take a watchdog timeout; startup sweeps
orphaned ``*.tmp`` files left by a crash between temp-write and the
atomic replace.
"""
from __future__ import annotations

import os
import pickle
import struct
import time
import zlib
from concurrent.futures import Future, InvalidStateError, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.analysis.markers import requires_lock
from repro_torch.analysis.runtime import witness_lock
from repro_torch.core.faults import (FAULTS, ChunkCorruptError, SwapTimeoutError,
                               with_retries)

Key = Tuple[int, Any]              # (ctx_id, chunk_idx | "state")

# pickle-blob envelope: magic, version, reserved, CRC32(payload), length
_MAGIC = b"LLMP"
_VERSION = 1
_PREAMBLE = struct.Struct("<4sHHIQ")


def seal_blob(blob: bytes) -> bytes:
    return _PREAMBLE.pack(_MAGIC, _VERSION, 0, zlib.crc32(blob),
                          len(blob)) + blob


def open_blob(raw: bytes, what: str) -> bytes:
    """Verify the envelope; raises ChunkCorruptError on any mismatch."""
    if len(raw) < _PREAMBLE.size:
        raise ChunkCorruptError(f"{what}: truncated preamble "
                                f"({len(raw)} bytes)")
    magic, ver, _, crc, plen = _PREAMBLE.unpack_from(raw)
    if magic != _MAGIC:
        raise ChunkCorruptError(f"{what}: bad magic {magic!r}")
    if ver != _VERSION:
        raise ChunkCorruptError(f"{what}: unknown version {ver}")
    blob = raw[_PREAMBLE.size:]
    if len(blob) != plen:
        raise ChunkCorruptError(f"{what}: truncated payload "
                                f"({len(blob)} of {plen} bytes)")
    if zlib.crc32(blob) != crc:
        raise ChunkCorruptError(f"{what}: CRC32 mismatch")
    return blob


def sweep_tmp_files(root: str) -> int:
    """Remove orphaned ``*.tmp`` files (a crash between temp-write and
    ``os.replace`` leaves one; it must never be read)."""
    swept = 0
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return 0
    for fn in names:
        if fn.endswith(".tmp"):
            try:
                os.remove(os.path.join(root, fn))
                swept += 1
            except OSError:
                pass
    return swept


class DiskStore:
    """Pickle-per-key chunk store with byte accounting and a checksummed
    file envelope."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.tmp_swept = sweep_tmp_files(root)
        self.delete_errors = 0
        self._bytes: Dict[Key, int] = {}
        self._lock = witness_lock("store.bytes")

    def _path(self, key: Key) -> str:
        ctx, idx = key
        return os.path.join(self.root, f"ctx{ctx}_chunk{idx}.pkl")

    def write(self, key: Key, obj: Any) -> int:
        from repro_torch.core.restore import _throttle, count_io
        FAULTS.check("disk.write", key)
        raw = seal_blob(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        action = FAULTS.corrupt_action(key)
        if action is not None:
            from repro_torch.core.faults import corrupt_file
            corrupt_file(tmp, action)
        os.replace(tmp, self._path(key))          # atomic
        FAULTS.note_write_ok(key)
        count_io("write", len(raw))
        _throttle(len(raw))
        with self._lock:
            self._bytes[key] = len(raw)
        return len(raw)

    def read(self, key: Key) -> Any:
        from repro_torch.core.restore import _throttle, count_io
        FAULTS.check("disk.read", key)
        with open(self._path(key), "rb") as f:
            raw = f.read()
        count_io("read", len(raw))
        _throttle(len(raw))
        return pickle.loads(open_blob(raw, f"state {key}"))

    def delete(self, key: Key):
        try:
            FAULTS.check("disk.delete", key)
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        except OSError:
            # best-effort: a failed delete only leaks a file; the byte
            # accounting below still drops the key
            with self._lock:
                self.delete_errors += 1
        with self._lock:
            self._bytes.pop(key, None)

    def set_bytes(self, key: Key, n: int):
        """Record ``key``'s on-disk size (accounting only — callers that
        write through a path other than ``write()``, e.g. the chunk-file
        envelope writers, report their byte count here)."""
        with self._lock:
            self._bytes[key] = n

    def drop_bytes(self, key: Key):
        with self._lock:
            self._bytes.pop(key, None)

    def nbytes(self, key: Key) -> Optional[int]:
        return self._bytes.get(key)

    @property
    def total_bytes(self) -> int:
        # snapshot under the lock: concurrent writers mutate the dict
        # mid-sum otherwise (RuntimeError / torn totals)
        with self._lock:
            return sum(self._bytes.values())


class AsyncSwapper:
    """AoT swap-out executor + pipelined swap-in reads.

    Worker jobs classify IO errors and retry transient ones with
    bounded exponential backoff (``retries`` attempts per op); counters
    ``io_retries`` / ``io_recovered`` / ``io_failed`` feed the service
    fault stats.  ``on_job_error`` (if set) is invoked with
    ``(key, err)`` when a job exhausts its budget — the residency layer
    uses it to flip into degraded mode on ENOSPC."""

    def __init__(self, store: DiskStore, workers: int = 2,
                 retries: int = 3, retry_base_s: float = 0.002):
        self.store = store
        self.retries = max(1, int(retries))
        self.retry_base_s = retry_base_s
        self.pool = ThreadPoolExecutor(max_workers=workers,
                                       thread_name_prefix="llms-io")
        self._pending: Dict[Key, Future] = {}
        self._lock = witness_lock("swap.pending")
        self._shutdown = False
        self.on_job_error: Optional[Callable[[Key, BaseException],
                                             None]] = None
        self.io_retries = 0
        self.io_recovered = 0
        self.io_failed = 0

    # -- io-stat counters (shared: workers + router fault stats) -------- #
    @requires_lock("_lock")
    def _note_retries_locked(self, tries: int, recovered: bool = False,
                             failed: bool = False):
        self.io_retries += tries
        if recovered:
            self.io_recovered += 1
        if failed:
            self.io_failed += 1

    def note_retry(self):
        """One transient-IO retry observed OUTSIDE a pool job (the
        residency layer's own retry loops report through here)."""
        with self._lock:
            self.io_retries += 1

    def note_io_failure(self):
        """One exhausted-retry failure observed outside a pool job."""
        with self._lock:
            self.io_failed += 1

    # -- retry wrapper (runs ON a pool worker) -------------------------- #
    def _run_job(self, key: Key, fn, args):
        tries = 0

        def _once():
            FAULTS.check("swap.worker", key)
            return fn(*args)

        def _on_retry(_k, _e):
            nonlocal tries
            tries += 1

        try:
            out = with_retries(_once, attempts=self.retries,
                               base_s=self.retry_base_s,
                               on_retry=_on_retry)
        except Exception as e:
            with self._lock:
                self._note_retries_locked(tries, failed=True)
            cb = self.on_job_error
            if cb is not None:
                try:
                    cb(key, e)
                except Exception:
                    pass
            raise
        with self._lock:
            self._note_retries_locked(tries, recovered=bool(tries))
        return out

    @staticmethod
    def _settle(out: Future, f: Future):
        """Copy a finished inner future into ``out``, tolerating an
        ``out`` that shutdown() already cancelled."""
        try:
            err = f.exception()
            if err is not None:
                out.set_exception(err)
            else:
                out.set_result(f.result())
        except InvalidStateError:
            pass

    def submit(self, key: Key, fn, *args) -> Future:
        """Track an arbitrary I/O job under ``key`` so flush() waits.

        Same-key jobs are SERIALIZED (a later write must not be overtaken
        by an earlier in-flight one) but never block the submitting
        thread: the new job is chained onto the previous future via a
        done-callback instead of ``prev.result()``, so AoT swap-out stays
        asynchronous even under same-key write bursts (paper §3.4)."""
        out: Future = Future()
        with self._lock:
            prev = self._pending.get(key)
            self._pending[key] = out

        def _start(_=None):
            if out.cancelled():
                return
            if self._shutdown:
                out.cancel()
                return
            out._llms_started = True
            try:
                inner = self.pool.submit(self._run_job, key, fn, args)
            except RuntimeError as e:              # pool already shut down
                self._settle_err(out, e)
                return
            inner.add_done_callback(lambda f: self._settle(out, f))

        def _done(_):
            with self._lock:
                if self._pending.get(key) is out:
                    del self._pending[key]
        out.add_done_callback(_done)
        if prev is None:
            _start()
        else:
            prev.add_done_callback(_start)         # chain, don't block
        return out

    @staticmethod
    def _settle_err(out: Future, e: BaseException):
        try:
            out.set_exception(e)
        except InvalidStateError:
            pass

    def write_async(self, key: Key, obj: Any) -> Future:
        return self.submit(key, self.store.write, key, obj)

    def read(self, key: Key, timeout: Optional[float] = None) -> Any:
        """Synchronous read; blocks the CALLER (never a pool worker) on
        any in-flight same-key write.  Transient IO errors on the read
        itself are retried with the worker budget."""
        self.wait(key, timeout=timeout)
        tries = 0

        def _on_retry(_k, _e):
            nonlocal tries
            tries += 1
        try:
            out = with_retries(lambda: self.store.read(key),
                               attempts=self.retries,
                               base_s=self.retry_base_s,
                               on_retry=_on_retry)
        finally:
            with self._lock:
                self._note_retries_locked(tries)
        if tries:
            with self._lock:
                self.io_recovered += 1
        return out

    def wait(self, key: Key, timeout: Optional[float] = None):
        """Block the CALLER (never a pool worker) until any in-flight
        same-key job completes.  A failed write surfaces here, like the
        blocking ``read``; a wedged job surfaces as SwapTimeoutError
        once ``timeout`` (the watchdog deadline) expires."""
        with self._lock:
            fut = self._pending.get(key)
        if fut is not None:
            try:
                fut.result(timeout)
            except _FutTimeout:
                raise SwapTimeoutError(
                    f"swap wait exceeded {timeout}s for {key}") from None

    def read_async(self, key: Key) -> Future:
        """Read on the pool, AFTER any in-flight same-key write.

        The read is chained off the pending write future (like same-key
        writes in ``submit``), never submitted as a worker that blocks
        on it: a worker parked in ``fut.result()`` while the chained
        write sits queued behind it deadlocks the pool outright with
        ``workers=1`` (and with N workers, N concurrent blocking reads).
        """
        with self._lock:
            prev = self._pending.get(key)
        if prev is None:
            return self.pool.submit(self._run_job, key, self.store.read,
                                    (key,))
        out: Future = Future()

        def _start(f: Future):
            if out.cancelled():
                return
            if f.cancelled():
                out.cancel()
                return
            werr = f.exception()
            if werr is not None:
                # parity with the blocking ``read`` (whose fut.result()
                # raises): a failed write must surface, not be papered
                # over with whatever stale bytes are on disk
                self._settle_err(out, werr)
                return
            out._llms_started = True
            try:
                inner = self.pool.submit(self._run_job, key,
                                         self.store.read, (key,))
            except RuntimeError as e:              # pool already shut down
                self._settle_err(out, e)
                return
            inner.add_done_callback(lambda g: self._settle(out, g))

        prev.add_done_callback(_start)             # chain, don't block
        return out

    def flush(self, timeout: Optional[float] = None,
              raise_errors: bool = True):
        """Wait for every pending job.  ``timeout`` bounds the TOTAL
        wait (SwapTimeoutError past the deadline); with
        ``raise_errors=False`` failed jobs are swallowed (their errors
        were already counted/classified on the worker)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            futs = list(self._pending.values())
        for f in futs:
            left = None
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise SwapTimeoutError(
                        f"flush exceeded {timeout}s "
                        f"({len(futs)} jobs pending)")
            try:
                f.result(left)
            except _FutTimeout:
                raise SwapTimeoutError(
                    f"flush exceeded {timeout}s") from None
            except Exception:
                if raise_errors:
                    raise

    def shutdown(self, timeout: Optional[float] = None):
        """Flush (bounded by ``timeout``), then CANCEL chained jobs that
        never started rather than orphaning them behind a wedged
        predecessor, and stop the pool."""
        wedged = False
        try:
            self.flush(timeout=timeout, raise_errors=False)
        except SwapTimeoutError:
            wedged = True
        self._shutdown = True
        with self._lock:
            pending = list(self._pending.values())
        for f in pending:
            if not getattr(f, "_llms_started", False):
                f.cancel()
        self.pool.shutdown(wait=not wedged)
