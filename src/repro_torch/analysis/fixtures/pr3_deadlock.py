"""Reproduction of the AsyncSwapper pool self-deadlock (fixed in the
real tree): a single-worker pool job body blocks in ``prev.result()``
waiting for a future whose job is QUEUED BEHIND the very worker doing
the waiting.  The analyzer must flag the ``result()`` call inside the
submitted body as ``lock/blocking-in-worker``.

This module is a fixture: syntactically valid, never imported by the
engine, structurally faithful to the original bug.
"""
import threading
from concurrent.futures import ThreadPoolExecutor


class BadSwapper:
    """Same-key write chaining done WRONG: the dependency wait happens
    inside the pool instead of via ``add_done_callback`` chaining."""

    def __init__(self):
        self.pool = ThreadPoolExecutor(max_workers=1)
        self._lock = threading.Lock()
        self._pending = {}

    def submit(self, key, payload):
        with self._lock:
            prev = self._pending.get(key)

            def job():
                if prev is not None:
                    # BUG: this runs ON the single pool worker;
                    # if prev's job hasn't started yet it never will,
                    # because the only worker is parked right here.
                    prev.result()
                return self._do_write(key, payload)

            fut = self.pool.submit(job)
            self._pending[key] = fut
            return fut

    def _do_write(self, key, payload):
        return (key, len(payload))
