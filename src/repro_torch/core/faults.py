"""Deterministic, seeded failpoint registry for the storage tier.

LLMS is a *system service*: the flash path the paper swaps KV chunks
through is slow, contended and occasionally fails (full disk, torn
writes under power events, transient EIO).  This module lets the test
suite and the loadgen scenarios inject those faults at the real call
sites (``DiskStore.read/write/delete``, ``AsyncSwapper`` worker bodies,
``PagePool`` admission) with REPLAYABLE draws, so fault runs stay under
the harness determinism contract (DESIGN.md §5).

Determinism: a fault decision is a pure hash of
``(seed, kind, site, key, op#)`` where ``op#`` is a per-(site, key)
operation counter.  Same-key storage ops are serialized by
``AsyncSwapper`` and issued from the single dispatcher thread, so the
per-key op sequence — and therefore every draw — is identical across
same-seed runs regardless of IO-thread interleaving.  (A shared RNG
stream would NOT survive thread scheduling.)

Fault kinds
    transient_eio    op fails ``fail_n`` consecutive attempts, then heals
                     (bounded retry always succeeds)
    persistent_eio   key fails until a successful rewrite replaces it
    enospc           writes fail with ENOSPC (also forced globally via
                     ``set_disk_full`` for scenario windows)
    torn_write       file is truncated after the temp write (detected by
                     the checksum preamble on read)
    bit_flip         one payload byte is flipped (detected by CRC32)
    slow_io          the op sleeps ``lat_s`` before proceeding

Sites: ``disk.read``, ``disk.write``, ``disk.delete``, ``swap.worker``,
``pool.admit``.
"""
from __future__ import annotations

import errno
import hashlib
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Set, Tuple

from repro_torch.analysis.markers import requires_lock
from repro_torch.analysis.runtime import witness_lock

KINDS = ("transient_eio", "persistent_eio", "enospc", "torn_write",
         "bit_flip", "slow_io")
SITES = ("disk.read", "disk.write", "disk.delete", "swap.worker",
         "pool.admit")
_WRITE_SITES = ("disk.write",)
_IO_SITES = ("disk.read", "disk.write", "swap.worker")


# --------------------------------------------------------------------- #
# failure taxonomy (DESIGN.md §6): detection exceptions
# --------------------------------------------------------------------- #
class TransientIOError(OSError):
    """Injected EIO that heals after ``fail_n`` attempts (retryable)."""

    def __init__(self, msg: str):
        super().__init__(errno.EIO, msg)


class PersistentIOError(OSError):
    """Injected EIO that persists until the key is rewritten.  A caller
    cannot distinguish it from a transient one — the bounded retry
    budget does (it exhausts, and recovery falls back to recompute)."""

    def __init__(self, msg: str):
        super().__init__(errno.EIO, msg)


class DiskFullError(OSError):
    """Injected ENOSPC on the write path (degraded-mode trigger)."""

    def __init__(self, msg: str):
        super().__init__(errno.ENOSPC, msg)


class ChunkCorruptError(RuntimeError):
    """A chunk/state file failed checksum/structure verification.  NOT
    retryable (re-reading returns the same bytes) — recovery must
    recompute from tokens (paper §3.3's IO-Recompute lever)."""


class SwapTimeoutError(TimeoutError):
    """A swap wait exceeded the watchdog deadline; the router converts
    it into a preemption instead of a wedged engine."""


@dataclass(frozen=True)
class FaultSpec:
    """One fault stream: ``kind`` drawn at ``rate`` on ``sites``."""
    kind: str
    sites: Tuple[str, ...]
    rate: float
    fail_n: int = 1          # transient_eio: consecutive failing attempts
    lat_s: float = 0.0       # slow_io: injected latency


def canon_key(key: Any) -> str:
    """Canonical per-key identity for draw counters: tuple store keys
    map to ``ctx:idx``; path-level ops use the file's basename (stable
    across the temp dir) minus any ``.tmp`` suffix."""
    if isinstance(key, tuple):
        return ":".join(str(k) for k in key)
    s = os.path.basename(str(key))
    return s[:-4] if s.endswith(".tmp") else s


class FaultRegistry:
    """Process-global injection state.  Inactive (no plan installed and
    disk not forced full) ⇒ every hook is a cheap no-op."""

    def __init__(self):
        self._lock = witness_lock("faults.registry")
        self._specs: Tuple[FaultSpec, ...] = ()
        self._seed = 0
        self._ops: Dict[Tuple[str, str], int] = {}
        self._transient: Dict[Tuple[str, str], int] = {}  # remaining fails
        self._persistent: Set[str] = set()                # keys gone bad
        self._disk_full = False
        self.injected: Dict[str, int] = {}

    # -- lifecycle ----------------------------------------------------- #
    def install(self, specs, seed: int):
        """Install a plan, resetting ALL draw state so same-seed runs
        replay identically."""
        for s in specs:
            if s.kind not in KINDS:
                raise ValueError(f"unknown fault kind {s.kind!r}")
            for site in s.sites:
                if site not in SITES:
                    raise ValueError(f"unknown fault site {site!r}")
        with self._lock:
            self._specs = tuple(specs)
            self._seed = int(seed)
            self._ops.clear()
            self._transient.clear()
            self._persistent.clear()
            self._disk_full = False
            self.injected = {}

    def clear(self):
        self.install((), 0)

    @property
    def active(self) -> bool:
        return bool(self._specs) or self._disk_full

    def set_disk_full(self, on: bool):
        """Force ENOSPC on every write (scenario disk-full windows)."""
        with self._lock:
            self._disk_full = bool(on)

    @property
    def disk_full(self) -> bool:
        return self._disk_full

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            inj = dict(self.injected)
        return {"injected": inj, "injected_total": sum(inj.values())}

    # -- draws ---------------------------------------------------------- #
    def _u(self, kind: str, site: str, keystr: str, n: int) -> float:
        h = hashlib.blake2b(
            f"{self._seed}|{kind}|{site}|{keystr}|{n}".encode(),
            digest_size=8).digest()
        return int.from_bytes(h, "big") / float(1 << 64)

    @requires_lock("_lock")
    def _count(self, kind: str):
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def check(self, site: str, key: Any):
        """Failpoint: called at the top of one storage/pool operation.
        Raises the drawn fault (after any slow-IO sleep) or returns."""
        if not self.active:
            return
        keystr = canon_key(key)
        sleep_s = 0.0
        err: Optional[Exception] = None
        with self._lock:
            n = self._ops.get((site, keystr), 0)
            self._ops[(site, keystr)] = n + 1
            if self._disk_full and site in _WRITE_SITES:
                self._count("enospc")
                err = DiskFullError(f"disk full: {site} {keystr}")
            for spec in self._specs:
                if err is not None:
                    break
                if site not in spec.sites:
                    continue
                if spec.kind == "slow_io":
                    if self._u("slow_io", site, keystr, n) < spec.rate:
                        self._count("slow_io")
                        sleep_s += spec.lat_s
                elif spec.kind == "transient_eio":
                    left = self._transient.get((site, keystr), 0)
                    if left > 0:
                        self._transient[(site, keystr)] = left - 1
                        self._count("transient_eio")
                        err = TransientIOError(
                            f"transient EIO: {site} {keystr}")
                    elif self._u("transient_eio", site, keystr,
                                 n) < spec.rate:
                        self._transient[(site, keystr)] = spec.fail_n - 1
                        self._count("transient_eio")
                        err = TransientIOError(
                            f"transient EIO: {site} {keystr}")
                elif spec.kind == "persistent_eio":
                    if keystr in self._persistent:
                        self._count("persistent_eio")
                        err = PersistentIOError(
                            f"persistent EIO: {site} {keystr}")
                    elif self._u("persistent_eio", site, keystr,
                                 n) < spec.rate:
                        self._persistent.add(keystr)
                        self._count("persistent_eio")
                        err = PersistentIOError(
                            f"persistent EIO: {site} {keystr}")
                elif spec.kind == "enospc" and site in _WRITE_SITES:
                    if self._u("enospc", site, keystr, n) < spec.rate:
                        self._count("enospc")
                        err = DiskFullError(f"ENOSPC: {site} {keystr}")
        if sleep_s:
            time.sleep(sleep_s)
        if err is not None:
            raise err

    def corrupt_action(self, key: Any) -> Optional[str]:
        """Post-write corruption draw: ``"torn"`` | ``"bit_flip"`` |
        None.  Separate counter stream from ``check`` so adding
        corruption faults never perturbs error draws."""
        if not self._specs:
            return None
        keystr = canon_key(key)
        with self._lock:
            n = self._ops.get(("corrupt", keystr), 0)
            self._ops[("corrupt", keystr)] = n + 1
            for spec in self._specs:
                if spec.kind == "torn_write" and \
                        self._u("torn_write", "corrupt", keystr,
                                n) < spec.rate:
                    self._count("torn_write")
                    return "torn"
                if spec.kind == "bit_flip" and \
                        self._u("bit_flip", "corrupt", keystr,
                                n) < spec.rate:
                    self._count("bit_flip")
                    return "bit_flip"
        return None

    def note_write_ok(self, key: Any):
        """A successful rewrite replaces the bad disk copy: clear any
        persistent mark so the new file is readable."""
        if not self._specs:
            return
        with self._lock:
            self._persistent.discard(canon_key(key))


FAULTS = FaultRegistry()


def install_faults(specs, seed: int):
    FAULTS.install(specs, seed)


def clear_faults():
    FAULTS.clear()


def set_disk_full(on: bool):
    FAULTS.set_disk_full(on)


def fault_counters() -> Dict[str, Any]:
    return FAULTS.counters()


def corrupt_file(path: str, action: str):
    """Apply a drawn corruption to a file on disk (used on the temp
    file just before the atomic replace, and by tests directly)."""
    size = os.path.getsize(path)
    if action == "torn":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    elif action == "bit_flip":
        # flip a byte in the back half: past the preamble, inside the
        # checksummed region, position derived from the size so it is
        # deterministic
        pos = size // 2 + size % 7
        with open(path, "r+b") as f:
            f.seek(min(pos, size - 1))
            b = f.read(1)
            f.seek(min(pos, size - 1))
            f.write(bytes([b[0] ^ 0x40]))
    else:
        raise ValueError(f"unknown corruption {action!r}")


# --------------------------------------------------------------------- #
# retry/backoff classification (recovery ladder step 1, DESIGN.md §6)
# --------------------------------------------------------------------- #
def retryable(err: BaseException) -> bool:
    """Transient-vs-terminal classification for the retry loop.

    Corrupt bytes re-read identically ⇒ not retryable; ENOSPC retries
    cannot free space ⇒ not retryable (degrade instead); a missing file
    stays missing ⇒ not retryable.  Everything else OSError (EIO et
    al.) is worth the bounded budget — persistent EIO simply exhausts
    it and falls through to recompute."""
    if isinstance(err, (ChunkCorruptError, FileNotFoundError)):
        return False
    if isinstance(err, OSError):
        return err.errno != errno.ENOSPC
    return False


def with_retries(fn: Callable[[], Any], attempts: int = 3,
                 base_s: float = 0.002,
                 on_retry: Optional[Callable[[int, BaseException],
                                             None]] = None) -> Any:
    """Run ``fn`` with bounded exponential backoff on retryable errors."""
    k = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if k + 1 >= attempts or not retryable(e):
                raise
            if on_retry is not None:
                on_retry(k, e)
            time.sleep(base_s * (2 ** k))
            k += 1


# --------------------------------------------------------------------- #
# scenario-config -> plan
# --------------------------------------------------------------------- #
_RATE_KEYS = ("transient_eio", "persistent_eio", "enospc", "torn_write",
              "bit_flip", "slow_io", "pool_admit")
_META_KEYS = ("seed", "fail_n", "slow_io_s", "disk_full_windows",
              "swap_deadline_s")


def plan_from_config(cfg: Mapping[str, Any],
                     default_seed: int) -> Tuple[List[FaultSpec], int]:
    """Build (specs, seed) from a scenario ``faults`` mapping.  Keys are
    per-kind rates plus ``fail_n``/``slow_io_s``/``seed``; unknown keys
    fail loudly (same contract as the spec loader)."""
    unknown = set(cfg) - set(_RATE_KEYS) - set(_META_KEYS)
    if unknown:
        raise ValueError(f"unknown fault config keys: {sorted(unknown)}")
    fail_n = int(cfg.get("fail_n", 1))
    lat = float(cfg.get("slow_io_s", 0.001))
    specs: List[FaultSpec] = []
    for kind in ("transient_eio", "persistent_eio", "slow_io"):
        rate = float(cfg.get(kind, 0.0))
        if rate > 0:
            specs.append(FaultSpec(kind=kind, sites=_IO_SITES, rate=rate,
                                   fail_n=fail_n, lat_s=lat))
    if float(cfg.get("enospc", 0.0)) > 0:
        specs.append(FaultSpec(kind="enospc", sites=_WRITE_SITES,
                               rate=float(cfg["enospc"])))
    for kind in ("torn_write", "bit_flip"):
        rate = float(cfg.get(kind, 0.0))
        if rate > 0:
            specs.append(FaultSpec(kind=kind, sites=_WRITE_SITES,
                                   rate=rate))
    if float(cfg.get("pool_admit", 0.0)) > 0:
        specs.append(FaultSpec(kind="transient_eio", sites=("pool.admit",),
                               rate=float(cfg["pool_admit"]),
                               fail_n=fail_n))
    seed = cfg.get("seed")
    return specs, int(default_seed if seed is None else seed)
