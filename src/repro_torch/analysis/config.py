"""Repo-specific configuration for the port's analyzer.

This is a REPO-LOCAL tool: precision comes from encoding the stack's
own conventions (attribute names, lock roles, thread entry points)
rather than whole-program type inference.  Everything an operator
might tune lives here as plain data.
"""
from __future__ import annotations

# --------------------------------------------------------------------- #
# attribute-name -> class map.  The stack wires layers together through
# a fixed set of attribute names (DESIGN.md §1); the checkers use this
# to resolve `self.store.write(...)`-style cross-class calls and lock
# expressions like `with self.store._lock`.
# --------------------------------------------------------------------- #
ATTR_TYPES = {
    "store": "DiskStore",
    "swapper": "AsyncSwapper",
    "res": "ResidencyEngine",
    "svc": "LLMService",
    "mem": "MemoryManager",
    "ctxs": "ContextStore",
    "exe": "ModelExecutor",
    "router": "ServiceRouter",
    # NOT "pool": ThreadPoolExecutor in AsyncSwapper, PagePool in
    # ResidencyEngine — ambiguous by design, so left unresolved.
}

# --------------------------------------------------------------------- #
# Coarse locks: held across entire service slices BY DESIGN (the
# router's `_svc_lock` serializes ALL service access, including disk
# reads and model execution on the card — that serialization IS the engine's
# concurrency model, DESIGN.md §2).  Exempt from blocking-under-lock.
# --------------------------------------------------------------------- #
COARSE_LOCKS = {
    "ServiceRouter._svc_lock",
}

# --------------------------------------------------------------------- #
# Blocking-call registry (rule lock/blocking-under-lock).  Matching is
# structural: `attr` matches any `<recv>.<attr>(...)` call (optionally
# constrained to receivers whose chain mentions one of `recv`);
# `name` matches a bare `name(...)` call.  The reference finds its
# jitted entry points by a `*_fn` suffix; the port has no jitted
# functions, and its counterpart is `ModelExecutor`'s own entry points,
# each on the receiver `exe`: they run the model on the card, and
# `sync` waits for it.  Entries with `allow_held` are permitted when
# the receiver IS a lock currently held — `self._cv.wait()` inside
# `with self._cv` releases the lock while blocked (the Condition
# protocol), so it cannot hold anything up.
# --------------------------------------------------------------------- #
BLOCKING_CALLS = [
    {"attr": "result", "why": "Future.result() blocks"},
    {"attr": "wait", "allow_held": True,
     "why": "blocking wait (Future/Event/AsyncSwapper)"},
    {"attr": "wait_for", "allow_held": True,
     "why": "Condition.wait_for blocks"},
    {"attr": "flush", "why": "AsyncSwapper.flush waits on all pending IO"},
    {"attr": "join", "not_recv": ("path", "os"),
     "why": "thread join blocks"},
    {"attr": "sleep", "why": "sleep under a lock stalls every waiter"},
    {"attr": "read", "recv": ("store", "swapper"),
     "why": "disk read (DiskStore/AsyncSwapper) under a lock"},
    {"attr": "write", "recv": ("store",),
     "why": "disk write (DiskStore) under a lock"},
    {"attr": "delete", "recv": ("store",),
     "why": "disk delete (DiskStore) under a lock"},
    {"name": "write_chunk_file", "why": "chunk-file IO under a lock"},
    {"name": "read_chunk_file", "why": "chunk-file IO under a lock"},
    {"name": "verify_chunk_file", "why": "chunk-file IO under a lock"},
    {"name": "with_retries",
     "why": "retry loop sleeps between attempts"},
] + [
    {"attr": entry, "recv": ("exe",),
     "why": "ModelExecutor runs the model on (or waits for) the card "
            "under a lock"}
    for entry in ("recompute", "recompute_whole", "extend_nod", "extend",
                  "decode", "run_pipelined", "paged_extend", "paged_decode",
                  "sync", "logits")
]

# Subset that is ALSO forbidden inside worker-pool job bodies and
# done-callbacks (rule lock/blocking-in-worker — the pool
# self-deadlock class: a pool worker parked in `fut.result()` while the job that
# would resolve it sits queued behind it).  Disk IO is fine on a
# worker (that's its job); synchronizing on OTHER pool work is not.
WORKER_BLOCKING = [
    {"attr": "result", "why": "worker parked in Future.result() "
     "deadlocks the pool (pool self-deadlock class)"},
    {"attr": "wait", "allow_held": True,
     "why": "worker blocking on AsyncSwapper/Future wait"},
    {"attr": "flush", "why": "worker waiting on all pending IO"},
    {"attr": "join", "not_recv": ("path", "os"),
     "why": "worker joining a thread"},
]

# --------------------------------------------------------------------- #
# Thread-shared-state audit (rule shared/unguarded-shared-write).
#
# Worker entries: functions that RUN on non-dispatcher threads — pool
# job bodies (AsyncSwapper submits `DiskStore.write/read/delete` and
# the chunk-file IO functions as jobs), done-callbacks, and thread
# targets.  Functions passed to `.submit(...)`, `.add_done_callback(..)`
# and `threading.Thread(target=...)` are discovered automatically; this
# list seeds the entries that only dynamic dispatch reaches.
# --------------------------------------------------------------------- #
WORKER_ENTRIES = [
    "AsyncSwapper._run_job",
    "DiskStore.write",
    "DiskStore.read",
    "DiskStore.delete",
    "write_chunk_file",
    "read_chunk_file",
    "verify_chunk_file",
    "count_io",
    "LayerFeed._run",
    # AsyncSwapper.on_job_error callback: ResidencyEngine wires
    # `swapper.on_job_error = self._on_io_error` — invoked from a pool
    # worker when a job exhausts its retry budget
    "ResidencyEngine._on_io_error",
]

# Reader entries: the router/dispatcher side — everything reachable
# from the service surface plus the loadgen driver hooks and report
# builders (the stats snapshot-race class).
READER_ENTRY_PREFIXES = [
    "ServiceRouter.",
    "AppSession.",
    "LLMService.",
    "ResidencyEngine.",
    "GenerationStream.",
    "EventLog.",
]
READER_ENTRIES = [
    "run_scenario",
    "replay_trace",
    "build_report",
    "io_counters",
]

# (class-or-module, attribute) -> one-line justification.  Every entry
# is an AUDITED decision: either a proven happens-before exists, or a
# torn read is harmless by design.  New unguarded shared writes that
# are NOT here (and not baselined) fail the clean-tree test.
SHARED_STATE_ALLOWLIST = {
    ("AsyncSwapper", "_shutdown"):
        "monotonic latch, flipped once after flush(); a stale read "
        "only delays a cancel by one callback hop",
    ("AsyncSwapper", "on_job_error"):
        "wired once in ResidencyEngine.__init__ before any IO is "
        "submitted; never reassigned while workers run",
    ("LayerFeed", "_error"):
        "written by the IO thread before the per-layer Event.set(); "
        "readers check it only after Event.wait() (happens-before)",
    ("ResidencyEngine", "degraded"):
        "reads are racy ON PURPOSE: a stale False admits one more "
        "write that fails identically; writes are lock-serialized",
    ("ResidencyEngine", "aot_enabled"):
        "same monotonic-flag pattern as `degraded` (common writer "
        "lock; racy reads shed at most one extra flush)",
    # loadgen tier (stats snapshot-race class): the
    # scenario driver runs the router INLINE (start=False), so every
    # hook (on_begin/on_round/on_preempt/on_complete), the virtual
    # clock, and the event log execute on the pump thread — there is
    # no second scheduler thread to race.  The only cross-thread
    # traffic is the swap tier's, which `io_counters()` reads under
    # `_IO_LOCK` and `DiskStore.total_bytes` sums under `_lock`.
    ("EventLog", "n"):
        "driver runs the router inline (start=False): hooks and log "
        "are single-threaded by construction",
    ("EventLog", "lines"):
        "same single-threaded-driver argument as EventLog.n",
    ("VirtualClock", "t"):
        "advanced only from driver hooks on the pump thread; the "
        "virtual clock never crosses threads",
    ("repro_torch.core.restore", "_BW"):
        "bench-setup throttle knob, set before the workload starts; "
        "never written concurrently with IO",
    ("repro_torch.core.restore", "_LAT"):
        "same bench-setup argument as _BW",
    # filled at first use by `_zero`, whose only callers are `__init__`
    # and `fresh_cache`; every caller of `fresh_cache`
    # (LLMService._condense, ResidencyEngine.switch_in /
    # profile_pipeline) is @requires_serialized, so the router thread
    # reaches it only under `_svc_lock` (through `_start_job`)
    ("ModelExecutor", "_zero_cache"):
        "filled once, on the serialized surface only: every caller "
        "of fresh_cache is @requires_serialized (under _svc_lock or "
        "an inline driver's only thread)",
    # made once by `init_slots`, whose callers are
    # `ResidencyEngine.__init__` (before any service or router thread
    # exists) and `fresh_cache` (the serialized surface, as above)
    ("ModelExecutor", "_slots"):
        "made once, before the service's threads start or on the "
        "serialized surface: init_slots is called by "
        "ResidencyEngine.__init__ and fresh_cache only",
    ("ModelExecutor", "eager_calls"):
        "a counter of the entries run on private caches; the model "
        "entries run on the serialized surface only (the router "
        "serializes every service call)",
}

# --------------------------------------------------------------------- #
# Serialized-surface entry points (rule lock/serialized-call): callers
# allowed to invoke @requires_serialized methods WITHOUT holding
# `_svc_lock`, because they own the only thread that ever touches the
# service (single-threaded scripts, inline drivers, fixtures).
# --------------------------------------------------------------------- #
SERIALIZED_CALLER_ALLOWLIST = {
    # loadgen drivers run the router inline (start=False): the pump
    # loop IS the dispatcher thread, no second service thread exists
    "run_scenario",
    "replay_trace",
    # single-threaded setup/launch entry points: they touch the service
    # before any worker or router thread has been started
    "main",
    "build_service",
}

# --------------------------------------------------------------------- #
# jit discipline
# --------------------------------------------------------------------- #
# host-side-effect roots forbidden inside functions passed to jax.jit
JIT_HOST_CALL_NAMES = {"print", "open", "input"}
JIT_HOST_CALL_ROOTS = {"time", "os", "FAULTS", "random"}
JIT_HOST_CALL_CHAINS = {("np", "random"), ("numpy", "random")}
# names treated as jit-cache accessors for key-hashability checking
JIT_CACHE_NAME_HINT = "cache"
# the port's counterpart of jax.jit: the helper every CUDA-graph body
# of core/graphs.py goes through (``capturable(body)``); J1 and J2 read
# the bodies handed to it as they read jax.jit's traced functions
GRAPH_CAPTURE_HELPERS = {"capturable"}
# host syncs forbidden inside a graph body besides the host calls above:
# a tensor method that copies to the host, and a Python number of a
# tensor (``int(x)``, ``float(x)``, ``bool(x)``); each breaks the capture
# or bakes one call's value into the graph
GRAPH_HOST_SYNC_ATTRS = {"item", "cpu", "numpy", "tolist"}
GRAPH_HOST_SYNC_NAMES = {"int", "float", "bool"}

# --------------------------------------------------------------------- #
# family dispatch (rule family/string-dispatch)
# --------------------------------------------------------------------- #
# The ONLY places allowed to compare `.family` strings: the registry
# (maps family name -> model class), the spec module itself, and the
# model/config constructors that declare each family's KVSpec.  Engine
# code must consume the declarative spec, never the family string —
# the KVSpec redesign exists to keep capability knowledge out of the
# executor/residency layers (the old executor gates are preserved as
# the fixtures/family_dispatch.py reproduction).
FAMILY_DISPATCH_ALLOWED_FILES = {
    "src/repro_torch/models/registry.py",
    "src/repro_torch/models/kvspec.py",
    # the port's own converter from the reference's parameter trees,
    # whose stacks are laid out per family: keyed by family as the
    # registry is, and read by no engine code
    "src/repro_torch/models/convert.py",
    # the dry run's model-FLOPs count (``model_flops``): a formula of the
    # dense family's layer shapes, which it declines for any other
    # family; a measurement, read by no engine code
    "src/repro_torch/launch/dryrun.py",
}
FAMILY_DISPATCH_ALLOWED_PREFIXES = (
    "src/repro_torch/configs/",    # arch tables keyed by family name
)
