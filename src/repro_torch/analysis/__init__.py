"""Concurrency & jit discipline analyzer of the PyTorch/CUDA port.

The port runs the reference's concurrency design: the router thread
(``ServiceRouter._loop``) serving under ``_svc_lock``, the
``AsyncSwapper`` pool, ``LayerFeed``'s I/O thread and ahead-of-time
(AoT) chunk writes.  This package checks that design in the port's own
tree with the reference's rules, as STATIC rules over the source (AST
only, stdlib only — run ``python -m repro_torch.analysis``), plus a
runtime complement (``analysis.runtime``: a lock-order witness,
zero-cost unless ``LLMS_LOCK_WITNESS=1``).

Checkers (DESIGN.md "Concurrency invariants"):

``lock``    lock-discipline: ``*_locked`` / ``@requires_lock`` methods
            must be called with the owning lock held;
            ``@requires_serialized`` ones only on the dispatcher
            surface; blocking operations (Future.result/wait,
            AsyncSwapper.wait/flush, DiskStore IO, ``ModelExecutor``
            entry points and ``sync``, time.sleep) must not run under
            a narrow lock; worker-pool job bodies must never
            synchronize on pool futures (the pool self-deadlock
            class); chunk-file reads must be ordered behind in-flight
            same-key AoT writes (the restore-vs-AoT race class).
``jit``     jit-cache keys must be hashable content fingerprints —
            never ``id(...)``; a CUDA-graph body handed to
            ``core/graphs.capturable`` (as a function handed to
            ``jax.jit``) closes over no ``self`` and makes no host call
            or host sync.
``shared``  attributes written by worker-thread-reachable code and
            touched from router/dispatcher code must be written under
            a lock or appear in the audited allowlist
            (``analysis.config.SHARED_STATE_ALLOWLIST``).
``family``  no ``.family`` string comparisons outside the registry,
            the configs and the parameter converter.

Findings diff against the committed ``analysis/baseline.json`` (empty:
the port's tree is clean) — grandfathered fingerprints don't block,
new ones do.  The root ``analysis_baseline.json`` is the reference's.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.markers import requires_lock, requires_serialized

__all__ = ["Finding", "requires_lock", "requires_serialized"]
