"""Static annotation markers consumed by ``repro_torch.analysis``.

Zero-cost at runtime (plain attribute tags); dependency-free so every
core module can import them.  The analyzer reads the DECORATOR SYNTAX
via AST — the runtime attributes exist only so tooling/tests can
introspect live objects.
"""
from typing import Any, Callable, TypeVar

F = TypeVar("F", bound=Callable[..., Any])


def requires_lock(lockname: str) -> Callable[[F], F]:
    """Declare that a function must only run with ``lockname`` held.

    ``lockname`` is the attribute name of the owning lock — ``"_lock"``
    / ``"_cv"`` for instance locks on ``self``, or a module-global name
    (``"_IO_LOCK"``) for module-level functions.  The lock checker
    enforces every call site: lexically inside ``with self.<lockname>``
    (or the module-level ``with <lockname>``), or from another method
    of the same class carrying the same marker / the ``*_locked``
    naming convention.
    """
    def deco(fn: F) -> F:
        fn.__llms_requires_lock__ = lockname
        return fn
    return deco


def requires_serialized(fn: F) -> F:
    """Declare that a function runs only on the dispatcher — i.e. under
    ``ServiceRouter._svc_lock``, the coarse lock that serializes ALL
    service access (DESIGN.md §2).

    The lock checker enforces call sites: from another serialized
    function, from a method holding ``_svc_lock`` (lexically or via
    ``@requires_lock("_svc_lock")``), or from an allowlisted
    single-threaded entry point (``analysis.config``).
    """
    fn.__llms_serialized__ = True
    return fn
