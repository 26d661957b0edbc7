"""Annotation markers and the runtime lock-order witness, copied from
the JAX package's ``analysis/markers.py`` and ``analysis/runtime.py``
(the static analyzer itself is not ported yet: ``ROADMAP.md``)."""
from repro_torch.analysis.markers import requires_lock, requires_serialized

__all__ = ["requires_lock", "requires_serialized"]
