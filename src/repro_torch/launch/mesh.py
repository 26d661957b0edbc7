"""The production mesh, as a description.

Single pod: 16 x 16 = 256 chips, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 chips, axes ("pod", "data", "model"); the
"pod" axis composes with "data" for batch and context sharding and the
gradient reduction, "model" stays inside a pod.

The port's copy of the JAX package's ``launch/mesh.py`` without its two
factories, ``make_production_mesh`` and ``make_debug_mesh``: they build
a ``jax.sharding.Mesh`` over 256 or 512 devices (or the local ones) in
one process, and one card is one device.  What the dry run needs of the
mesh is its shape and axis names (``production_mesh``), which data axes
the batch shards over (``data_axes``); ``sharding/rules.py`` keeps each
axis's size in ``AXIS_SIZE``, which a test holds equal to these shapes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple


class MeshShape(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"): a description, holding no device."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


def data_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)
