"""Meshes: a rank's coordinate in a named grid over the world, and
``repro``'s production shapes as shape-only meshes.

Port of ``repro/launch/mesh.py``.  ``repro`` builds ``jax.make_mesh``
meshes; the port has no device mesh object, so a :class:`Mesh` here is the
grid's axis names and sizes, this process's coordinate in it, and (for a
step that communicates) the :class:`~repro_torch.pipeline.ranks.RankGroup`
whose per-axis process groups carry the collectives.  The sharding rules
(:mod:`repro_torch.distributed.sharding`) read only ``shape[name]`` and
``axis_names``, as ``repro``'s do (``tests/test_sharding.py``'s
``_FakeMesh`` relies on it), so a shape-only mesh is enough to hold them to
``repro`` at its production sizes without 256 ranks.

Global ranks are laid out row-major over the axes, the last axis fastest,
as ``jax.make_mesh`` lays out its devices; a dim split over several axes is
chunked in mesh-axis order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh", "PRODUCTION_SHAPES"]

#: ``repro``'s production mesh shapes (a pod of 16 x 16, and two of them):
#: the shapes its rules were written for, not a count of H100 cards
PRODUCTION_SHAPES = {
    False: (("data", 16), ("model", 16)),
    True: (("pod", 2), ("data", 16), ("model", 16)),
}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    #: this process's index along each axis; all zeros on a shape-only mesh
    coords: tuple[int, ...] = ()
    #: the rank's group (collectives over the axes); None on a shape-only mesh
    group: Any = None

    def __post_init__(self):
        if not self.coords:
            object.__setattr__(self, "coords", (0,) * len(self.sizes))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def coord(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    def index(self, axes) -> int:
        """This rank's chunk index over ``axes`` (mixed radix, in the given
        order): the chunk a dim split over those axes gives it."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord(a)
        return i


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``repro``'s 16 x 16 ("data", "model") or 2 x 16 x 16 ("pod", "data",
    "model") mesh, as a shape-only mesh (the rules at production sizes)."""
    names, sizes = zip(*PRODUCTION_SHAPES[multi_pod])
    return Mesh(tuple(names), tuple(sizes))


def make_local_mesh(data: int = 1, model: int = 1, group=None) -> Mesh:
    """The ("data", "model") grid over the world, at ``group``'s rank (a
    :class:`~repro_torch.pipeline.ranks.RankGroup` spawned with these axes),
    or shape-only at coordinate 0 without a group (one process)."""
    sizes = (data, model)
    if group is None:
        return Mesh(("data", "model"), sizes)
    if dict(group.axes) != {"data": data, "model": model}:
        raise ValueError(f"the group's axes {dict(group.axes)} are not data={data} x model={model}")
    return Mesh(("data", "model"), sizes, (group.coords["data"], group.coords["model"]), group)
