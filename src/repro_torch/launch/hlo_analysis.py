"""Roofline terms of one rank's program: its collectives, priced on the wire.

The port's counterpart of ``repro/launch/hlo_analysis.py``.  ``repro``
parses XLA's optimized HLO, in which GSPMD has placed every collective; the
port has no HLO.  Its collectives are calls the program makes itself, all
through a :class:`~repro_torch.pipeline.ranks.RankGroup`:
``all_reduce_over``, ``all_gather_over`` and ``reduce_scatter_over`` (from
``distributed/sharding.py``'s ``gather`` and ``reduce_scatter``,
``distributed/tensor_parallel.py``'s products and the sharded steps), and
point to point, ``exchange`` and ``all_reduce_sum`` (the pipeline engine).
So the twin of ``analyze_hlo``'s collective half is a recorder on that
surface:

* :class:`CollectiveRecorder` wraps a group (a real one, so that a real
  step records; or a :class:`DryGroup`, which moves nothing and returns
  outputs of the right shape) and logs one :class:`CollectiveEntry` per
  logical call: kind, axes, group size, shape, dtype and dim, before the
  group splits a large leaf into pieces, so that a real run and a dry run
  log the same list.  A call over a group of one rank moves nothing and is
  not logged (XLA emits no collective for it either).
* :func:`analyze` prices a log by ``repro``'s ring rules, per device
  (``g`` the group size)::

    all-gather          (g-1)/g · result_bytes
    reduce-scatter      (g-1)   · result_bytes      (input = g · result)
    all-reduce          2 · (g-1)/g · result_bytes  (RS + AG phases)
    collective-permute  result_bytes                (a point-to-point send)

  A receive is logged (the lists of two runs then match transfer for
  transfer) but not priced: its bytes are its sender's.

FLOPs and HBM bytes come from :func:`repro_torch.launch.op_counts.count_ops`
(matrix products at 2 · |result| · |contracted|, and eager PyTorch's
kernel-boundary traffic).  ``analyze_hlo``'s text parser has no twin: the
port has no HLO to parse.

:func:`roofline_terms` is ``repro``'s formula.  Its peaks come from a
:class:`~repro_torch.core.devicespec.DeviceSpec`, by default
``specs/h100-sxm.json`` (the compute dtype's peak, the HBM bandwidth, the
link bandwidth), never from ``repro``'s TPU constants.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any

import torch

__all__ = [
    "HloAnalysis",
    "CollectiveEntry",
    "CollectiveRecorder",
    "DryGroup",
    "analyze",
    "ring_wire_bytes",
    "roofline_terms",
]


@dataclasses.dataclass
class HloAnalysis:
    """``repro``'s record of one program, per device."""

    flops: float = 0.0  # matrix-product FLOPs
    hbm_bytes: float = 0.0  # kernel-boundary traffic
    wire_bytes: float = 0.0  # collective bytes on the links
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    dot_count: int = 0

    def add_collective(self, kind: str, nbytes: float, mult: float) -> None:
        self.wire_bytes += nbytes * mult
        self.collective_counts[kind] = self.collective_counts.get(kind, 0) + mult
        self.collective_bytes_by_kind[kind] = self.collective_bytes_by_kind.get(kind, 0.0) + nbytes * mult


def ring_wire_bytes(kind: str, result_bytes: float, g: int) -> float:
    """Bytes one device puts on the wire for a collective of ``g`` ranks
    whose result is ``result_bytes`` (``repro``'s ring rules)."""
    frac = (g - 1) / g
    return {
        "all-gather": frac * result_bytes,
        "reduce-scatter": (g - 1) * result_bytes,
        "all-reduce": 2.0 * frac * result_bytes,
        "all-to-all": frac * result_bytes,
        "collective-permute": result_bytes,
    }[kind]


@dataclasses.dataclass(frozen=True)
class CollectiveEntry:
    """One logical collective call: ``shape`` and ``dtype`` are the operand's
    (the caller's tensor), ``dtype`` of a reduce-scatter the one it sums in;
    ``peer`` the other stage of a point-to-point transfer."""

    kind: str  # all-gather | reduce-scatter | all-reduce | collective-permute | recv
    axes: tuple[str, ...]
    group_size: int
    shape: tuple[int, ...]
    dtype: str
    dim: int | None = None
    peer: int | None = None

    @property
    def operand_bytes(self) -> int:
        return math.prod(self.shape) * getattr(torch, self.dtype).itemsize

    @property
    def result_bytes(self) -> float:
        if self.kind == "all-gather":
            return self.operand_bytes * self.group_size
        if self.kind == "reduce-scatter":
            return self.operand_bytes / self.group_size
        return self.operand_bytes

    @property
    def wire_bytes(self) -> float:
        if self.kind == "recv":
            return 0.0
        return ring_wire_bytes(self.kind, self.result_bytes, self.group_size)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def analyze(entries, flops: float = 0.0, hbm_bytes: float = 0.0, dot_count: int = 0) -> HloAnalysis:
    """An :class:`HloAnalysis` of a program's counts and its collective log."""
    out = HloAnalysis(flops=float(flops), hbm_bytes=float(hbm_bytes), dot_count=dot_count)
    for e in entries:
        if e.kind != "recv":
            out.add_collective(e.kind, e.wire_bytes, 1)
    return out


def _axes_size(mesh_axes: tuple, axes) -> int:
    """The ranks a collective over ``axes`` spans on a mesh of ``mesh_axes``
    (``((name, size), ...)``)."""
    sizes = dict(mesh_axes)
    unknown = [a for a in axes if a not in sizes]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; the mesh has {mesh_axes}")
    return math.prod(sizes[a] for a in set(axes))


class _DryRecv:
    def __init__(self, shape, dtype, device):
        self._shape, self._dtype, self._device = shape, dtype, device

    def wait(self) -> torch.Tensor:
        return torch.empty(self._shape, dtype=self._dtype, device=self._device)


@dataclasses.dataclass(eq=False)
class DryGroup:
    """A rank group that moves nothing: every collective returns an output
    of the right shape and dtype (in place where the real one is), so a
    program runs at one rank's coordinate with shapes alone (under
    ``FakeTensorMode``).  The surface of
    :class:`~repro_torch.pipeline.ranks.RankGroup` that the sharded steps and
    the pipeline engine call; the object collectives (``broadcast_object``,
    ``gather_object``) raise, as nothing on a step's path calls them."""

    rank: int = 0
    s: int = 0
    d: int = 0
    S: int = 1
    D: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    axes: tuple = ()
    coords: dict = dataclasses.field(default_factory=dict)
    transport: str = "dry"
    staged: bool = False

    @classmethod
    def at(cls, axes: dict, coords: dict) -> "DryGroup":
        """The rank at ``coords`` of a mesh with ``axes`` ({name: size}, in
        mesh order; ranks row-major, the last axis fastest)."""
        rank = 0
        for a, n in axes.items():
            rank = rank * n + coords[a]
        return cls(rank=rank, S=math.prod(axes.values()), s=rank, axes=tuple(axes.items()), coords=dict(coords))

    def group_size(self, axes) -> int:
        return _axes_size(self.axes, axes)

    @contextlib.contextmanager
    def span(self, item: str):
        yield

    def take_seconds(self) -> collections.Counter:
        return collections.Counter()

    def barrier(self) -> None:
        pass

    def wait_sends(self) -> None:
        pass

    def exchange(self, sends, recvs) -> list:
        return [_DryRecv(shape, dtype, self.device) for shape, dtype, _, _ in recvs]

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "stage") -> torch.Tensor:
        return t

    def all_reduce_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        self.group_size(axes)
        return t

    def all_gather_over(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        n = self.group_size(axes)
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        return t.new_empty(shape)

    def reduce_scatter_over(self, t: torch.Tensor, axes, dim: int = 0, dtype=None) -> torch.Tensor:
        n = self.group_size(axes)
        dtype = dtype or t.dtype
        if n == 1:
            return t.to(dtype)
        shape = list(t.shape)
        shape[dim] //= n
        return t.new_empty(shape, dtype=dtype)

    def broadcast_object(self, obj: Any = None):
        raise RuntimeError("a dry group carries no objects (nothing on a step's path broadcasts)")

    def gather_object(self, obj: Any):
        raise RuntimeError("a dry group carries no objects (nothing on a step's path gathers)")


class CollectiveRecorder:
    """``group`` (a :class:`~repro_torch.pipeline.ranks.RankGroup` or a
    :class:`DryGroup`) with every collective logged in :attr:`log` before
    it is passed on; every other attribute is the group's."""

    def __init__(self, group):
        self.group = group
        self.log: list[CollectiveEntry] = []

    def __getattr__(self, name):
        return getattr(self.group, name)

    def _add(self, kind, axes, n, t, dtype=None, dim=None, peer=None) -> None:
        if n > 1:
            self.log.append(CollectiveEntry(kind, tuple(axes), n, tuple(t.shape),
                                            _dtype_name(dtype or t.dtype), dim, peer))

    def take_log(self) -> list[CollectiveEntry]:
        """The entries since the last call, which it forgets."""
        out, self.log = self.log, []
        return out

    def all_reduce_over(self, t, axes):
        self._add("all-reduce", axes, _axes_size(self.group.axes, axes), t)
        return self.group.all_reduce_over(t, axes)

    def all_gather_over(self, t, axes, dim: int = 0):
        self._add("all-gather", axes, _axes_size(self.group.axes, axes), t, dim=dim)
        return self.group.all_gather_over(t, axes, dim=dim)

    def reduce_scatter_over(self, t, axes, dim: int = 0, dtype=None):
        self._add("reduce-scatter", axes, _axes_size(self.group.axes, axes), t, dtype=dtype, dim=dim)
        return self.group.reduce_scatter_over(t, axes, dim=dim, dtype=dtype)

    def all_reduce_sum(self, t, axis: str = "stage"):
        self._add("all-reduce", (axis,), self.group.S if axis == "stage" else self.group.D, t)
        return self.group.all_reduce_sum(t, axis)

    def exchange(self, sends, recvs):
        for payload, dst, _ in sends:
            self._add("collective-permute", ("stage",), 2, payload, peer=dst)
        for shape, dtype, src, _ in recvs:
            self._add("recv", ("stage",), 2, torch.empty(shape, dtype=dtype, device="meta"), peer=src)
        return self.group.exchange(sends, recvs)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    wire_bytes: float,
    peak_flops: float | None = None,
    hbm_bw: float | None = None,
    link_bw: float | None = None,
    *,
    spec=None,
    dtype: str = "bf16",
) -> dict:
    """The three roofline terms in seconds (all inputs per device), and the
    largest: ``repro``'s formula.  Peaks not given come from ``spec`` (a
    :class:`~repro_torch.core.devicespec.DeviceSpec` or a path; by default
    ``specs/h100-sxm.json``): ``dtype``'s peak FLOP/s, the HBM and the link
    bandwidth."""
    if peak_flops is None or hbm_bw is None or link_bw is None:
        from repro_torch.core.calibrate import resolve_spec

        spec = resolve_spec(spec)
        peak_flops = spec.peak_flops_for(dtype) if peak_flops is None else peak_flops
        hbm_bw = spec.hbm_bandwidth_bytes_per_s if hbm_bw is None else hbm_bw
        link_bw = spec.link_bandwidth_bytes_per_s if link_bw is None else link_bw
    terms = {
        "compute_s": flops / peak_flops,
        "memory_s": hbm_bytes / hbm_bw,
        "collective_s": wire_bytes / link_bw,
    }
    terms["bottleneck"] = max(terms, key=terms.get).removesuffix("_s")
    return terms
