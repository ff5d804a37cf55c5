"""Logical sharding rules, by parameter path and shape, and the shard
helpers the sharded step uses.

Port of ``repro/distributed/sharding.py``, rule for rule.  The production
mesh is ``("data", "model")`` (16 x 16) or ``("pod", "data", "model")`` (2 x
16 x 16) (:mod:`repro_torch.launch.mesh`).  Axis roles, as in ``repro``:
``("pod", "data")`` split the batch and, FSDP-style, a second parameter
dim; ``"model"`` takes the tensor-parallel dim of a matrix (the column or
row split), the MoE expert dim and, for decode, the KV sequence.  A dim is
sharded only when the axis size divides it, so smoke and production configs
flow through the same rules.

The rules return :class:`PartitionSpec`, the port's twin of JAX's: a tuple
of per-dim entries (``None``, an axis name, or a tuple of names) in which a
one-name tuple collapses to the name, so ``P(("data",)) == P("data")`` as in
JAX, and ``P() != P(None)``.  :class:`NamedSharding` pairs a spec with its
mesh.  The rules read only ``mesh.shape[name]`` and ``mesh.axis_names``.

**Layout.** ``repro`` stacks its repeating block of layers into ``[n_blocks,
...]`` leaves keyed ``blocks/<j>/...``, and its rules shift right past that
stacked dim.  The port keeps one tree per layer (``layers/<i>/...``), so
:func:`param_pspecs` applies :func:`_spec_for` to the port's own path and
per-layer shape.  Where the stacked dim took a rule (a 1-D leaf stacked
into a matrix: a bias gets ``P("data", "model")`` there and ``P("model")``
here; a norm scale ``P(None, "model")`` there and ``P()`` here), the layouts
differ; the math does not.

The shard helpers: :func:`local_shape`, :func:`local_shard` (the chunk a
mesh coordinate holds) and :func:`gather` / :func:`reduce_scatter` (over the
axes a spec names, through the mesh's rank group).  A dim split over
several axes is chunked in mesh-axis order, as ``NamedSharding`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "replicated",
    "zero3_param_pspecs",
    "param_pspecs",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "DATA_AXES",
    "map_with_path",
    "spec_axes",
    "local_shape",
    "local_shard",
    "gather",
    "reduce_scatter",
]

DATA_AXES = ("pod", "data")  # whichever of these exist in the mesh


class PartitionSpec(tuple):
    """Per-dim mesh axes of an array (the port's twin of JAX's)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __getnewargs__(self):  # unpickle as P(*entries)
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: Any
    spec: PartitionSpec


def _mesh_axis(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def _data_size(mesh) -> int:
    return math.prod(_mesh_axis(mesh, a) for a in _data_axes(mesh))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _fits(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with ``fn(path, leaf)`` at each leaf (paths as
    :func:`repro_torch.tree.flatten` names them); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i)) for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix, tree)


# weight-name classes (matched as substrings of the flattened path)
_COL_SPLIT = ("wq/", "wk/", "wv/", "gate/", "up/", "in_proj", "xattn/wq", "xattn/wk", "xattn/wv")
_ROW_SPLIT = ("wo/", "down/", "out_proj", "xattn/wo")
_EMBED = ("table", "head")
_EXPERT = ("experts/",)


def _spec_for(path: str, shape: tuple[int, ...], mesh, fsdp: bool = True) -> PartitionSpec:
    """PartitionSpec for one parameter leaf (``repro``'s rule).

    2-D weights: the tensor-parallel dim over "model"; with ``fsdp`` the
    other dim over the data axes too.  Serving passes ``fsdp=False``.  MoE
    expert banks keep their second shard dim over the data axes even then.
    A ``blocks/`` path carries a leading stacked dim, which is never
    sharded and shifts the rules right."""
    tp = _mesh_axis(mesh, "model")
    data_axes = _data_axes(mesh)
    dsz = _data_size(mesh)
    nd = len(shape)
    spec: list[Any] = [None] * nd

    def put(i, axis, force=False):
        if 0 <= i < nd and spec[i] is None:
            if axis == "model" and _fits(shape[i], tp):
                spec[i] = "model"
            elif axis == "data" and (fsdp or force) and _fits(shape[i], dsz) and data_axes:
                spec[i] = data_axes

    lead = 1 if "blocks/" in path else 0
    if any(k in path for k in _EXPERT):
        put(lead, "model")  # expert dim
        put(lead + 1, "data", force=True)
        return P(*spec)
    if any(k in path for k in _EMBED):
        v_dim = lead if shape[lead] >= shape[-1] else nd - 1
        d_dim = nd - 1 if v_dim == lead else lead
        put(v_dim, "model")
        put(d_dim, "data")
        return P(*spec)
    if any(k in path for k in _COL_SPLIT):
        put(nd - 1, "model")  # output features
        put(nd - 2, "data")
        return P(*spec)
    if any(k in path for k in _ROW_SPLIT):
        put(nd - 2, "model")  # input features
        put(nd - 1, "data")
        return P(*spec)
    if nd >= 2:
        # other matrices (router, conv): the largest dim over model if divisible
        big = max(range(nd), key=lambda i: (shape[i], -i))
        put(big, "model")
        return P(*spec)
    return P()  # 1-D (norms, biases): replicate


def _zero3_spec(shape: tuple[int, ...], mesh) -> PartitionSpec:
    axes_all = tuple(mesh.axis_names)
    nd = len(shape)
    if nd < 2:
        return P()
    order = sorted(range(nd), key=lambda i: -shape[i])
    for axes in (axes_all, axes_all[-2:], axes_all[-1:]):
        n = math.prod(mesh.shape[a] for a in axes)
        if n <= 1:
            continue
        for i in order:
            if shape[i] % n == 0:
                spec = [None] * nd
                spec[i] = axes if len(axes) > 1 else axes[0]
                return P(*spec)
    return P()


def zero3_param_pspecs(params, mesh):
    """Pure ZeRO-3 layout: every >= 2-D leaf flat-sharded on its largest
    divisible dim over all mesh axes combined (else the last two, else the
    last one); no tensor parallelism."""
    return map_with_path(lambda _, x: _zero3_spec(tuple(x.shape), mesh), params)


def param_pspecs(params, mesh, fsdp: bool = True):
    """PartitionSpec tree for a parameter tree, each leaf by its path and shape."""
    return map_with_path(lambda path, x: _spec_for(path, tuple(x.shape), mesh, fsdp=fsdp), params)


def param_shardings(params, mesh, fsdp: bool = True):
    return map_with_path(lambda _, s: NamedSharding(mesh, s), param_pspecs(params, mesh, fsdp=fsdp))


def batch_shardings(batch_specs, mesh):
    """The batch dim over (pod, data); M-RoPE positions [3, B, T] keep their
    leading 3; a batch too small to split shards its sequence over model."""
    data_axes = _data_axes(mesh)
    dsz = _data_size(mesh)
    axes = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    def one(name, x):
        shape = tuple(x.shape)
        if name == "mrope_positions":
            return NamedSharding(mesh, P(None, axes) if _fits(shape[1], dsz) else P())
        if shape and _fits(shape[0], dsz):
            return NamedSharding(mesh, P(axes))
        if len(shape) >= 2 and _fits(shape[1], _mesh_axis(mesh, "model")):
            return NamedSharding(mesh, P(None, "model"))
        return NamedSharding(mesh, P())

    return {k: one(k, v) for k, v in batch_specs.items()}


def cache_shardings(cache_specs, mesh):
    """Decode-state sharding: KV caches [B, L, kv, hd] batch over the data
    axes, the sequence over "model" (else the KV heads); SSM states [B, H,
    P, N] batch over data, heads over model; conv windows [B, K, C] C over
    model."""
    data_axes = _data_axes(mesh)
    dsz = _data_size(mesh)
    tp = _mesh_axis(mesh, "model")
    axes = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)

    def one(path, x):
        shape = tuple(x.shape)
        nd = len(shape)
        lead = 1 if "blocks/" in path else 0
        spec: list[Any] = [None] * nd
        if nd > lead and _fits(shape[lead], dsz):
            spec[lead] = axes
        last = path.split("/")[-1]
        if "state" in path and nd >= lead + 4:
            if _fits(shape[lead + 1], tp):
                spec[lead + 1] = "model"
        elif ("k" in last or "v" in last) and nd >= lead + 4:
            if _fits(shape[lead + 1], tp):
                spec[lead + 1] = "model"
            elif _fits(shape[lead + 2], tp):
                spec[lead + 2] = "model"
        elif nd >= lead + 3 and _fits(shape[-1], tp):
            spec[nd - 1] = "model"
        return NamedSharding(mesh, P(*spec))

    return map_with_path(one, cache_specs)


# -- shards ------------------------------------------------------------------


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry, in order (``()`` for ``None``)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _split(spec, ndim: int) -> list[tuple[str, ...]]:
    return [spec_axes(spec[i]) if i < len(spec) else () for i in range(ndim)]


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` leaf under ``spec``."""
    out = []
    for dim, axes in zip(shape, _split(spec, len(shape))):
        n = math.prod(mesh.shape[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def local_shard(full, spec, mesh):
    """The chunk of the full leaf ``full`` that ``mesh``'s coordinate holds
    under ``spec`` (a view where the layout allows)."""
    x = full
    for d, axes in enumerate(_split(spec, full.ndim)):
        if axes:
            n = math.prod(mesh.shape[a] for a in axes)
            size = x.shape[d] // n
            x = x.narrow(d, mesh.index(axes) * size, size)
    return x


def _ordered(mesh, axes: tuple[str, ...]) -> None:
    names = [a for a in mesh.axis_names if a in axes]
    if list(axes) != names:
        raise ValueError(f"axes {axes} are not in mesh order {tuple(mesh.axis_names)}")


def gather(shard, spec, mesh):
    """The full leaf from each rank's ``shard`` under ``spec``: an all-gather
    over the axes each sharded dim names, through ``mesh.group``."""
    x = shard
    for d, axes in enumerate(_split(spec, shard.ndim)):
        if axes:
            _ordered(mesh, axes)
            x = mesh.group.all_gather_over(x, axes, dim=d)
    return x


def reduce_scatter(full, spec, mesh, dtype=None):
    """Each rank's shard under ``spec`` of the sum of every rank's ``full``
    over the axes the spec names (the ranks along other axes are not
    summed), in ``dtype`` (by default ``full``'s)."""
    x = full
    for d, axes in enumerate(_split(spec, full.ndim)):
        if axes:
            _ordered(mesh, axes)
            x = mesh.group.reduce_scatter_over(x, axes, dim=d, dtype=dtype)
    return x
