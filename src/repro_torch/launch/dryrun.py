"""Production-mesh dry run: one rank's sharded program at one coordinate of
``repro``'s production mesh, counted without allocating or communicating.

Port of ``repro/launch/dryrun.py``.  ``repro`` lowers and compiles each
(architecture x input shape) pair on 256 (or 512) placeholder devices and
reads the optimized HLO.  The port has one process per rank and no
compiler, so its dry run *is* one rank's program, run on shapes alone:

1. the step for the shape kind is built as ``repro`` builds it
   (``train_4k`` -> :func:`~repro_torch.distributed.spmd.make_spmd_train_step`
   with ``TRAIN_MICROBATCHES`` micro-batches, ``tp_fsdp``, or ``zero3`` /
   ``gather_once`` as ``repro``'s variants; ``prefill_32k`` ->
   :func:`~repro_torch.distributed.spmd.make_spmd_prefill`; the decode
   shapes -> :func:`~repro_torch.distributed.spmd.make_spmd_serve_step`
   against a ``seq_len`` cache), on a mesh of
   :func:`~repro_torch.launch.mesh.make_production_mesh`'s shape (16 x 16,
   or 2 x 16 x 16: ``repro``'s shape, not a count of cards) at the rank of
   ``--coords``;
2. the rank's arguments (each leaf's shard, ``local_shape``; the optimizer
   state; the global batch; the rank's shard of the decode cache) are fake
   tensors (``FakeTensorMode``), and the rank group is a
   :class:`~repro_torch.launch.hlo_analysis.DryGroup` under a
   :class:`~repro_torch.launch.hlo_analysis.CollectiveRecorder`: every
   collective returns an output of the right shape and is logged;
3. the step runs once under the operation counters
   (:func:`~repro_torch.launch.op_counts.count_ops`' FLOP and byte
   counters) and :class:`LiveBytes` (the high-water mark of live tensor
   bytes);
4. the record (``repro``'s keys) goes to
   ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``: FLOPs, bytes and
   collective wire bytes per device, the collective counts and bytes by
   kind, the roofline on ``specs/h100-sxm.json``, the
   model FLOPs and the useful fraction, and ``memory``: ``argument_bytes``
   (exact: the rank's shards, batch and cache) and ``peak_bytes`` (live
   bytes at their high-water mark, arguments included).

The fake tensors live on the CPU; K1 and K2 take their custom operators
there (a fake tensor's path in ``kernels/*/ops.py``), so the attention and
the SSD are counted by their FLOP formulas and hold what the kernels hold
(no score matrix).  A backward recomputes the plain versions, as on the
card.  A pair that fails writes a ``[FAIL]`` record with its error, as
``repro``'s does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi [--coords 17]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table   # the records as a markdown table
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import signal
import time
import traceback
import weakref
from typing import Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.base import ALL_ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.configs.io import input_specs, serving_config
from repro_torch.core.devicespec import dtype_key
from repro_torch.distributed.sharding import local_shape, map_with_path
from repro_torch.distributed.spmd import make_spmd_prefill, make_spmd_serve_step, make_spmd_train_step
from repro_torch.launch.hlo_analysis import CollectiveRecorder, DryGroup, HloAnalysis, analyze, roofline_terms
from repro_torch.launch.mesh import PRODUCTION_SHAPES, Mesh
from repro_torch.launch.op_counts import ByteCounter, tensor_bytes
from repro_torch.models import api
from repro_torch.models.common import active_param_count, param_count
from repro_torch.optim import make_optimizer
from repro_torch.training.state import create_train_state
from repro_torch.tree import flatten

__all__ = [
    "LiveBytes",
    "DryRun",
    "dry_mesh",
    "dry_run",
    "dry_train",
    "dry_prefill",
    "dry_decode",
    "argument_bytes",
    "build_lowerable",
    "run_pair",
    "table",
    "main",
    "TRAIN_MICROBATCHES",
]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")

#: micro-batches of the train shape (``repro``'s: 256 global / 8 / 16 data = 2 rows a rank)
TRAIN_MICROBATCHES = 8
VARIANTS = ("baseline", "gather_once", "zero3", "remat_blocks")
#: seconds a pair's dry run may take in ``main`` (the longest that finish,
#: the train_4k pairs, take 100-330 s on a CPU core; the SSM families'
#: prefill steps its recurrence a token at a time and would take hours)
PAIR_TIMEOUT = 600.0


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages live tensors hold: each operation's
    results are tracked until the last tensor on their storage is freed;
    :attr:`peak` is the high-water mark.  :meth:`track` adds tensors made
    before the mode (the arguments).  :attr:`dots` counts the operations
    with a FLOP formula (``repro``'s ``dot_count``)."""

    def __init__(self) -> None:
        super().__init__()
        self.live = self.peak = self.dots = 0
        self._held: dict[int, list] = {}  # storage -> [bytes, tensors on it]

    def _drop(self, key: int) -> None:
        held = self._held[key]
        held[1] -= 1
        if held[1] == 0:
            self.live -= held[0]
            del self._held[key]

    def track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._held:
            self._held[key][1] += 1
        else:
            self._held[key] = [storage.nbytes(), 1]
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.dots += func._overloadpacket in flop_registry
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def _tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    return []


def argument_bytes(*trees) -> int:
    """The bytes of every tensor in ``trees`` (states, batches, caches):
    what a rank holds as a program's arguments."""
    return sum(tensor_bytes(t) for tree in trees for t in _tensors(tree))


@dataclasses.dataclass
class DryRun:
    """One program run at one rank on shapes alone."""

    analysis: HloAnalysis
    log: list  # the CollectiveEntry list, in call order
    argument_bytes: int
    peak_bytes: int
    seconds: float


def dry_mesh(axes: dict, coords: dict | None = None) -> Mesh:
    """A mesh of ``axes`` ({name: size}, mesh order) at the rank of
    ``coords`` (all zeros by default), its group a recorded :class:`DryGroup`."""
    coords = coords or {a: 0 for a in axes}
    group = CollectiveRecorder(DryGroup.at(axes, coords))
    return Mesh(tuple(axes), tuple(axes.values()), tuple(coords[a] for a in axes), group)


def coords_of(axes: dict, rank: int) -> dict:
    """The coordinate of global ``rank`` (row-major, the last axis fastest)."""
    out = {}
    for a, n in reversed(list(axes.items())):
        out[a], rank = rank % n, rank // n
    return dict(reversed(list(out.items())))


def dry_run(mesh_or_group, build: Callable[[], tuple]) -> DryRun:
    """Run ``fn(*args)`` once on shapes alone, ``(fn, args) =
    build()`` called under a fresh ``FakeTensorMode`` (so ``args`` are fake
    tensors): the operation counts, the collectives of the recorded group
    (a :class:`CollectiveRecorder`, or a mesh with one), the arguments'
    bytes and the live bytes' high-water mark."""
    group = mesh_or_group if isinstance(mesh_or_group, CollectiveRecorder) else mesh_or_group.group
    with FakeTensorMode():
        fn, args = build()
        nargs = argument_bytes(args)
        group.take_log()
        t0 = time.perf_counter()
        live = LiveBytes()
        for t in _tensors(args):
            live.track(t)
        with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes, live:
            fn(*args)
        seconds = time.perf_counter() - t0
        log = group.take_log()
        del args
    return DryRun(analyze(log, flops.get_total_flops(), nbytes.hbm_bytes, live.dots), log, nargs, live.peak, seconds)


def _fake_like(full_shapes: dict, specs: dict, dtypes: dict, mesh) -> dict:
    """Zeros of each leaf's rank shard (``local_shape``), by path."""
    return {k: torch.zeros(local_shape(shape, specs[k], mesh), dtype=dtypes[k]) for k, shape in full_shapes.items()}


def _batch(batch_specs: dict) -> dict:
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype) for k, v in batch_specs.items()}


def _unflatten_like(tree, flat: dict):
    return map_with_path(lambda k, _: flat[k], tree)


def dry_train(cfg, mesh, batch_specs: dict, optimizer=None, *, num_microbatches: int = 1, strategy: str = "tp_fsdp",
              gather_params_once: bool = False, remat_blocks: bool = False) -> DryRun:
    """A sharded train step at ``mesh``'s rank (:func:`dry_mesh`)."""
    optimizer = optimizer or make_optimizer("adamw")
    step, (state_specs, _) = make_spmd_train_step(
        cfg, mesh, batch_specs, optimizer, num_microbatches=num_microbatches, strategy=strategy,
        gather_params_once=gather_params_once, remat_blocks=remat_blocks, device="cpu",
    )
    flat = flatten(state_specs.params)

    def build():
        shards = _fake_like({k: t.shape for k, t in flat.items()}, step.specs, {k: t.dtype for k, t in flat.items()},
                            mesh)
        state = create_train_state(_unflatten_like(state_specs.params, shards), step.optimizer)
        return step, (state, _batch(batch_specs))

    return dry_run(mesh, build)


def _serving_params(prog, mesh):
    """``build()`` of the rank's fake shards of the serving weights (their
    serving dtypes, cast on ``meta`` outside the fake mode)."""
    dtypes = {k: t.dtype for k, t in flatten(api.cast_for_serving(prog.param_specs, prog.cfg)).items()}
    shapes = {k: t.shape for k, t in flatten(prog.param_specs).items()}
    return lambda: _unflatten_like(prog.param_specs, _fake_like(shapes, prog.specs, dtypes, mesh))


def dry_prefill(cfg, mesh, batch_specs: dict, kv_len: int | None = None) -> DryRun:
    """The sharded prefill at ``mesh``'s rank; with ``kv_len`` filling the
    rank's shard of a fresh cache."""
    prefill, _ = make_spmd_prefill(cfg, mesh, batch_specs, device="cpu", kv_len=kv_len)
    params = _serving_params(prefill, mesh)

    def build():
        args = (params(), _batch(batch_specs))
        if kv_len is not None:
            args += (prefill.init_cache(),)
        return prefill, args

    return dry_run(mesh, build)


def dry_decode(cfg, mesh, batch_specs: dict, kv_len: int, index: int | None = None) -> DryRun:
    """A sharded decode step at ``mesh``'s rank against the rank's
    shard of a ``kv_len`` cache, at position ``index`` (``kv_len - 1`` by
    default)."""
    step, _ = make_spmd_serve_step(cfg, mesh, batch_specs, kv_len, device="cpu")
    index = kv_len - 1 if index is None else index
    params = _serving_params(step, mesh)

    def build():
        args = (params(), step.init_cache(), index, _batch(batch_specs))
        return step, args

    return dry_run(mesh, build)


def _mesh_axes(mesh_kind: str) -> dict:
    return dict(PRODUCTION_SHAPES[mesh_kind == "multi"])


def build_lowerable(arch_id: str, shape_name: str, mesh, variant: str = "baseline", num_layers: int | None = None):
    """Returns ``(run, meta)`` for one (arch, shape, mesh): ``run()`` is the
    pair's :class:`DryRun` at ``mesh``'s rank (:func:`dry_mesh`), ``meta``
    ``repro``'s keys; ``(None, {"skipped": ...})`` for a pair the arch does
    not support.  ``variant``: ``"baseline"``, ``"gather_once"`` (the
    leaves gathered once a step), ``"zero3"`` (one micro-batch over every
    chip) or ``"remat_blocks"``; ``num_layers`` cuts the depth."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (known: {VARIANTS})")
    spec = get_arch(arch_id)
    shape = INPUT_SHAPES[shape_name]
    if not spec.supports(shape):
        return None, {"skipped": True, "reason": spec.notes}
    cfg = serving_config(spec, shape)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    batch_specs = input_specs(spec, shape)
    meta = {
        "arch": arch_id,
        "shape": shape_name,
        "family": spec.family,
        "optimizer": spec.optimizer,
        "params_total": param_count(cfg),
        "params_active": active_param_count(cfg),
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "num_layers": cfg.num_layers,
        "coords": dict(zip(mesh.axis_names, mesh.coords)),
        "dtype": dtype_key(cfg.dtype),
    }
    if shape.kind == "train":
        n_mb = 1 if variant == "zero3" else TRAIN_MICROBATCHES
        meta.update(step_kind="train_step", num_microbatches=n_mb, variant=variant)

        def run():
            return dry_train(cfg, mesh, batch_specs, make_optimizer(spec.optimizer), num_microbatches=n_mb,
                             strategy="zero3" if variant == "zero3" else "tp_fsdp",
                             gather_params_once=variant == "gather_once", remat_blocks=variant == "remat_blocks")
    elif shape.kind == "prefill":
        meta["step_kind"] = "prefill"

        def run():
            return dry_prefill(cfg, mesh, batch_specs)
    else:
        meta.update(step_kind="serve_step", long_context_policy=spec.long_context)

        def run():
            return dry_decode(cfg, mesh, batch_specs, kv_len=shape.seq_len)
    return run, meta


def model_flops(meta: dict) -> float:
    """``repro``'s model FLOPs of the step: 6 N T (train), 2 N T (prefill),
    2 N B (one decode token a sequence), N the active parameters."""
    tokens = meta["seq_len"] * meta["global_batch"]
    if meta["step_kind"] == "train_step":
        return 6.0 * meta["params_active"] * tokens
    if meta["step_kind"] == "prefill":
        return 2.0 * meta["params_active"] * tokens
    return 2.0 * meta["params_active"] * meta["global_batch"]


def record_of(tag: str, meta: dict, mesh_kind: str, chips: int, dry: DryRun) -> dict:
    """``repro``'s record of one pair from its dry run."""
    ana = dry.analysis
    terms = roofline_terms(ana.flops, ana.hbm_bytes, ana.wire_bytes, dtype=meta["dtype"])
    mf = model_flops(meta)
    return {
        "tag": tag,
        **meta,
        "mesh": mesh_kind,
        "chips": chips,
        "run_s": round(dry.seconds, 1),
        "flops_per_device": ana.flops,
        "bytes_accessed_per_device": ana.hbm_bytes,
        "collective_wire_bytes_per_device": ana.wire_bytes,
        "collective_counts": ana.collective_counts,
        "collective_bytes_by_kind": ana.collective_bytes_by_kind,
        "dot_count": ana.dot_count,
        "memory": {"argument_bytes": dry.argument_bytes, "output_bytes": None,
                   "temp_bytes": dry.peak_bytes - dry.argument_bytes, "peak_bytes": dry.peak_bytes},
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_fraction": (mf / chips) / ana.flops if ana.flops else None,
    }


@contextlib.contextmanager
def _deadline(seconds: float | None):
    """Raise ``TimeoutError`` in the block after ``seconds`` of wall time
    (``SIGALRM``; no limit when ``None`` or 0)."""
    if not seconds:
        yield
        return

    def expire(*_):
        raise TimeoutError(f"the dry run took over {seconds:g} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_pair(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str, force: bool = False,
             variant: str = "baseline", coords: int = 0, num_layers: int | None = None,
             timeout: float | None = None) -> dict:
    """Dry-run one pair at global rank ``coords`` of the production mesh and
    write its record (cached unless ``force``); a failure, or a dry run
    past ``timeout`` seconds, writes a record with its ``error``."""
    tag = f"{arch_id}__{shape_name}__{mesh_kind}"
    if variant != "baseline":
        tag += f"__{variant}"
    if coords:
        tag += f"__r{coords}"
    if num_layers is not None:
        tag += f"__L{num_layers}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        print(f"[skip]   {tag} (cached)")
        with open(out_path) as f:
            return json.load(f)
    axes = _mesh_axes(mesh_kind)
    mesh = dry_mesh(axes, coords_of(axes, coords))
    try:
        run, meta = build_lowerable(arch_id, shape_name, mesh, variant=variant, num_layers=num_layers)
        if run is None:
            record = {"tag": tag, **meta}
            _write(out_path, record)
            print(f"[SKIP]   {tag}: documented skip")
            return record
        with _deadline(timeout):
            dry = run()
        record = record_of(tag, meta, mesh_kind, mesh.size, dry)
        _write(out_path, record)
        t = record["roofline"]
        print(f"[ok]     {tag}: run {record['run_s']:.0f}s  compute {t['compute_s'] * 1e3:.1f}ms  "
              f"mem {t['memory_s'] * 1e3:.1f}ms  coll {t['collective_s'] * 1e3:.1f}ms -> {t['bottleneck']}")
        return record
    except Exception as e:  # noqa: BLE001 -- a pair's failure is its record
        record = {"tag": tag, "error": f"{type(e).__name__}: {e}"}
        _write(out_path, record)
        print(f"[FAIL]   {tag}: {type(e).__name__}: {e}")
        traceback.print_exc()
        return record


def table(out_dir: str, mesh_kind: str = "single") -> str:
    """The records of ``out_dir`` on ``mesh_kind`` as a markdown table, a row
    an arch and a column a shape; a cell: per device TFLOP, collective wire
    GB, the roofline's largest term (its ms) and the peak live GiB; a
    failed pair's cell its error's type, a skipped one "skip"."""
    rows = ["| arch | " + " | ".join(INPUT_SHAPES) + " |", "| --- |" + " --- |" * len(INPUT_SHAPES)]
    for arch in ALL_ARCH_IDS:
        cells = []
        for shape in INPUT_SHAPES:
            path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")
            if not os.path.exists(path):
                cells.append("not run")
                continue
            with open(path) as f:
                r = json.load(f)
            if "error" in r:
                cells.append(f"[FAIL] {r['error'].split(':')[0]}")
            elif r.get("skipped"):
                cells.append("skip")
            else:
                t = r["roofline"]
                cells.append(f"{r['flops_per_device'] / 1e12:.3g} TF, {r['collective_wire_bytes_per_device'] / 1e9:.3g} "
                             f"GB, {t['bottleneck']} {t[t['bottleneck'] + '_s'] * 1e3:.3g} ms, "
                             f"{r['memory']['peak_bytes'] / 2**30:.3g} GiB")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def _write(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    ap.add_argument("--coords", type=int, default=0, help="the global rank dry-run (row-major over the mesh)")
    ap.add_argument("--num-layers", type=int, default=None, help="cut every arch to this depth")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--table", action="store_true", help="print the records under --out as a markdown table")
    ap.add_argument("--pair-timeout", type=float, default=PAIR_TIMEOUT,
                    help="seconds a pair's dry run may take before it is recorded as failed (0: no limit)")
    args = ap.parse_args(argv)
    if args.table:
        for mesh_kind in ["single", "multi"] if args.mesh == "both" else [args.mesh]:
            print(table(args.out, mesh_kind))
        return 0
    archs = ALL_ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_pair(arch, shape, mesh_kind, args.out, force=args.force, variant=args.variant,
                               coords=args.coords, num_layers=args.num_layers, timeout=args.pair_timeout)
                failures += 1 if "error" in rec else 0
    print(f"\ndone; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
