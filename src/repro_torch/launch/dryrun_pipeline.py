"""Calibration of a config's pipeline stages, and the offline tune.

Port of ``repro/launch/dryrun_pipeline.py``: the engine dry run and the
calibration.

:func:`run` is the engine dry run: one rank (``stage``, ``replica``; the
CLI runs rank (0, 0)) of
:func:`~repro_torch.pipeline.engine.make_pipeline_step` on an S x D grid
(S pipeline stages, D data replicas; ``repro``'s grid is the 16 x 16 pod,
and D here is ``256 // S`` cut to a divisor of the micro-batch size), run
once on shapes alone (``FakeTensorMode``, a recorded
:class:`~repro_torch.launch.hlo_analysis.DryGroup`, as
:mod:`repro_torch.launch.dryrun` runs the sharded steps).  Its record has
``repro``'s keys: the tick count and the bubble at unit cost, the rank's
FLOPs and bytes, its collectives by kind (``collective-permute`` the
point-to-point sends its channel tables post, ``all-reduce`` the replicated
leaves' and the loss's sums), the roofline on ``specs/h100-sxm.json``, and
the memory (``argument_bytes``: the rank's chunks and the batch;
``peak_bytes``: the live bytes' high-water mark).  ``repro``'s engine
permutes on every used ring channel at every tick (a tick with nothing to
send moves zeros); the port's engine sends only what the tables name, so
its count is the tables' sends.

:func:`calibrate` runs :mod:`repro_torch.core.calibrate` on the config's
stage bodies (``--config``: a Table-1 GPT, or any arch id the registry
builds, as ``repro``'s ``_config`` falls back to ``get_arch(name).model``;
the ``ssm``, ``moe`` and ``hybrid`` families count through K2's custom
operator and the MoE layer's static dispatch):
per-stage fwd / BWD_INPUT / BWD_WEIGHT / saved-residual
BWD_WEIGHT seconds and activation bytes (the heterogeneous ``StageCosts``
the scheduler stack consumes instead of ``StageCosts.uniform``), the
matching per-stage ``MemoryModel``, and the per-stage warmup vector
``w[s]`` the candidate enumeration admits under a per-stage memory-limit
curve.

* ``--method spec`` (the default) prices the counted programs on a device
  spec (``--device-spec``, default ``specs/h100-sxm.json``); the limit curve
  is the part's capacity, and the enumerate + tune search runs on the
  derived costs over a stable network at the part's link bandwidth.
* ``--method wallclock`` times the programs on the card with CUDA events
  (the CPU only under ``--device cpu``); the limit curve is each stage's
  ZB-H1 peak plus 25% of its activation working set, and no tune runs, as
  in ``repro`` without a spec.

The record ``<config>__S<S>_calibration.json`` holds every key of
``repro``'s, plus ``method``, ``card`` (the CUDA card's name, or ``cpu``),
``repeat_seconds`` (per program and stage, the timed runs of ``wallclock``;
empty lists under ``spec``) and ``workload``: the per-stage FLOP and byte counts of the four programs
and the memory footprint, as a ``WorkloadProfile`` that
``devicespec.derive_stage_costs`` prices on any spec.  Counting runs on the ``meta`` device, so a full-size config
costs nothing to count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline [--config qwen2.5-14b --stages 16 \\
      --microbatches 32 --k 2 --batch 256 --seq 4096] [--num-layers L]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline --calibrate \\
      --config GPT-2.7B --stages 4 --batch 8 --microbatches 4 --seq 1024 \\
      [--method spec|wallclock] [--device-spec specs/h100-sxm.json] \\
      [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import torch

from repro_torch.configs.base import get_arch
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core.calibrate import METHODS, calibrate_stage_costs, resolve_spec
from repro_torch.core.candidates import largest_admissible_warmup
from repro_torch.core.devicespec import TASK_PROGRAMS, WorkloadProfile, dtype_key
from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.schedule import make_plan, tick_table, tick_table_stats
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import dry_run
from repro_torch.launch.hlo_analysis import CollectiveRecorder, DryGroup, roofline_terms
from repro_torch.models.common import param_count
from repro_torch.pipeline.engine import make_pipeline_step
from repro_torch.pipeline.stage import StagedModel

__all__ = ["calibrate", "run", "main", "POD_DEVICES"]

#: ``repro``'s engine dry run lays S stages x 256 // S replicas over one pod
POD_DEVICES = 256

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_pipeline")


def _config(name: str):
    if name in GPT_CONFIGS:  # the paper's Table-1 ladder (GPT-Medium .. 2.7B)
        return GPT_CONFIGS[name]
    return get_arch(name).model


def _tune_on_spec(cal, spec, S: int, b_mb: int) -> dict:
    """The offline adaptive search on a spec-derived calibration: enumerate
    candidates under the part's capacity curve and tune over a stable
    network at its link bandwidth.  Deterministic -- the laptop answer to
    "what schedule would this config want on that hardware"."""
    from repro_torch.core import (
        AutoTuner,
        NetworkProfiler,
        SearchSpace,
        StableTrace,
        enumerate_candidates,
        uniform_network,
    )

    M = max(4 * S, 8)
    B = M * b_mb
    cands = enumerate_candidates(
        S, B, cal.memory, cal.limits,
        space=SearchSpace(
            kinds=("kfkb", "zb_h1", "zb_h2", "zbv", "interleaved"),
            virtual_degrees=(2,), max_k=2,
            zb_policies=("double_remat", "saved_residual"),
        ),
    )

    def costs_for(cand):
        return cal.costs.scaled_to_microbatch(b_mb, cand.micro_batch_size)

    net = uniform_network(
        S, lambda: StableTrace(spec.link_bandwidth_bytes_per_s)
    )
    rec = AutoTuner(cands, costs_for, NetworkProfiler(net)).tune(0.0)
    chosen = next(c for c in cands if c.name == rec.chosen)
    return {
        "global_batch": B,
        "candidates": [c.name for c in cands],
        "estimates": rec.estimates,
        "chosen": {
            "name": rec.chosen,
            "kind": rec.chosen_kind,
            "k": rec.chosen_k,
            "b": chosen.micro_batch_size,
            "extra_warmup": list(rec.chosen_extra_warmup),
            "zb_policy": list(rec.chosen_zb_policy),
        },
    }


def calibrate(
    config: str, S: int, b_mb: int, seq: int, out_dir: str,
    device_spec: str | None = None, method: str = "spec", device=None, model=None,
) -> dict:
    """Calibrated per-stage profile of the config's stage bodies, its
    per-stage memory footprint and the admitted warmup vector; under
    ``method="spec"`` also the offline tune (``record["tuned"]``).  Prints
    the table and writes the record; returns it.  ``model`` (a
    ``ModelConfig``) calibrates that config under the name ``config``
    (a cut of an arch)."""
    dev = resolve_device(device)
    cfg = model or _config(config)
    staged = StagedModel.build(cfg, S)
    spec = None
    if method == "spec":
        spec = resolve_spec(device_spec)
    elif device_spec is not None:
        raise ValueError(f"device_spec= prices method='spec' only, not {method!r}")
    cal = calibrate_stage_costs(staged, b_mb, seq, method=method, device_spec=spec, device=dev)
    costs, mm = cal.costs, cal.memory
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    print(f"{config}: calibrated {S} stages at b={b_mb}, seq={seq} on {cal.device} (method {method})")
    print("stage |  fwd ms |  B ms |  W ms | W(SR) ms | wire MB")
    for row in cal.summary_rows():
        print("  ".join(f"{c:>7s}" for c in row))
    M = max(4 * S, 8)
    h1 = make_plan(S, M, spec=ScheduleSpec(kind="zb_h1"))
    base = mm.peak_bytes_per_stage(h1)
    if spec is not None:
        # the part's own capacity is the limit curve for offline pricing
        limits = list(cal.limits)
    else:
        # a per-stage limit curve: each stage's H1 peak plus 25% of its own
        # activation working set -- heterogeneity makes the admitted w[s] differ
        limits = [
            p + 0.25 * mm.slot_bytes(s, b_mb, True) * S for s, p in enumerate(base)
        ]
    w_vec = largest_admissible_warmup(S, M, 1, b_mb, 1, True, mm, limits, S - 1)
    print(f"admitted warmup vector w[s] under the limit curve: {w_vec}")
    record = {
        "config": config,
        "stages": S,
        "micro_batch_size": b_mb,
        "seq": seq,
        "device": cal.device,
        "dtype": cal.dtype,
        "fwd_time": costs.fwd_time,
        "bwd_input_time": costs.bwd_input_time,
        "bwd_weight_time": costs.bwd_weight_time,
        "bwd_weight_saved_time": costs.bwd_weight_saved_time,
        "fwd_bytes": costs.fwd_bytes,
        "param_bytes_per_stage": [sp.param_bytes for sp in mm.stages],
        "peak_bytes_h1": base,
        "limit_curve": limits,
        "admitted_warmup_vector": list(w_vec),
        "method": method,
        "card": card,
        "repeat_seconds": {p: [list(prof[p].repeat_seconds) for prof in cal.profiles] for p in TASK_PROGRAMS},
        "workload": WorkloadProfile.from_calibration(cal, name=f"{config}__S{S}").to_json(),
    }
    if spec is not None:
        record["tuned"] = _tune_on_spec(cal, spec, S, b_mb)
        chosen = record["tuned"]["chosen"]
        print(
            f"on {spec.name}, the tuner picks {chosen['name']} "
            f"(kind={chosen['kind']} k={chosen['k']} b={chosen['b']})"
        )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{config}__S{S}_calibration.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[ok] calibration written to {path}")
    return record


def run(config: str, S: int, M: int, k: int, batch: int, seq: int, out_dir: str, *, D: int | None = None,
        stage: int = 0, replica: int = 0, num_layers: int | None = None, device_spec=None) -> dict:
    """The engine dry run (the module docstring) of rank (``stage``,
    ``replica``) of an ``S`` x ``D`` grid: the kfkb plan of depth ``k`` over
    ``M`` micro-batches of ``batch // M`` sequences of ``seq`` tokens, each
    micro-batch split over the D replicas.  ``D`` defaults to ``256 // S``
    cut to the largest divisor of the micro-batch size; ``num_layers`` cuts
    the config's depth.  Prints a line and writes the record; returns it."""
    cfg = _config(config)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    plan = make_plan(S, M, k)
    staged = StagedModel.build(cfg, S * plan.num_virtual)
    stats = tick_table_stats(tick_table(plan))
    b_mb = batch // M
    D = D or math.gcd(b_mb, max(POD_DEVICES // S, 1))
    group = CollectiveRecorder(DryGroup(rank=replica * S + stage, s=stage, d=replica, S=S, D=D))
    step = make_pipeline_step(staged, plan, group)
    print(f"{config}: {cfg.num_layers}L over {S} stages x {D} DP, {plan.name}, ticks={stats['ticks']:.0f} "
          f"(bubble {stats['bubble_fraction']:.1%} at unit cost); rank (s={stage}, d={replica})")

    def build():
        owned = [int(plan.placement.vstage_of[stage, c]) for c in range(plan.num_virtual)]
        params = staged.init_stages(torch.Generator().manual_seed(0), owned)
        tokens = torch.zeros((M, b_mb, seq), dtype=torch.long)
        return step, (params, tokens, torch.zeros_like(tokens))

    dry = dry_run(group, build)
    ana = dry.analysis
    terms = roofline_terms(ana.flops, ana.hbm_bytes, ana.wire_bytes, spec=device_spec, dtype=dtype_key(cfg.dtype))
    sends = [e for e in dry.log if e.kind == "collective-permute"]
    record = {
        "config": config,
        "plan": plan.name,
        "stages": S,
        "data": D,
        "rank": {"stage": stage, "replica": replica},
        "microbatches": M,
        "k": k,
        "batch": batch,
        "seq": seq,
        "num_layers": cfg.num_layers,
        "params_total": param_count(cfg),
        "ticks": stats["ticks"],
        "unit_bubble_fraction": stats["bubble_fraction"],
        "run_s": round(dry.seconds, 1),
        "flops_per_device": ana.flops,
        "bytes_accessed_per_device": ana.hbm_bytes,
        "collective_wire_bytes_per_device": ana.wire_bytes,
        "collective_counts": ana.collective_counts,
        "collective_bytes_by_kind": ana.collective_bytes_by_kind,
        "p2p_sends": len(sends),
        "p2p_recvs": sum(e.kind == "recv" for e in dry.log),
        "p2p_wire_bytes": sum(e.wire_bytes for e in sends),
        "memory": {"argument_bytes": dry.argument_bytes, "temp_bytes": dry.peak_bytes - dry.argument_bytes,
                   "peak_bytes": dry.peak_bytes},
        "roofline": terms,
    }
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{config}__S{S}_M{M}_k{k}"
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[ok] {tag}: run {dry.seconds:.0f}s  compute {terms['compute_s'] * 1e3:.0f}ms "
          f"mem {terms['memory_s'] * 1e3:.0f}ms coll {terms['collective_s'] * 1e3:.0f}ms -> {terms['bottleneck']}  "
          f"sends={len(sends)} peak {dry.peak_bytes / 1e9:.1f}GB")
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="qwen2.5-14b", help="a Table-1 GPT config or a ported arch id")
    ap.add_argument("--stages", type=int, default=16)
    ap.add_argument("--microbatches", type=int, default=32)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--num-layers", type=int, default=None, help="cut the config's depth (engine dry run)")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--calibrate", action="store_true",
                    help="profile the config's stage bodies into heterogeneous StageCosts + per-stage MemoryModel "
                         "instead of the engine dry run")
    ap.add_argument("--method", choices=METHODS, default="spec")
    ap.add_argument("--device-spec", default=None, metavar="SPECS_JSON",
                    help="the specs/*.json part to price on (default specs/h100-sxm.json)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.calibrate:
        return calibrate(args.config, args.stages, args.batch // args.microbatches, args.seq, args.out,
                         device_spec=args.device_spec, method=args.method, device=args.device)
    return run(args.config, args.stages, args.microbatches, args.k, args.batch, args.seq, args.out,
               num_layers=args.num_layers, device_spec=args.device_spec)


if __name__ == "__main__":
    main()
