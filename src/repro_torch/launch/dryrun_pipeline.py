"""Calibration of a Table-1 GPT config's pipeline stages, and the offline tune.

Port of the ``--calibrate`` half of ``repro/launch/dryrun_pipeline.py``.
:func:`calibrate` runs :mod:`repro_torch.core.calibrate` on the config's
stage bodies: per-stage fwd / BWD_INPUT / BWD_WEIGHT / saved-residual
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
costs nothing to count.  The engine dry-run of ``repro``'s module (lowering
``make_pipeline_step`` on a 256-device mesh and counting its collectives)
is ROADMAP queue 1, item 9.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline --calibrate \\
      --config GPT-2.7B --stages 4 --batch 8 --microbatches 4 --seq 1024 \\
      [--method spec|wallclock] [--device-spec specs/h100-sxm.json] \\
      [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core.calibrate import METHODS, calibrate_stage_costs, resolve_spec
from repro_torch.core.candidates import largest_admissible_warmup
from repro_torch.core.devicespec import TASK_PROGRAMS, WorkloadProfile
from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.schedule import make_plan
from repro_torch.device import resolve_device
from repro_torch.pipeline.stage import StagedModel

__all__ = ["calibrate", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_pipeline")


def _config(name: str):
    if name in GPT_CONFIGS:  # the paper's Table-1 ladder (GPT-Medium .. 2.7B)
        return GPT_CONFIGS[name]
    raise ValueError(
        f"config {name!r} is not one of the Table-1 GPT configs {sorted(GPT_CONFIGS)}; "
        "the other architectures come with ROADMAP queue 1, item 6"
    )


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
    device_spec: str | None = None, method: str = "spec", device=None,
) -> dict:
    """Calibrated per-stage profile of the config's stage bodies, its
    per-stage memory footprint and the admitted warmup vector; under
    ``method="spec"`` also the offline tune (``record["tuned"]``).  Prints
    the table and writes the record; returns it."""
    dev = resolve_device(device)
    staged = StagedModel.build(_config(config), S)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="GPT-2.7B", help="a Table-1 GPT config")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--calibrate", action="store_true",
                    help="profile the config's stage bodies into heterogeneous StageCosts + per-stage MemoryModel")
    ap.add_argument("--method", choices=METHODS, default="spec")
    ap.add_argument("--device-spec", default=None, metavar="SPECS_JSON",
                    help="with --method spec: the specs/*.json part to price on (default specs/h100-sxm.json)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.calibrate:
        ap.error("only --calibrate is ported; the engine dry-run (lowering on a 256-device mesh, "
                 "collective counts) is ROADMAP queue 1, item 9")
    return calibrate(args.config, args.stages, args.batch // args.microbatches, args.seq, args.out,
                     device_spec=args.device_spec, method=args.method, device=args.device)


if __name__ == "__main__":
    main()
