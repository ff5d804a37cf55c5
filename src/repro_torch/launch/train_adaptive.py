"""Fig-10 end-to-end on the port's engine: the live plan-switch runtime.

Port of ``repro/launch/train_adaptive.py`` on the reference backend (the
``--fabric`` fleet and the ``spmd`` backend come with ROADMAP queue 1,
items 8 and 2).  The paper's regime experiment (preemption appears, eases,
returns; the tuner re-decides at intervals; the coordinator swaps plans
with minimal overhead) with real gradients:

* the network world stays a seeded :class:`RegimeTrace` driving the
  discrete-event simulator and the tuner's decisions (one card has no
  cross-stage network to preempt);
* every coordinator iteration is mirrored onto a live
  :class:`~repro_torch.runtime.executor.PlanRuntime` step: a real training
  iteration of the chosen plan, with warm kind switches (step programs
  built in the background for the tuner's favourites) and bitwise
  restacking across the interleaved boundary;
* the simulated iteration lengths flow through the telemetry bus into the
  profiler's windows, so the tuner suspends-and-probes only links whose
  windows went stale.  The engine's wall times never reach the tuner, so
  the decision trail is the same on any device and equals the one the
  copies of ``repro.core`` compute without an engine
  (:func:`engine_free_decision_trail`).

The default scenario (4 stages, bursty -> exclusive -> bursty) flips the
chosen schedule kind at least twice: ``zb_h2`` under contention,
``interleaved_zb`` on the quiet network, back again.

The model is ``repro``'s ``runtime-tiny`` by default, or a Table-1 GPT
config at full size (``--gpt GPT-2.7B --seq 1024``: fp32 parameters, bf16
compute, every attention forward in the flash kernel K1 on the card).
Everything else is ``repro``'s: the candidate set, the trace, the seeds,
AdamW at a constant lr of 1e-3, and the gates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train_adaptive \\
      [--iterations 14] [--stages 4] [--seed 0] [--gpt GPT-2.7B --seq 1024] \\
      [--device cuda] [--out summary.json] [--trace trace.json]

Without ``--device`` the run needs a CUDA card and fails if there is none;
``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time

import torch

from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import (
    AutoTuner,
    BurstyTrace,
    Candidate,
    Coordinator,
    Network,
    NetworkProfiler,
    RegimeTrace,
    ScheduleSpec,
    StableTrace,
    StageCosts,
    make_plan,
)
from repro_torch.core.coordinator import IterationRecord, RunSummary
from repro_torch.data import SyntheticTextDataset
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import ModelConfig
from repro_torch.obs import DriftMonitor, Observability, render_simulated_trace, spans_by_track
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline.engine import reference_pipeline_grads, stage_body_runs
from repro_torch.runtime import PassiveLinkFeed, PlanRuntime, RealEngineHarness, TelemetryBus
from repro_torch.tree import flatten, tree_map

__all__ = [
    "fig10_parts",
    "Fig10Scenario",
    "build_fig10_scenario",
    "engine_free_decision_trail",
    "warm_switch_frac_from_trace",
    "summarize",
    "expected_flash_launches",
    "grad_parity",
    "grad_parity_max_err",
    "main",
]


#: ``repro``'s Fig-10 scenario, in simulated seconds: the regime length (bursty,
#: quiet from ``HOUR``, bursty again from ``2 * HOUR``), the tuner's period and
#: the charge of a full suspend-and-probe round, and the age past which a link's
#: passively fed window is probed again
HOUR, TUNING_INTERVAL, TUNING_OVERHEAD, PASSIVE_STALENESS = 120.0, 55.0, 5.0, 40.0
#: the tuner's favourites whose steps are built in the background: all five
PRECOMPILE_TOP_N = 5


def fig10_parts(
    num_stages: int = 4, gpt: str | None = None
) -> tuple[ModelConfig, StageCosts, list[Candidate], int]:
    """The Fig-10 scenario's static parts: model config, stage costs, the
    candidate set (1F1B, 2F2B, ZB-H1, ZB-H2(w=2), interleaved-ZB(v=2)) and
    the global batch.  ``gpt`` names a Table-1 GPT config to train in place
    of ``repro``'s ``runtime-tiny``; the candidates and costs stay."""
    S, M, b = num_stages, num_stages, 2
    B = M * b
    if gpt is None:
        cfg = ModelConfig(
            "runtime-tiny", "dense", num_layers=2 * S, d_model=16, num_heads=2,
            num_kv_heads=2, d_ff=32, vocab_size=64,
            dtype=torch.float32, param_dtype=torch.float32,
        )
    else:
        cfg = GPT_CONFIGS[gpt]
    costs = StageCosts.uniform(S, 1.0, act_bytes=2.0)
    specs = [
        ScheduleSpec(kind="kfkb", k=1, micro_batch_size=b),
        ScheduleSpec(kind="kfkb", k=2, micro_batch_size=b),
        ScheduleSpec(kind="zb_h1", micro_batch_size=b),
        ScheduleSpec(kind="zb_h2", extra_warmup=2, micro_batch_size=b),
        ScheduleSpec(kind="interleaved_zb", num_virtual=2, micro_batch_size=b),
    ]
    cands = [Candidate(spec.k, b, M, make_plan(S, M, spec=spec), 0.0) for spec in specs]
    return cfg, costs, cands, B


def _decision_stack(num_stages, costs, cands, seed, obs):
    """The seeded regime network and the tuner fed passively from the
    simulated clock, as the scenario wires them: (network, tuner, bus, drift)."""

    def link(a: int, c: int):
        s = 17 * a + c + 100 * seed
        bursty = lambda ss: BurstyTrace(  # noqa: E731
            8.0, contended_frac=0.05, mean_free=0.5, mean_contended=2.0, seed=ss
        )
        return RegimeTrace([HOUR, 2 * HOUR], [bursty(s), StableTrace(50.0), bursty(s + 7)])

    net = Network.build(num_stages, link)
    profiler = NetworkProfiler(net, window=4)
    tuner = AutoTuner(
        cands, lambda c: costs, profiler, passive_staleness=PASSIVE_STALENESS,
        flight=obs.flight, metrics=obs.metrics,
    )
    bus = TelemetryBus(metrics=obs.metrics)
    bus.subscribe(PassiveLinkFeed(profiler))
    # predicted-vs-observed drift on the deterministic clock: observed = the
    # coordinator's simulated iteration lengths (source="sim"), predicted =
    # the tuner's latest cost-model estimate for the plan that ran
    drift = DriftMonitor(
        predict_fn=lambda name: tuner.history[-1].estimates.get(name) if tuner.history else None,
        registry=obs.metrics,
        source="sim",
        flight=obs.flight,
    )
    bus.subscribe(drift.on_iteration)
    return net, tuner, bus, drift


class _EngineProbe:
    """Coordinator hook after the harness: per iteration, the flash kernel
    K1's launches beside the attention forwards the plan's grid asks for
    (:func:`expected_flash_launches`; the CPU launches no kernel), and (on
    the card) the peak memory allocated since the previous iteration's
    reading, switch included."""

    def __init__(self, runtime: PlanRuntime) -> None:
        self.runtime = runtime
        self.device = runtime.device
        self.records: list[dict] = []
        self._launches = flash_ops.launches
        self._reset_peak()

    def _reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def on_iteration(self, rec: IterationRecord) -> None:
        launches, self._launches = flash_ops.launches - self._launches, flash_ops.launches
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else None
        forwards = expected_flash_launches(self.runtime.current_table.plan, self.runtime.cfg)
        self.records.append({"flash_launches": launches, "attention_forwards": forwards, "max_memory_allocated": peak})
        self._reset_peak()


@dataclasses.dataclass
class Fig10Scenario:
    """Everything a runtime Fig-10 run needs, wired together."""

    cfg: ModelConfig
    candidates: list[Candidate]
    costs: StageCosts
    network: Network
    coordinator: Coordinator
    tuner: AutoTuner
    runtime: PlanRuntime
    harness: RealEngineHarness
    bus: TelemetryBus
    dataset: SyntheticTextDataset
    global_batch: int
    obs: Observability
    drift: DriftMonitor
    probe: _EngineProbe


def build_fig10_scenario(
    num_stages: int = 4,
    seq_len: int = 64,
    seed: int = 0,
    gpt: str | None = None,
    device=None,
) -> Fig10Scenario:
    """The seeded regime scenario of ``repro``'s entry point and acceptance
    test, on ``device`` (the card unless given ``"cpu"``).

    Under the bursty regimes the deep-warmup zero-bubble plan wins; on the
    exclusive network the interleaved composition's shorter fill/drain
    takes over, so the decision trail flips kinds at least twice, crossing
    the restacking boundary both ways."""
    cfg, costs, cands, B = fig10_parts(num_stages, gpt=gpt)
    obs = Observability.create()
    net, tuner, bus, drift = _decision_stack(num_stages, costs, cands, seed, obs)
    opt = make_optimizer("adamw", schedule=constant_schedule(1e-3))
    runtime = PlanRuntime(
        cfg, num_stages, opt, global_batch=B, seq_len=seq_len,
        telemetry=bus, init_key=seed, obs=obs, device=device,
    )
    dataset = SyntheticTextDataset(cfg.vocab_size, seq_len, B, seed=seed)

    def batch_fn(i: int):
        batch = dataset.batch_at(i, runtime.device)
        return batch.tokens, batch.labels

    harness = RealEngineHarness(runtime, tuner, batch_fn, precompile_top_n=PRECOMPILE_TOP_N)
    probe = _EngineProbe(runtime)
    coord = Coordinator(
        tuner, net, global_batch=B, tuning_interval=TUNING_INTERVAL,
        tuning_overhead=TUNING_OVERHEAD, hooks=(harness, probe), telemetry_sink=bus,
    )
    return Fig10Scenario(
        cfg=cfg, candidates=cands, costs=costs, network=net, coordinator=coord,
        tuner=tuner, runtime=runtime, harness=harness, bus=bus, dataset=dataset,
        global_batch=B, obs=obs, drift=drift, probe=probe,
    )


def decision_trail(summary: RunSummary) -> list[dict]:
    return [{"t": round(r.time, 1), "chosen": r.chosen, "kind": r.chosen_kind} for r in summary.tuning]


def engine_free_decision_trail(iterations: int = 14, num_stages: int = 4, seed: int = 0) -> list[dict]:
    """The scenario's decision trail from the decision stack alone (the
    same coordinator, tuner and telemetry, no runtime): what a run of
    :func:`build_fig10_scenario` must reproduce."""
    _, costs, cands, B = fig10_parts(num_stages)
    net, tuner, bus, _ = _decision_stack(num_stages, costs, cands, seed, Observability.create())
    coord = Coordinator(
        tuner, net, global_batch=B, tuning_interval=TUNING_INTERVAL,
        tuning_overhead=TUNING_OVERHEAD, telemetry_sink=bus,
    )
    return decision_trail(coord.run(iterations))


def warm_switch_frac_from_trace(trace_payload: dict) -> float | None:
    """``median(warm switch span) / median(iteration span)`` over every
    ``*/switches`` and ``*/iterations`` track in a Chrome trace payload;
    ``None`` when the trace has no warm switch or no iteration spans."""
    by_track = spans_by_track(trace_payload)
    switch_durs = [
        e["dur"]
        for track, events in by_track.items()
        if track.endswith("/switches")
        for e in events
        if (e.get("args") or {}).get("warm")
    ]
    iter_durs = [e["dur"] for track, events in by_track.items() if track.endswith("/iterations") for e in events]
    if not switch_durs or not iter_durs:
        return None
    med_iter = statistics.median(iter_durs)
    return statistics.median(switch_durs) / med_iter if med_iter else None


def summarize(sc: Fig10Scenario, summary: RunSummary) -> dict:
    """The run's metrics: ``repro``'s set, plus each iteration's plan, wall
    time, K1 launches and peak memory, and per plan the step p50 and peak."""
    rt, stats = sc.runtime, sc.runtime.cache.stats
    warm = [e for e in rt.switch_events if e.warm]
    cold = [e for e in rt.switch_events if not e.warm]
    probes_run = sum(r.probes_run for r in summary.tuning)
    probes_total = sum(r.probes_run + r.probes_skipped for r in summary.tuning)
    full_suspend = sc.coordinator.tuning_overhead * len(summary.tuning)
    per_iteration = [
        {"plan": r.plan_name, "kind": r.kind, "loss": r.loss, "seconds": r.seconds, **p}
        for r, p in zip(rt.iterations, sc.probe.records)
    ]
    per_plan = {}
    for name in dict.fromkeys(r["plan"] for r in per_iteration):
        runs = [r for r in per_iteration if r["plan"] == name]
        peaks = [r["max_memory_allocated"] for r in runs if r["max_memory_allocated"] is not None]
        per_plan[name] = {
            "iterations": len(runs),
            "step_ms_p50": 1e3 * statistics.median(r["seconds"] for r in runs),
            "flash_launches": sorted({r["flash_launches"] for r in runs}),
            "attention_forwards": runs[0]["attention_forwards"],
            "max_memory_allocated": max(peaks) if peaks else None,
        }
    return {
        "config": sc.cfg.name,
        "num_layers": sc.cfg.num_layers,
        "d_model": sc.cfg.d_model,
        "device": str(rt.device),
        "iterations": len(rt.iterations),
        "losses": [round(r.loss, 4) for r in rt.iterations],
        "decision_trail": decision_trail(summary),
        "kind_switches": sc.harness.kind_switches,
        "switch_events": [dataclasses.asdict(e) for e in rt.switch_events],
        "mean_iteration_seconds": rt.mean_iteration_seconds,
        "warm_switch_seconds": [e.seconds for e in warm],
        "warm_switch_latency_frac": warm_switch_frac_from_trace(sc.obs.trace.to_chrome_trace()),
        "cold_switch_seconds": max((e.seconds + e.compile_seconds for e in cold), default=0.0),
        "precompile_hit_rate": stats.hit_rate,
        "cache": dataclasses.asdict(stats),
        "probe_rounds_run": probes_run,
        "probe_rounds_total": probes_total,
        "tuning_overhead_charged": summary.total_tuning_overhead,
        "probe_overhead_saved_frac": (
            1.0 - summary.total_tuning_overhead / full_suspend if full_suspend else 0.0
        ),
        "sim_total_time": summary.total_time,
        "model_drift_ratio": sc.drift.ratio(),
        "drift_samples": sc.drift.samples,
        "tuner_decisions_logged": len(sc.obs.flight.events("tuner_decision")),
        "per_iteration": per_iteration,
        "per_plan": per_plan,
    }


def expected_flash_launches(plan, cfg: ModelConfig) -> int:
    """K1 launches in one step of ``plan`` on the card: one per attention
    forward, each layer of a virtual stage once per run of its body (every
    layer of the dense configs here holds attention)."""
    return stage_body_runs(plan) * cfg.num_layers // plan.total_virtual_stages


def grad_parity(sc: Fig10Scenario) -> dict:
    """The engine's gradients on the run's CURRENT (switched and restacked)
    state against autograd of the mean unpipelined ``full_loss`` over the
    micro-batches (one micro-batch graph at a time): ``max_abs_err`` and
    the global ``rel_norm_err`` = ||g_e - g_o|| / ||g_o|| over every leaf."""
    rt = sc.runtime
    plan = rt.current_table.plan
    staged = rt.staged_for(plan.num_virtual)
    M = plan.num_microbatches
    b = sc.global_batch // M
    batch = sc.dataset.batch_at(999, rt.device)  # a batch the run did not train on
    tok = batch.tokens.reshape(M, b, rt.seq_len)
    lab = batch.labels.reshape(M, b, rt.seq_len)
    params = rt.state.params
    _, egrads = reference_pipeline_grads(staged, params, tok, lab, plan)
    egrads = list(flatten(egrads).values())
    leaves = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in params]
    flat = [g for ps in leaves for g in flatten(ps).values()]
    ograds = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
    for m in range(M):
        loss = staged.full_loss(leaves, tok[m], lab[m]) / M
        for acc, g in zip(ograds, torch.autograd.grad(loss, flat, allow_unused=True)):
            if g is not None:
                acc.add_(g.float())
    max_abs = max(float((e - o).abs().max()) for e, o in zip(egrads, ograds))
    num = math.sqrt(sum(float((e - o).square().sum()) for e, o in zip(egrads, ograds)))
    den = math.sqrt(sum(float(o.square().sum()) for o in ograds))
    finite = all(bool(torch.isfinite(e).all()) for e in egrads)
    return {"max_abs_err": max_abs, "rel_norm_err": num / den, "finite": finite}


def grad_parity_max_err(sc: Fig10Scenario) -> float:
    """Max abs gradient difference against the unpipelined oracle (``repro``'s
    acceptance observable)."""
    return grad_parity(sc)["max_abs_err"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iterations", type=int, default=14)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpt", default=None, choices=sorted(GPT_CONFIGS),
                    help="train this Table-1 GPT config at full size instead of runtime-tiny")
    ap.add_argument("--seq", type=int, default=64, help="tokens a sequence")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the run summary JSON here")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome/Perfetto trace of the run here: the observed spans plus "
                    "the simulator's predicted timeline of the final plan")
    args = ap.parse_args(argv)

    sc = build_fig10_scenario(
        num_stages=args.stages, seq_len=args.seq, seed=args.seed,
        gpt=args.gpt, device=args.device,
    )
    t0 = time.time()
    summary = sc.coordinator.run(args.iterations)
    out = summarize(sc, summary)
    out["wall_seconds"] = round(time.time() - t0, 2)
    if args.trace:
        for rec in sc.tuner.history:
            sc.obs.trace.add_instant(
                "coordinator/tuner", f"decision {rec.chosen}", rec.time,
                estimates={k: rec.estimates[k] for k in sorted(rec.estimates)},
                rejected=[{"name": n, "estimate": e, "reason": r} for n, e, r in rec.rejected_candidates],
            )
        render_simulated_trace(sc.runtime.current_table.plan, sc.costs, sc.network, recorder=sc.obs.trace)
        sc.obs.trace.save(args.trace)
        print(f"wrote trace {args.trace}")

    print("decision trail:")
    for d in out["decision_trail"]:
        print(f"  t={d['t']:7.1f}  {d['chosen']:30s} kind={d['kind']}")
    print(f"kind switches: {out['kind_switches']}")
    print(f"precompile hit rate: {out['precompile_hit_rate']:.2f}  (cache: {out['cache']})")
    if out["warm_switch_latency_frac"] is not None:
        print(f"warm switch latency: median trace span = {100 * out['warm_switch_latency_frac']:.2f}% of a "
              f"{out['mean_iteration_seconds'] * 1e3:.0f} ms iteration")
    print(f"model drift ratio: {out['model_drift_ratio']:.3f} ({out['drift_samples']} samples; "
          f"1.0 = perfect cost model)")
    print(f"probes run/total: {out['probe_rounds_run']}/{out['probe_rounds_total']}  "
          f"charged overhead {out['tuning_overhead_charged']:.2f}s (sim)")
    for name, p in out["per_plan"].items():
        print(f"plan {name}: {p['iterations']} iterations, step p50 {p['step_ms_p50']:.1f} ms, "
              f"K1 launches {p['flash_launches']}")
    print(f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
            f.write("\n")
        print(f"wrote {args.out}")
    sc.runtime.cache.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
