"""Fig-10 end-to-end on the port's engines: the live plan-switch runtime.

Port of ``repro/launch/train_adaptive.py`` (the ``--fabric`` fleet comes
with ROADMAP queue 1, item 8).  The paper's regime experiment (preemption
appears, eases, returns; the tuner re-decides at intervals; the
coordinator swaps plans with minimal overhead) with real gradients:

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

Two backends, as ``repro``'s ``--backend``:

* ``reference``: one process, the one-process engine over the whole model;
* ``spmd``: one process per stage (:func:`run_fig10_spmd`), the multi-rank
  engine, the state restacked across the ranks at each switch that moves
  a layer.  Global rank 0 runs the coordinator, the tuner, the harness and
  the telemetry, as ``repro``'s single controller does; its runtime tells
  the other ranks each precompile, switch and step (the batch index: each
  rank draws its own batch).  Transport: NCCL when every rank has a card
  of its own, else gloo (``pipeline/ranks.py``).

The model is ``repro``'s ``runtime-tiny`` by default, or a Table-1 GPT
config at full size (``--gpt GPT-2.7B --seq 1024``: fp32 parameters, bf16
compute, every attention forward in the flash kernel K1 on the card).
Everything else is ``repro``'s: the candidate set, the trace, the seeds,
AdamW at a constant lr of 1e-3 (clipped at 1 by the norm over every rank),
and the gates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train_adaptive \\
      [--backend reference|spmd] [--iterations 14] [--stages 4] [--seed 0] \\
      [--gpt GPT-2.7B --seq 1024] [--device cuda] \\
      [--out summary.json] [--trace trace.json]

Without ``--device`` the run needs a CUDA card (a card per rank for NCCL)
and fails if there is none; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import time
from typing import Callable

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
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.common import ModelConfig
from repro_torch.obs import DriftMonitor, Observability, render_simulated_trace, spans_by_track
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.pipeline.engine import reduce_replicated, stage_body_runs
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
    "fig10_rank",
    "run_fig10_spmd",
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
    num_stages: int = 4, gpt: str | None = None, num_layers: int | None = None
) -> tuple[ModelConfig, StageCosts, list[Candidate], int]:
    """The Fig-10 scenario's static parts: model config, stage costs, the
    candidate set (1F1B, 2F2B, ZB-H1, ZB-H2(w=2), interleaved-ZB(v=2)) and
    the global batch.  ``gpt`` names a Table-1 GPT config to train in place
    of ``repro``'s ``runtime-tiny`` (``num_layers`` cuts its depth); the
    candidates and costs stay."""
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
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
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


class _RankCounters:
    """One process's K1 launches and peak memory allocated since its last
    reading, read after every step (switch included): the runtime's
    ``rank_probe`` under spmd, the probe's own under the reference backend."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._launches = flash_ops.launches
        self._reset_peak()

    def _reset_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def __call__(self) -> dict:
        launches, self._launches = flash_ops.launches - self._launches, flash_ops.launches
        rec = {"flash_launches": launches, "max_memory_allocated": None, "max_memory_reserved": None}
        if self.device.type == "cuda":
            rec.update(max_memory_allocated=torch.cuda.max_memory_allocated(self.device),
                       max_memory_reserved=torch.cuda.max_memory_reserved(self.device))
        self._reset_peak()
        return rec


class _EngineProbe:
    """Coordinator hook after the harness: per iteration, the flash kernel
    K1's launches (summed over the ranks under spmd) beside the attention
    forwards the plan's grid asks for (:func:`expected_flash_launches`; the
    CPU launches no kernel), and (on the card) the peak memory allocated
    since the previous iteration's reading, switch included: the largest
    rank's, and each rank's under spmd."""

    def __init__(self, runtime: PlanRuntime, counters: _RankCounters) -> None:
        self.runtime = runtime
        self.counters = counters
        self.records: list[dict] = []

    def on_iteration(self, rec: IterationRecord) -> None:
        per_rank = self.runtime.iterations[-1].ranks or [self.counters()]
        peaks = [r["max_memory_allocated"] for r in per_rank]
        forwards = expected_flash_launches(self.runtime.current_table.plan, self.runtime.cfg)
        self.records.append({
            "flash_launches": sum(r["flash_launches"] for r in per_rank),
            "attention_forwards": forwards,
            "max_memory_allocated": None if None in peaks else max(peaks),
            "max_memory_allocated_per_rank": peaks,
            "max_memory_reserved_per_rank": [r["max_memory_reserved"] for r in per_rank],
        })


@dataclasses.dataclass
class Fig10Scenario:
    """Everything a runtime Fig-10 run needs, wired together.  Under spmd
    only global rank 0 holds the decision side (the coordinator, the tuner,
    the harness, the bus, the drift monitor and the probe); the other ranks'
    scenarios hold ``None`` there and their runtimes follow rank 0's."""

    cfg: ModelConfig
    candidates: list[Candidate]
    costs: StageCosts
    network: Network | None
    coordinator: Coordinator | None
    tuner: AutoTuner | None
    runtime: PlanRuntime
    harness: RealEngineHarness | None
    bus: TelemetryBus | None
    dataset: SyntheticTextDataset
    global_batch: int
    obs: Observability | None
    drift: DriftMonitor | None
    probe: _EngineProbe | None

    def batch(self, i: int) -> tuple:
        """Batch ``i``'s ``(tokens, labels)`` on the runtime's device."""
        b = self.dataset.batch_at(i, self.runtime.device)
        return b.tokens, b.labels


def build_fig10_scenario(
    num_stages: int = 4,
    seq_len: int = 64,
    seed: int = 0,
    gpt: str | None = None,
    device=None,
    backend: str = "reference",
    group=None,
    num_layers: int | None = None,
) -> Fig10Scenario:
    """The seeded regime scenario of ``repro``'s entry point and acceptance
    test, on ``device`` (the card unless given ``"cpu"``).  ``backend="spmd"``
    runs on the ranks: call it on every rank with the rank's ``group``
    (the device is the group's).

    Under the bursty regimes the deep-warmup zero-bubble plan wins; on the
    exclusive network the interleaved composition's shorter fill/drain
    takes over, so the decision trail flips kinds at least twice, crossing
    the restacking boundary both ways."""
    cfg, costs, cands, B = fig10_parts(num_stages, gpt=gpt, num_layers=num_layers)
    spmd = backend == "spmd"
    leads = group is None or group.rank == 0
    obs = Observability.create() if leads else None
    net = tuner = bus = drift = None
    if leads:
        net, tuner, bus, drift = _decision_stack(num_stages, costs, cands, seed, obs)
    # every rank clips by the norm of the whole model, every copy counted
    norm_reduce = (lambda t: group.all_reduce_sum(t, "stage")) if spmd and group is not None else None
    opt = make_optimizer("adamw", schedule=constant_schedule(1e-3), norm_reduce=norm_reduce)
    counters = _RankCounters(group.device if spmd and group is not None else resolve_device(device))
    runtime = PlanRuntime(
        cfg, num_stages, opt, global_batch=B, seq_len=seq_len, backend=backend,
        telemetry=bus, init_key=seed, obs=obs, device=device, group=group,
        rank_probe=counters if spmd else None,
    )
    dataset = SyntheticTextDataset(cfg.vocab_size, seq_len, B, seed=seed)
    sc = Fig10Scenario(
        cfg=cfg, candidates=cands, costs=costs, network=net, coordinator=None, tuner=tuner,
        runtime=runtime, harness=None, bus=bus, dataset=dataset, global_batch=B, obs=obs,
        drift=drift, probe=None,
    )
    if leads:
        sc.harness = RealEngineHarness(runtime, tuner, sc.batch, precompile_top_n=PRECOMPILE_TOP_N)
        sc.probe = _EngineProbe(runtime, counters)
        sc.coordinator = Coordinator(
            tuner, net, global_batch=B, tuning_interval=TUNING_INTERVAL,
            tuning_overhead=TUNING_OVERHEAD, hooks=(sc.harness, sc.probe), telemetry_sink=bus,
        )
    return sc


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
        {"plan": r.plan_name, "kind": r.kind, "loss": r.loss, "seconds": r.seconds, **p,
         **({"rank_seconds": [x["seconds"] for x in r.ranks]} if r.ranks else {})}
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
        if "rank_seconds" in runs[0]:  # spmd: each rank's p50 of each item of its breakdown
            for key in ("max_memory_allocated_per_rank", "max_memory_reserved_per_rank"):
                per_plan[name][key] = [
                    max(col) if None not in col else None for col in zip(*(r[key] for r in runs))
                ]
            per_plan[name]["per_rank_ms_p50"] = [
                {k: 1e3 * statistics.median(x.get(k, 0.0) for x in col) for k in RANK_ITEMS}
                for col in zip(*(r["rank_seconds"] for r in runs))
            ]
    g = rt.group
    return {
        "config": sc.cfg.name,
        "num_layers": sc.cfg.num_layers,
        "d_model": sc.cfg.d_model,
        "backend": rt.backend,
        "ranks": 1 if g is None else g.S * g.D,
        "transport": None if g is None else g.transport,
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


#: a rank's step breakdown under spmd (``pipeline/ranks.py``'s spans; "other"
#: is the optimizer and the host)
RANK_ITEMS = ("compute", "recv_wait", "send_wait", "staging", "reduce", "other")


def expected_flash_launches(plan, cfg: ModelConfig) -> int:
    """K1 launches in one step of ``plan`` on the card: one per attention
    forward, each layer of a virtual stage once per run of its body (every
    layer of the dense configs here holds attention)."""
    return stage_body_runs(plan) * cfg.num_layers // plan.total_virtual_stages


def grad_parity(sc: Fig10Scenario) -> dict:
    """The engine's gradients on the run's CURRENT (switched and restacked)
    state against autograd of the mean unpipelined ``full_loss`` over the
    micro-batches (one micro-batch graph at a time), both in the flat
    layout: ``max_abs_err`` and the global ``rel_norm_err`` = ||g_e - g_o||
    / ||g_o|| over every leaf.  The reference engine leaves each replicated
    copy its own gradient, as autograd does; the ranks' engine sums the
    copies' (under spmd this runs on global rank 0 while the others follow,
    on the state and gradients gathered to it), so there the oracle's copies
    are summed too."""
    rt = sc.runtime
    M = rt.current_table.plan.num_microbatches
    shape = (M, sc.global_batch // M, rt.seq_len)
    tokens, labels = sc.batch(999)  # a batch the run did not train on
    _, egrads = rt.grads_at(tokens, labels, batch_index=999)
    staged, params = rt.staged_for(1), rt.state_in_flat_layout().params
    tok, lab = tokens.reshape(shape), labels.reshape(shape)
    leaves = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in params]
    ograds = [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), ps) for ps in leaves]
    flat, oflat = [g for ps in leaves for g in flatten(ps).values()], [g for ps in ograds for g in flatten(ps).values()]
    for m in range(M):
        loss = staged.full_loss(leaves, tok[m], lab[m]) / M
        for acc, g in zip(oflat, torch.autograd.grad(loss, flat, allow_unused=True)):
            if g is not None:
                acc.add_(g.float())
    del leaves, flat
    if rt.group is not None:
        reduce_replicated(ograds)
    egrads = list(flatten(egrads).values())
    max_abs = max(float((e - o).abs().max()) for e, o in zip(egrads, oflat))
    num = math.sqrt(sum(float((e - o).square().sum()) for e, o in zip(egrads, oflat)))
    den = math.sqrt(sum(float(o.square().sum()) for o in oflat))
    finite = all(bool(torch.isfinite(e).all()) for e in egrads)
    return {"max_abs_err": max_abs, "rel_norm_err": num / den, "finite": finite}


def grad_parity_max_err(sc: Fig10Scenario) -> float:
    """Max abs gradient difference against the unpipelined oracle (``repro``'s
    acceptance observable)."""
    return grad_parity(sc)["max_abs_err"]


def _report(sc: Fig10Scenario, summary: RunSummary, t0: float, trace: str | None) -> dict:
    """The run's summary (:func:`summarize` and its wall seconds); with
    ``trace``, the run's spans and the simulator's predicted timeline of the
    final plan written there."""
    out = summarize(sc, summary)
    out["wall_seconds"] = round(time.time() - t0, 2)
    if trace:
        for rec in sc.tuner.history:
            sc.obs.trace.add_instant(
                "coordinator/tuner", f"decision {rec.chosen}", rec.time,
                estimates={k: rec.estimates[k] for k in sorted(rec.estimates)},
                rejected=[{"name": n, "estimate": e, "reason": r} for n, e, r in rec.rejected_candidates],
            )
        render_simulated_trace(sc.runtime.current_table.plan, sc.costs, sc.network, recorder=sc.obs.trace)
        sc.obs.trace.save(trace)
        print(f"wrote trace {trace}")
    return out


def fig10_rank(group, iterations: int, scenario: dict, checks: Callable | None = None, trace: str | None = None):
    """One rank of :func:`run_fig10_spmd`: build the scenario on this rank
    (``scenario``: :func:`build_fig10_scenario`'s keywords), then run it
    (global rank 0: the coordinator's ``iterations``, the summary, then
    ``checks(sc)`` if given, whose result joins the summary as ``checks``)
    or follow rank 0 (the others).  Returns rank 0's summary,
    ``None`` elsewhere."""
    sc = build_fig10_scenario(backend="spmd", group=group, **scenario)
    if group.rank:
        sc.runtime.follow(sc.batch)
        sc.runtime.cache.shutdown()
        return None
    t0 = time.time()
    summary = sc.coordinator.run(iterations)
    out = _report(sc, summary, t0, trace)
    if checks is not None:
        out["checks"] = checks(sc)
    sc.runtime.stop()
    sc.runtime.cache.shutdown()
    return out


def run_fig10_spmd(
    iterations: int = 14,
    num_stages: int = 4,
    seq_len: int = 64,
    seed: int = 0,
    gpt: str | None = None,
    num_layers: int | None = None,
    device=None,
    checks: Callable | None = None,
    trace: str | None = None,
) -> dict:
    """The Fig-10 scenario on the ``spmd`` backend: ``num_stages`` ranks, one
    process each, on ``device`` (the card unless given ``"cpu"``).  Returns
    global rank 0's summary (:func:`fig10_rank`).  ``checks``, a
    module-level function, runs on rank 0 after the run while the other
    ranks still follow (e.g. :func:`grad_parity`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        build.build(flash_ops.SOURCE)  # once, here: the ranks load it
    scenario = dict(num_stages=num_stages, seq_len=seq_len, seed=seed, gpt=gpt, num_layers=num_layers)
    return ranks.spawn(
        fig10_rank, num_stages, args=(iterations, scenario, checks, trace), device=dev.type, timeout=None
    )[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iterations", type=int, default=14)
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--backend", choices=("reference", "spmd"), default="reference",
                    help="one process (reference) or one process per stage (spmd)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpt", default=None, choices=sorted(GPT_CONFIGS),
                    help="train this Table-1 GPT config at full size instead of runtime-tiny")
    ap.add_argument("--seq", type=int, default=64, help="tokens a sequence")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the run summary JSON here")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write a Chrome/Perfetto trace of the run here: the observed spans (rank 0's "
                    "under spmd) plus the simulator's predicted timeline of the final plan")
    args = ap.parse_args(argv)

    kw = dict(num_stages=args.stages, seq_len=args.seq, seed=args.seed, gpt=args.gpt)
    if args.backend == "spmd":
        out = run_fig10_spmd(args.iterations, device=args.device, trace=args.trace, **kw)
    else:
        sc = build_fig10_scenario(device=args.device, **kw)
        t0 = time.time()
        out = _report(sc, sc.coordinator.run(args.iterations), t0, args.trace)
        sc.runtime.cache.shutdown()

    print("decision trail:")
    for d in out["decision_trail"]:
        print(f"  t={d['t']:7.1f}  {d['chosen']:30s} kind={d['kind']}")
    print(f"backend {out['backend']}: {out['ranks']} rank(s), transport {out['transport']}, device {out['device']}")
    print(f"kind switches: {out['kind_switches']}")
    print(f"precompile hit rate: {out['precompile_hit_rate']:.2f}  (cache: {out['cache']})")
    if out["warm_switch_latency_frac"] is not None:
        print(f"warm switch latency: median trace span = {100 * out['warm_switch_latency_frac']:.2f}% of a "
              f"{out['mean_iteration_seconds'] * 1e3:.0f} ms iteration")
    for e in out["switch_events"]:
        moved = "".join(f"; rank {r['rank']} sent {r['bytes_sent']} B, received {r['bytes_received']} B"
                        for r in e["ranks"] or [])
        print(f"switch at iteration {e['iteration']}: {e['from_plan'] or '-'} -> {e['to_plan']}, "
              f"{1e3 * e['seconds']:.1f} ms, restacked {e['restacked']}{moved}")
    print(f"model drift ratio: {out['model_drift_ratio']:.3f} ({out['drift_samples']} samples; "
          f"1.0 = perfect cost model)")
    print(f"probes run/total: {out['probe_rounds_run']}/{out['probe_rounds_total']}  "
          f"charged overhead {out['tuning_overhead_charged']:.2f}s (sim)")
    for name, p in out["per_plan"].items():
        print(f"plan {name}: {p['iterations']} iterations, step p50 {p['step_ms_p50']:.1f} ms, "
              f"K1 launches {p['flash_launches']}")
        for r, items in enumerate(p.get("per_rank_ms_p50", [])):
            print(f"  rank {r}: " + ", ".join(f"{k} {items[k]:.1f} ms" for k in RANK_ITEMS))
    print(f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
