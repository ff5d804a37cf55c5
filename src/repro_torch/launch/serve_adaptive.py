"""Adaptive decode serving under the Fig-10 preemption regimes, end to end.

Port of ``repro/launch/serve_adaptive.py``.  Serving is where the paper's
adaptation argument is sharpest: a per-token decode step is memory-bound,
so a preempted cross-stage link does not shave a few percent off an
iteration; it IS the token latency.  This entry point drives the
:class:`~repro_torch.serve.runtime.ServeRuntime` tick loop through the same
bursty -> exclusive -> bursty regime world as ``launch/train_adaptive``,
with:

* seeded bursty **arrivals** (Markov-modulated Poisson) feeding a
  continuous batcher over fixed decode slots;
* the unmodified :class:`~repro_torch.core.tuner.AutoTuner` re-deciding
  ``ScheduleSpec`` (kind and k) live, under the serving objective
  (:func:`~repro_torch.serve.runtime.make_slo_objective`): SLO-weighted
  makespan, pure throughput when the queue is deep, per-token latency when
  it is slack;
* tick timings feeding the profiler windows passively through the
  telemetry bus (``source="serve"``), so retuning rarely suspends the batch;
* TTFT/TPOT/token-latency histograms and per-slot request spans.

The headline comparison: adaptive serving against a static 1F1B decode
pipeline on identical seeds (p99 token latency, SLO attainment, and a
decision trail that crosses schedule kinds and differs between the
preempted and the exclusive regime).  Ticks are priced on the simulated
clock from the committed decode and prefill workload profiles joined with a
device spec (``--device-spec``, by default ``h100-sxm``, the card the port
runs on), so every decision and every simulated quantile is the same with
and without an engine.

``--engine`` makes the tokens real: each of the two runs gets its own
:class:`~repro_torch.serve.engine.ServeEngine` (``--config``, the same
weights from ``--seed``; 4 stages, 8 slots, ``max_len`` 80, as
``examples/serve_decode.py`` builds it) on ``--device``, every prefill
through the flash kernel on the card, every decision of the tuner
dispatched to the engine through ``PlanRuntime``'s stateless warm-switch
path.  The summary then also carries the measured wall-clock keys.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_adaptive \\
      [--requests 80] [--regime fig10] [--seed 0] [--device-spec h100-sxm] \\
      [--engine [--config GPT-2.7B] [--tiny]] [--device cuda] \\
      [--out serve.json] [--trace trace.json]

``REPRO_SMOKE=1`` shrinks the run for smoke jobs.  Without ``--device`` the
run needs a CUDA card and fails if there is none; ``--device cpu`` runs on
the CPU (with ``--tiny`` for the engine).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import weakref

import torch

from repro_torch.configs.base import ALL_ARCH_IDS, get_arch
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import (
    AutoTuner,
    BurstyTrace,
    Candidate,
    Network,
    NetworkProfiler,
    RegimeTrace,
    StableTrace,
    StageCosts,
)
from repro_torch.core.devicespec import (
    derive_stage_costs,
    load_device_spec,
    load_workload_profile,
    spec_root,
)
from repro_torch.device import resolve_device
from repro_torch.launch.train_adaptive import fig10_parts
from repro_torch.models.common import ModelConfig
from repro_torch.obs import Observability
from repro_torch.runtime import PassiveLinkFeed, TelemetryBus
from repro_torch.serve import ArrivalProcess, ServeEngine, ServeRuntime, SLOTracker, make_slo_objective

__all__ = [
    "TTFT_SLO",
    "TPOT_SLO",
    "FREE_BW",
    "EXCLUSIVE_BW",
    "CONTENDED_FRAC",
    "DEVICE_SPEC",
    "ENGINE_ARGS",
    "TINY",
    "CONFIG_NAMES",
    "build_config",
    "serve_costs",
    "build_serve_network",
    "ServeScenario",
    "build_serve_scenario",
    "compare_adaptive_static",
    "chosen_specs_by_regime",
    "main",
]

#: serving targets the attainment gate holds: time-to-first-token and
#: time-per-output-token on the simulated clock
TTFT_SLO = 1.0
TPOT_SLO = 0.05

#: serve-network bandwidths (bytes/s against the decode workload's 8 KB
#: per-token activation handoffs): an exclusive wire moves one in ~40 µs, a
#: free-but-shared wire in ~0.3 ms, a preempted one in ~5 ms (the
#: latency-dominated regime the paper's Fig-10 serving argument lives in)
FREE_BW = 2.7e7
EXCLUSIVE_BW = 2.0e8
CONTENDED_FRAC = 0.06

#: the spec file (``specs/<name>.json``) the port prices ticks on: the card it runs on
DEVICE_SPEC = "h100-sxm"
#: the engine ``--engine`` builds (``examples/serve_decode.py``'s)
ENGINE_ARGS = dict(num_stages=4, max_slots=8, max_len=80)
#: the narrow GPT variant ``--tiny`` serves: 2 layers, head_dim 80 kept
#: (an arch id's ``--tiny`` is its registered smoke config)
TINY = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)
#: the names the serving entry points take: the Table-1 GPTs and every arch
#: id the port builds
CONFIG_NAMES = (*GPT_CONFIGS, *ALL_ARCH_IDS)


def build_config(name: str, tiny: bool = False) -> ModelConfig:
    if name in GPT_CONFIGS:
        return GPT_CONFIGS[name].replace(**TINY) if tiny else GPT_CONFIGS[name]
    spec = get_arch(name)
    return spec.smoke if tiny else spec.model


def serve_costs(device: str = "tpu-v5e") -> tuple[StageCosts, StageCosts]:
    """(decode, prefill) stage costs: the committed workload profiles joined
    against a committed device spec, serving priced offline, per part."""
    spec = load_device_spec(os.path.join(spec_root(), f"{device}.json"))
    root = os.path.join(spec_root(), "workloads")
    decode = derive_stage_costs(
        load_workload_profile(os.path.join(root, "pinned-4stage-decode.json")), spec
    )
    prefill = derive_stage_costs(
        load_workload_profile(os.path.join(root, "pinned-4stage-prefill.json")), spec
    )
    return decode, prefill


def build_serve_network(
    num_stages: int, regime: str = "fig10", hour: float = 4.0, seed: int = 0
) -> Network:
    """``regime``: "fig10" (bursty -> exclusive -> bursty), "bursty"
    (preempted throughout), or "exclusive" (quiet throughout)."""

    def bursty(ss: int) -> BurstyTrace:
        # preemption-dominated dwell times: during a preempted regime the
        # link spends most wall clock contended, so every plan reliably sees
        # the degraded wire (the adaptation signal, not boundary luck)
        return BurstyTrace(
            FREE_BW, contended_frac=CONTENDED_FRAC,
            mean_free=0.25, mean_contended=2.5, seed=ss,
        )

    def link(a: int, c: int):
        s = 17 * a + c + 100 * seed
        if regime == "bursty":
            return bursty(s)
        if regime == "exclusive":
            return StableTrace(EXCLUSIVE_BW)
        return RegimeTrace(
            [hour, 2 * hour], [bursty(s), StableTrace(EXCLUSIVE_BW), bursty(s + 7)]
        )

    return Network.build(num_stages, link)


@dataclasses.dataclass
class ServeScenario:
    """One wired serving world (candidates, network, tuner, tick loop)."""

    cfg: ModelConfig
    candidates: list[Candidate]
    decode_costs: StageCosts
    prefill_costs: StageCosts
    network: Network
    tuner: AutoTuner
    runtime: ServeRuntime
    slo: SLOTracker
    bus: TelemetryBus
    obs: Observability


def build_serve_scenario(
    num_stages: int = 4,
    regime: str = "fig10",
    hour: float = 4.0,
    seed: int = 0,
    rate: float = 6.0,
    burst_factor: float = 3.0,
    max_slots: int = 8,
    retune_interval: float | None = 0.25,
    tuning_overhead: float = 0.02,
    passive_staleness: float | None = 2.0,
    latency_weight: float = 2.0,
    adaptive: bool = True,
    engine=None,
    obs: Observability | None = None,
    track: str = "host0",
    device_spec: str = DEVICE_SPEC,
    arrivals: ArrivalProcess | None = None,
    candidates: list[Candidate] | None = None,
) -> ServeScenario:
    """The seeded serving scenario shared by the entry points and the tests.

    ``adaptive=False`` builds the static baseline: the same arrivals, the
    same network, the same costs, but a single 1F1B candidate and no
    retuning (``retune_interval=None``), so every difference in the summary
    is the adaptive loop's doing.  ``device_spec`` names the spec file the
    ticks are priced on.  ``arrivals`` and ``candidates`` replace the
    scenario's (``launch/serve_decode``'s own traffic and grid); the static
    baseline keeps the first candidate.
    """
    cfg, _train_costs, cands, _B = fig10_parts(num_stages)
    if candidates is not None:
        cands = list(candidates)
    decode_costs, prefill_costs = serve_costs(device_spec)
    net = build_serve_network(num_stages, regime=regime, hour=hour, seed=seed)
    if not adaptive:
        cands = cands[:1]  # kfkb k=1: the static 1F1B decode pipeline
        retune_interval = None
    profiler = NetworkProfiler(net, window=4)
    obs = obs or Observability.create()
    bus = TelemetryBus(metrics=obs.metrics)
    bus.subscribe(PassiveLinkFeed(profiler, sources=("serve",)))
    if arrivals is None:
        arrivals = ArrivalProcess(
            rate, seed=seed, burst_factor=burst_factor,
            mean_calm=1.5, mean_burst=0.6,
            prompt_len=(16, 16), new_tokens=(16, 48),
        )
    slo = SLOTracker(
        obs.metrics, trace=obs.trace, track=f"{track}/requests",
        ttft_slo=TTFT_SLO, tpot_slo=TPOT_SLO,
    )
    # the objective needs the runtime's live queue pressure, the runtime
    # needs the tuner: late-bind through a box, weakly, so that the runtime
    # (and the engine it drives) is freed without a garbage collection
    box: dict = {}
    objective = (
        make_slo_objective(lambda: box["rt"]().queue_pressure(), latency_weight)
        if adaptive
        else None
    )
    tuner = AutoTuner(
        cands, lambda c: decode_costs, profiler,
        passive_staleness=passive_staleness,
        flight=obs.flight, metrics=obs.metrics, objective=objective,
    )
    rt = ServeRuntime(
        tuner, net, arrivals, slo, max_slots,
        decode_costs_for=lambda c: decode_costs,
        prefill_costs_for=lambda c: prefill_costs,
        telemetry_sink=bus,
        retune_interval=retune_interval,
        tuning_overhead=tuning_overhead,
        engine=engine, obs=obs, track=track,
    )
    box["rt"] = weakref.ref(rt)
    return ServeScenario(
        cfg=cfg, candidates=cands, decode_costs=decode_costs,
        prefill_costs=prefill_costs, network=net, tuner=tuner, runtime=rt,
        slo=slo, bus=bus, obs=obs,
    )


def compare_adaptive_static(
    max_requests: int = 80,
    regime: str = "fig10",
    seed: int = 0,
    device_spec: str = DEVICE_SPEC,
    engines: tuple[ServeEngine, ServeEngine] | None = None,
) -> dict:
    """The headline experiment, defined once for the entry point and the
    tests: adaptive serving vs the static 1F1B decode baseline on identical
    seeds (same arrivals, same network traces), p99 token latency head to
    head.  ``engines`` (adaptive, static) run the real tokens of each run;
    then the result also holds whether every request both runs completed
    has the same first token (``first_tokens_equal``: prefill is batch 1 and
    plan-independent) and the share whose whole output agrees."""
    eng_a, eng_s = engines or (None, None)
    adaptive = build_serve_scenario(
        regime=regime, seed=seed, adaptive=True, engine=eng_a, device_spec=device_spec
    )
    static = build_serve_scenario(
        regime=regime, seed=seed, adaptive=False, engine=eng_s, device_spec=device_spec
    )
    a = adaptive.runtime.run(max_requests)
    s = static.runtime.run(max_requests)
    a_p99, s_p99 = a["token_latency_p99"], s["token_latency_p99"]
    out = {
        "adaptive": a,
        "static": s,
        # >1.0 means adaptive serves the p99 token faster than static 1F1B
        "p99_ratio_vs_static": (s_p99 / a_p99) if a_p99 else 0.0,
        "kind_diversity": len(a["kinds_chosen"]),
        "slo_attainment": a["slo_attainment"],
        "no_overlap_tracks": _validated_tracks(adaptive),
    }
    if engines is not None:
        rids = sorted(
            {inf.request.rid for inf in adaptive.runtime.completed}
            & {inf.request.rid for inf in static.runtime.completed}
        )
        out["requests_completed_by_both"] = len(rids)
        out["first_tokens_equal"] = all(eng_a.outputs[r][0] == eng_s.outputs[r][0] for r in rids)
        out["outputs_equal_share"] = (
            sum(eng_a.outputs[r] == eng_s.outputs[r] for r in rids) / len(rids) if rids else 0.0
        )
    return out


def _validated_tracks(sc: ServeScenario) -> int:
    """Run the no-overlap trace gate over every serving track (per-slot
    request lanes and the tick lane); returns the track count."""
    from repro_torch.obs.trace import spans_by_track, validate_no_overlap

    payload = sc.obs.trace.to_chrome_trace()
    validate_no_overlap(payload, track_prefix=sc.runtime.track)
    return sum(
        1 for t in spans_by_track(payload) if t.startswith(sc.runtime.track)
    )


def chosen_specs_by_regime(
    max_requests: int = 40, seed: int = 0, device_spec: str = DEVICE_SPEC
) -> dict:
    """Majority-chosen ScheduleSpec under a preempted vs an exclusive
    network: the "the tuner chooses differently" observable."""
    out = {}
    for regime in ("bursty", "exclusive"):
        sc = build_serve_scenario(regime=regime, seed=seed, adaptive=True, device_spec=device_spec)
        sc.runtime.run(max_requests)
        trail = [r.chosen for r in sc.tuner.history]
        majority = max(set(trail), key=trail.count) if trail else None
        out[regime] = {
            "majority": majority,
            "final": trail[-1] if trail else None,
            "trail": trail,
            "final_spec": (
                dataclasses.asdict(sc.tuner.history[-1].chosen_spec)
                if sc.tuner.history and sc.tuner.history[-1].chosen_spec
                else None
            ),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=80)
    ap.add_argument("--regime", choices=("fig10", "bursty", "exclusive"), default="fig10")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-spec", default=DEVICE_SPEC, help="the specs/<name>.json ticks are priced on")
    ap.add_argument("--engine", action="store_true", help="serve real tokens through a ServeEngine per run")
    ap.add_argument("--config", choices=CONFIG_NAMES, default="GPT-2.7B")
    ap.add_argument("--tiny", action="store_true", help="the config's narrow 2-layer variant, for CPU runs")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the comparison JSON here")
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="write a Chrome/Perfetto trace of the adaptive run (per-slot "
        "request lanes, tick lane, tuner decisions)",
    )
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if os.environ.get("REPRO_SMOKE"):
        args.requests = min(args.requests, 24)

    t0 = time.time()
    engines = None
    if args.engine:
        cfg = build_config(args.config, args.tiny)
        first = ServeEngine(cfg, seed=args.seed, device=device, **ENGINE_ARGS)
        # the static run serves the same weights (cast once, shared)
        engines = (first, ServeEngine(cfg, params=first.params, device=device, **ENGINE_ARGS))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    out = compare_adaptive_static(
        max_requests=args.requests, regime=args.regime, seed=args.seed,
        device_spec=args.device_spec, engines=engines,
    )
    out["regime_divergence"] = chosen_specs_by_regime(
        max_requests=max(12, args.requests // 3), seed=args.seed, device_spec=args.device_spec
    )
    out["device_spec"] = args.device_spec
    if engines is not None:
        out.update(
            config=cfg.name,
            num_layers=cfg.num_layers,
            d_model=cfg.d_model,
            device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            max_memory_allocated=(
                torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
            ),
            outputs={
                run: {str(rid): toks for rid, toks in sorted(e.outputs.items())}
                for run, e in zip(("adaptive", "static"), engines)
            },
        )
    out["wall_seconds"] = round(time.time() - t0, 2)

    a, s = out["adaptive"], out["static"]
    print(f"regime {args.regime}: {args.requests} requests, seed {args.seed}, "
          f"ticks priced on specs/{args.device_spec}.json (simulated clock)")
    print("decision trail (adaptive):")
    for d in a["decision_trail"]:
        print(f"  t={d['t']:8.3f}  {d['chosen']:30s} kind={d['kind']}")
    print(
        f"token latency p99 (simulated): adaptive {a['token_latency_p99']*1e3:.1f} ms vs "
        f"static {s['token_latency_p99']*1e3:.1f} ms "
        f"(ratio {out['p99_ratio_vs_static']:.2f}x)"
    )
    print(
        f"ttft p99 (simulated): adaptive {a['ttft_p99']*1e3:.1f} ms vs "
        f"static {s['ttft_p99']*1e3:.1f} ms"
    )
    print(
        f"slo attainment (simulated): adaptive {a['slo_attainment']:.2f} vs "
        f"static {s['slo_attainment']:.2f} "
        f"(ttft<={TTFT_SLO}s, tpot<={TPOT_SLO}s)"
    )
    print(
        f"kinds chosen: {a['kinds_chosen']} "
        f"(diversity {out['kind_diversity']})"
    )
    for regime, info in out["regime_divergence"].items():
        print(f"  {regime:10s} majority={info['majority']} final={info['final']}")
    ok = True
    if engines is not None:
        print(f"engine {out['config']} ({out['num_layers']} layers, d_model {out['d_model']}) on {out['device']}:")
        for run in ("adaptive", "static"):
            r = out[run]
            per_plan = ", ".join(f"{n} {ms:.3f}" for n, ms in r["decode_tick_ms_p50_by_plan"].items())
            print(f"  {run}: prefill p50 {r['prefill_ms_p50']:.3f} ms, decode tick p50 "
                  f"{r['decode_tick_ms_p50']:.3f} ms ({per_plan}), {r['tokens_per_second_wall']:.1f} "
                  f"tokens/s (wall), {len(r['switch_seconds'])} switches, cache {r['compile_cache']}")
            ok = ok and r["requests_completed_exactly"] == r["requests_completed"] >= args.requests
            ok = ok and not r["nonfinite_logits"]
        print(f"  first tokens equal {out['first_tokens_equal']}, whole outputs equal in "
              f"{100 * out['outputs_equal_share']:.0f}% of the {out['requests_completed_by_both']} "
              f"requests both runs completed")

    if args.trace:
        sc = build_serve_scenario(regime=args.regime, seed=args.seed, adaptive=True, device_spec=args.device_spec)
        sc.runtime.run(args.requests)
        sc.obs.trace.save(args.trace)
        print(f"wrote trace {os.path.abspath(args.trace)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
            f.write("\n")
        print(f"wrote {os.path.abspath(args.out)}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
