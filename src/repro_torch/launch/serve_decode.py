"""Serve a model with continuous batching on the card.

Seeded arrivals feed a continuous batcher over fixed decode slots; each
admitted request is prefilled in one fused pass (flash-attention kernel on
the card for every attention layer; the Mamba2 recurrence for mamba2-780m's
layers and jamba's Mamba layers) and then decoded greedily in the grouped
``[M, b]`` grid (an MoE layer routes each row of a group as its own group).  The tick loop is
:class:`~repro_torch.serve.runtime.ServeRuntime` under ``repro``'s static
baseline: one ``kfkb`` k = 1 plan of ``--microbatches`` groups, no retune,
every tick priced on the simulated clock by ``simulate_plan`` on the Fig-10
serving network (``launch/serve_adaptive``, ``specs/h100-sxm.json``).  So
the admissions are the same on every device; the wall time of every tick is
measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
      [--config GPT-2.7B|qwen2.5-14b|gemma3-12b|...] [--slots 8] [--microbatches 4] \\
      [--requests 16] [--prompt-len 128 512] [--new-tokens 16 48] \\
      [--max-len 576] [--seed 0] [--device cuda] [--out summary.json]

``--config`` takes a Table-1 GPT or any arch id of the registry
(``configs.base.ALL_ARCH_IDS``, the MoE and hybrid archs included; the
encoder-decoder and vision-language archs raise ``NotImplementedError``,
as the reference's serve engine does).
``--tiny`` swaps in a narrow 2-layer variant of the configuration (an arch
id's smoke config) for a quick CPU run (``--device cpu``).  Without
``--device`` the run needs a CUDA card and fails if there is none.
``serve(args, num_layers=...)`` cuts the depth (a caller's, e.g. a run of a
large arch on one card; no flag sets it).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import Candidate, ScheduleSpec, make_plan
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.profiling import device_profile
from repro_torch.launch.serve_adaptive import CONFIG_NAMES, ENGINE_ARGS, build_config, build_serve_scenario
from repro_torch.models.common import layer_specs
from repro_torch.serve import ArrivalProcess, InFlight, Request, ServeEngine
from repro_torch.tree import flatten

__all__ = ["static_candidate", "where_time_goes", "serve", "build_parser", "main"]

#: arrivals per simulated second
RATE = 4.0
#: the pipeline depth the decode plan is priced at
NUM_STAGES = ENGINE_ARGS["num_stages"]


def static_candidate(num_stages: int, slots: int, microbatches: int) -> Candidate:
    """``repro``'s static decode baseline: 1F1B (kfkb k = 1) over an
    ``[M, slots / M]`` grid."""
    if microbatches <= 0 or slots % microbatches:
        raise ValueError(f"M={microbatches} must divide the {slots} slots")
    b = slots // microbatches
    spec = ScheduleSpec(kind="kfkb", k=1, micro_batch_size=b)
    return Candidate(1, b, microbatches, make_plan(num_stages, microbatches, spec=spec), 0.0)


def where_time_goes(engine, prompt_len: int) -> dict:
    """Wall time (profiler off) and device time (profiler on) of one decode
    tick and one prefill of ``prompt_len`` tokens, run on the engine after
    serving.  A decode tick computes every slot, occupied or not, so its cost
    does not depend on the occupancy the run ended with."""
    probe = InFlight(Request(-1, 0.0, prompt_len, 1), slot=0, admit_time=0.0)
    phases = {
        "decode_tick": lambda: engine.decode_tick([]),
        f"prefill_{prompt_len}": lambda: engine.prefill([probe]),
    }
    out = {}
    for name, work in phases.items():
        def run():
            work()
            engine.synchronize()

        run()  # warm-up
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof = device_profile(run, engine.device, {"flash": "flash_fwd"})
        out[name] = {"wall_ms": wall_ms, "device_busy_share": prof["device_ms"] / wall_ms, **prof}
    engine.outputs.pop(-1)
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree).values())


def serve(args, num_layers: int | None = None) -> dict:
    """Serve ``args``' requests (``build_parser()``'s arguments);
    ``num_layers`` cuts the config's depth."""
    device = resolve_device(args.device)
    cfg = build_config(args.config, args.tiny)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if args.prompt_len[1] + args.new_tokens[1] - 1 > args.max_len:
        raise ValueError("--max-len must hold the longest prompt plus its new tokens")
    cand = static_candidate(NUM_STAGES, args.slots, args.microbatches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, NUM_STAGES, args.slots, args.max_len, seed=args.seed, device=device)
    engine.synchronize()
    setup = time.perf_counter() - t0
    arrivals = ArrivalProcess(
        RATE, seed=args.seed,
        prompt_len=tuple(args.prompt_len), new_tokens=tuple(args.new_tokens),
    )
    sc = build_serve_scenario(
        seed=args.seed, max_slots=args.slots, adaptive=False, engine=engine,
        arrivals=arrivals, candidates=[cand],
    )
    # the engine's setup peak (drawing and casting the weights) before the
    # serving peak is taken on its own
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = flash_ops.launches
    summary = sc.runtime.run(args.requests)
    launches = flash_ops.launches - launches0
    summary.update(
        config=cfg.name,
        num_layers=cfg.num_layers,
        attention_layers=sum(spec.kind == "attn" for spec in layer_specs(cfg)),
        d_model=cfg.d_model,
        requests=args.requests,
        slots=args.slots,
        grid=[cand.num_microbatches, cand.micro_batch_size],
        plan=cand.name,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        setup_seconds=setup,
        weight_bytes=_nbytes(engine.params),
        cache_bytes=_nbytes(engine.cache),
        setup_max_memory_allocated=setup_peak,
        flash_launches=launches,
        max_memory_allocated=(
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        outputs={str(rid): toks for rid, toks in sorted(engine.outputs.items())},
    )
    if args.profile:
        summary["profile"] = where_time_goes(engine, args.prompt_len[1])
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=CONFIG_NAMES, default="GPT-2.7B")
    ap.add_argument("--tiny", action="store_true", help="narrow 2-layer variant for CPU runs")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4, help="M of the [M, b] decode grid")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(128, 512), metavar=("LO", "HI"))
    ap.add_argument("--new-tokens", type=int, nargs=2, default=(16, 48), metavar=("LO", "HI"))
    ap.add_argument("--max-len", type=int, default=576)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument(
        "--profile", action="store_true",
        help="after serving, trace one decode tick and one longest-prompt prefill with torch.profiler",
    )
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    s = serve(args)
    print(
        f"{s['config']} ({s['num_layers']} layers, d_model {s['d_model']}) on {s['device']}: "
        f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']} tokens, "
        f"{s['ticks']} ticks ({s['prefill_ticks']} prefill, {s['decode_ticks']} decode)"
    )
    print(
        f"prefill p50 {s['prefill_ms_p50']:.3f} ms, decode tick p50 {s['decode_tick_ms_p50']:.3f} ms, "
        f"{s['tokens_per_second_wall']:.1f} tokens/s (wall), sim time {s['sim_time']:.3f} s"
    )
    for name, p in s.get("profile", {}).items():
        print(f"{name}: wall {p['wall_ms']:.3f} ms, device busy {p['device_ms']:.3f} ms "
              f"({100 * p['device_busy_share']:.1f}%), flash kernel {p['flash_ms']:.3f} ms")
        for op in p["top"]:
            print(f"  {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(s, f, indent=1)
            f.write("\n")
    # one boundary may retire several requests, so the run can end past the count
    ok = s["requests_completed"] >= args.requests and not s["nonfinite_logits"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
