"""Serve a GPT configuration with continuous batching on the card.

Seeded arrivals feed a continuous batcher over fixed decode slots; each
admitted request is prefilled in one fused pass (flash-attention kernel on
the card) and then decoded greedily in the grouped ``[M, b]`` grid.  The
simulated clock advances by fixed prices per tick, so the admissions are the
same on every device; the wall time of every tick is measured.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_decode \\
      [--config GPT-2.7B] [--slots 8] [--microbatches 4] \\
      [--requests 16] [--prompt-len 128 512] [--new-tokens 16 48] \\
      [--max-len 576] [--seed 0] [--device cuda] [--out summary.json]

``--tiny`` swaps in a narrow 2-layer variant of the configuration for a
quick CPU run (``--device cpu``).  Without ``--device`` the run needs a CUDA
card and fails if there is none.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.device import resolve_device
from repro_torch.launch.profiling import device_profile
from repro_torch.serve import ArrivalProcess, InFlight, Request, ServeEngine, ServeRuntime

__all__ = ["TINY", "build_config", "serve", "main"]

#: the narrow variant ``--tiny`` runs: 2 layers, head_dim 80 kept
TINY = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)
#: arrivals per simulated second, and the simulated price of each tick
RATE = 4.0
PRICES = {"prefill": 0.05, "decode": 0.02}


def build_config(args):
    cfg = GPT_CONFIGS[args.config]
    if args.tiny:
        cfg = cfg.replace(**TINY)
    return cfg


def _where_time_goes(engine, prompt_len: int) -> dict:
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


def serve(args) -> dict:
    device = resolve_device(args.device)
    cfg = build_config(args)
    if args.prompt_len[1] + args.new_tokens[1] - 1 > args.max_len:
        raise ValueError("--max-len must hold the longest prompt plus its new tokens")
    t0 = time.perf_counter()
    engine = ServeEngine(cfg, args.slots, args.max_len, seed=args.seed, device=device)
    engine.synchronize()
    setup = time.perf_counter() - t0
    arrivals = ArrivalProcess(
        RATE, seed=args.seed,
        prompt_len=tuple(args.prompt_len), new_tokens=tuple(args.new_tokens),
    )
    runtime = ServeRuntime(engine, arrivals, PRICES.__getitem__, args.microbatches)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    summary = runtime.run(args.requests)
    summary.update(
        config=cfg.name,
        num_layers=cfg.num_layers,
        d_model=cfg.d_model,
        requests=args.requests,
        slots=args.slots,
        grid=[args.microbatches, args.slots // args.microbatches],
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        setup_seconds=setup,
        max_memory_allocated=(
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        outputs={str(rid): toks for rid, toks in sorted(engine.outputs.items())},
    )
    if args.profile:
        summary["profile"] = _where_time_goes(engine, args.prompt_len[1])
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", choices=sorted(GPT_CONFIGS), default="GPT-2.7B")
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
    args = ap.parse_args(argv)

    s = serve(args)
    print(
        f"{s['config']} ({s['num_layers']} layers, d_model {s['d_model']}) on {s['device']}: "
        f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']} tokens, "
        f"{s['ticks']} ticks ({s['prefill_ticks']} prefill, {s['decode_ticks']} decode)"
    )
    print(
        f"prefill p50 {s['prefill_ms_p50']:.3f} ms, decode tick p50 {s['decode_tick_ms_p50']:.3f} ms, "
        f"{s['tokens_per_second']:.1f} tokens/s (wall), sim time {s['sim_time']:.3f} s"
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
    ok = s["requests_completed"] == args.requests and not s["nonfinite_logits"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
