"""Train on one card: the port of ``repro/launch/train.py``.

Two modes, as in the reference:

* ``--mode spmd`` (default) trains ``--arch`` (mamba2-780m): a train step
  that averages the loss and the gradients over ``--microbatches``
  micro-batches.  Every Mamba2 layer's forward runs the chunked SSD scan in
  kernel K2 on the card.
* ``--mode pipeline`` trains a Table-1 GPT cut into ``--stages`` stages
  under a kFkB plan of group size ``--k``: the reference pipeline engine
  walks the lowered plan tick by tick on one card (``run_pipeline``).  The
  config is overridden as the reference's ``run_pipeline`` does
  (``--layers`` layers, vocabulary 1024, fp32 compute).  Every attention
  forward runs the flash kernel K1 on the card.

Both draw synthetic token streams (``data/synthetic.py``) and train with
AdamW under a linear-warmup cosine schedule, clipping at norm 1.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      [--smoke] [--steps 100] [--batch 8] [--seq 128] [--microbatches 1] \\
      [--lr 3e-4] [--warmup 20] [--seed 0] [--log-every 10] \\
      [--device cuda] [--profile] [--out summary.json]
  PYTHONPATH=src python -m repro_torch.launch.train --mode pipeline \\
      --gpt GPT-Medium --layers 8 --stages 4 --k 2 --steps 20 --batch 8 \\
      --seq 64 --microbatches 4 [--device cuda] [--profile] [--out summary.json]

``--smoke`` trains the reduced 2-layer config; ``--device cpu`` runs on the
CPU; without ``--device`` the run needs a CUDA card and fails if there is
none.  ``--profile`` traces one more step with ``torch.profiler`` after the
run.  The reference's checkpoint flags and its auto-tuner come with their
slices.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from repro_torch.configs import mamba2_780m
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.data import SyntheticTextDataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.profiling import device_profile
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, param_count
from repro_torch.optim import linear_warmup_cosine, make_optimizer
from repro_torch.pipeline import StagedModel
from repro_torch.training import create_train_state, make_pipeline_train_step, make_train_step

__all__ = ["ARCHS", "train", "run_pipeline", "main"]

#: arch id -> (full config, smoke config, optimizer name)
ARCHS = {"mamba2-780m": (mamba2_780m.FULL, mamba2_780m.SMOKE, mamba2_780m.OPTIMIZER)}


def train(args) -> dict:
    device = resolve_device(args.device)
    full, smoke, opt_name = ARCHS[args.arch]
    cfg = smoke if args.smoke else full
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=args.seed, device=device)
    opt = make_optimizer(opt_name, linear_warmup_cosine(args.lr, args.warmup, args.steps))
    state = create_train_state(params, opt)
    step_fn = make_train_step(
        lambda p, b: api.loss_fn(p, cfg, b), opt, num_microbatches=args.microbatches
    )
    ds = SyntheticTextDataset(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    synchronize(device)
    setup = time.perf_counter() - t0

    def batch(i):
        b = ds.batch_at(i, device)
        return {"tokens": b.tokens, "labels": b.labels}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = ssd_ops.launches
    losses, grad_norms, lrs, step_seconds = [], [], [], []
    for i in range(args.steps):
        b = batch(i)
        synchronize(device)
        t = time.perf_counter()
        state, m = step_fn(state, b)
        synchronize(device)
        step_seconds.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  lr {lrs[-1]:.2e}  "
                  f"grad_norm {grad_norms[-1]:.3e}  {1e3 * step_seconds[-1]:.1f} ms", flush=True)
    launches = ssd_ops.launches - launches0
    tokens = args.batch * args.seq
    steady = step_seconds[1:] or step_seconds  # the first step also builds the kernel
    summary = {
        "arch": args.arch,
        "config": cfg.name,
        "num_layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "param_count": param_count(cfg),
        "steps": args.steps,
        "batch": args.batch,
        "seq": args.seq,
        "microbatches": args.microbatches,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "setup_seconds": setup,
        "losses": losses,
        "grad_norms": grad_norms,
        "lrs": lrs,
        "step_ms": [1e3 * s for s in step_seconds],
        "step_ms_p50": 1e3 * statistics.median(steady),
        "tokens_per_second": tokens * len(steady) / sum(steady),
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "ssd_launches": launches,
    }
    if args.profile:
        def run():
            step_fn(state, batch(args.steps))
            synchronize(device)

        t = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t)
        prof = device_profile(run, device, {"ssd": "ssd_fwd"})
        summary["profile"] = {"wall_ms": wall_ms, "device_busy_share": prof["device_ms"] / wall_ms, **prof}
    return summary


def run_pipeline(
    cfg: ModelConfig,
    stages: int,
    plan_spec: ScheduleSpec,
    *,
    steps: int,
    batch: int,
    seq: int,
    microbatches: int,
    lr: float,
    warmup: int,
    seed: int = 0,
    log_every: int = 10,
    device=None,
    profile: bool = False,
) -> dict:
    """Train ``cfg`` cut into ``stages`` devices' worth of stages under the
    plan ``plan_spec`` over ``microbatches`` micro-batches, on one card.

    Each step's ``batch`` x ``seq`` tokens are reshaped to ``[M, batch / M,
    seq]``.  Returns the run's summary (losses, step times, K1 launches,
    memory and, with ``profile``, one more step traced)."""
    device = resolve_device(device)
    M = microbatches
    if batch % M:
        raise ValueError(f"batch {batch} does not split into {M} micro-batches")
    t0 = time.perf_counter()
    plan = make_plan(stages, M, spec=plan_spec)
    staged = StagedModel.build(cfg, plan.total_virtual_stages)
    params = staged.init_all_stages(torch.Generator(device=device).manual_seed(seed))
    opt = make_optimizer("adamw", linear_warmup_cosine(lr, warmup, steps))
    state = create_train_state(params, opt)
    step_fn = make_pipeline_train_step(staged, plan, opt)
    ds = SyntheticTextDataset(cfg.vocab_size, seq, batch, seed=seed)
    synchronize(device)
    setup = time.perf_counter() - t0

    def batch_at(i):
        b = ds.batch_at(i, device)
        return b.tokens.reshape(M, batch // M, seq), b.labels.reshape(M, batch // M, seq)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = flash_ops.launches
    losses, grad_norms, lrs, step_seconds = [], [], [], []
    for i in range(steps):
        tokens, labels = batch_at(i)
        synchronize(device)
        t = time.perf_counter()
        state, m = step_fn(state, tokens, labels)
        synchronize(device)
        step_seconds.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  lr {lrs[-1]:.2e}  grad_norm "
                  f"{grad_norms[-1]:.3e}  plan {plan.name}  {1e3 * step_seconds[-1]:.1f} ms", flush=True)
    launches = flash_ops.launches - launches0
    steady = step_seconds[1:] or step_seconds  # the first step also builds the kernel
    summary = {
        "mode": "pipeline",
        "config": cfg.name,
        "num_layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "vocab_size": cfg.vocab_size,
        "param_count": param_count(cfg),
        "stages": stages,
        "virtual_stages": plan.total_virtual_stages,
        "plan": plan.name,
        "microbatches": M,
        "micro_batch_size": batch // M,
        "steps": steps,
        "batch": batch,
        "seq": seq,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "setup_seconds": setup,
        "losses": losses,
        "grad_norms": grad_norms,
        "lrs": lrs,
        "step_ms": [1e3 * s for s in step_seconds],
        "step_ms_p50": 1e3 * statistics.median(steady),
        "tokens_per_second": batch * seq * len(steady) / sum(steady),
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "flash_launches": launches,
    }
    if profile:
        def run():
            step_fn(state, *batch_at(steps))
            synchronize(device)

        t = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t)
        prof = device_profile(run, device, {"flash": "flash_fwd"})
        summary["profile"] = {"wall_ms": wall_ms, "device_busy_share": prof["device_ms"] / wall_ms, **prof}
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("spmd", "pipeline"), default="spmd")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="mamba2-780m")
    ap.add_argument("--gpt", choices=sorted(GPT_CONFIGS), default="GPT-Medium", help="pipeline mode: GPT config")
    ap.add_argument("--layers", type=int, default=8, help="pipeline mode: layers")
    ap.add_argument("--stages", type=int, default=4, help="pipeline mode: pipeline stages")
    ap.add_argument("--k", type=int, default=2, help="pipeline mode: kFkB group size")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--profile", action="store_true", help="after the run, trace one more step with torch.profiler")
    ap.add_argument("--out", default=None, help="write the summary JSON here")
    args = ap.parse_args(argv)

    if args.mode == "pipeline":
        cfg = GPT_CONFIGS[args.gpt].replace(num_layers=args.layers, vocab_size=1024, dtype=torch.float32)
        M = args.microbatches or max(args.stages, args.batch // 2)
        s = run_pipeline(
            cfg, args.stages, ScheduleSpec(kind="kfkb", k=args.k, micro_batch_size=args.batch // M),
            steps=args.steps, batch=args.batch, seq=args.seq, microbatches=M,
            lr=args.lr, warmup=args.warmup, seed=args.seed, log_every=args.log_every,
            device=args.device, profile=args.profile,
        )
        print(f"{s['config']} ({s['num_layers']} layers, d_model {s['d_model']}, {s['param_count']:,} "
              f"parameters) in {s['stages']} stages, plan {s['plan']}, on {s['device']}: step p50 "
              f"{s['step_ms_p50']:.1f} ms, {s['tokens_per_second']:,.0f} tokens/s, "
              f"{s['flash_launches']} flash kernel launches")
        kernel = "flash"
    else:
        s = train(args)
        print(f"{s['config']} ({s['num_layers']} layers, d_model {s['d_model']}, {s['param_count']:,} "
              f"parameters) on {s['device']}: step p50 {s['step_ms_p50']:.1f} ms, "
              f"{s['tokens_per_second']:,.0f} tokens/s, {s['ssd_launches']} SSD kernel launches")
        kernel = "ssd"
    if "profile" in s:
        p = s["profile"]
        print(f"profiled step: wall {p['wall_ms']:.3f} ms, device busy {p['device_ms']:.3f} ms "
              f"({100 * p['device_busy_share']:.1f}%), {kernel} kernel {p[kernel + '_ms']:.3f} ms")
        for op in p["top"]:
            print(f"  {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(s, f, indent=1)
            f.write("\n")
    losses = s["losses"]
    if not all(math.isfinite(v) for v in losses + s["grad_norms"]):
        print("non-finite loss or gradient norm")
        return 1
    if not losses[-1] < losses[0]:
        raise AssertionError("training must reduce loss")
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
