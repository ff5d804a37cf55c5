"""Train on one card, or on one process per pipeline stage: the port of
``repro/launch/train.py``.

Two modes, as in the reference:

* ``--mode spmd`` (default) trains ``--arch``, any architecture of the
  registry (``configs.base.ALL_ARCH_IDS``: kimi-k2-1t-a32b,
  llama4-maverick-400b-a17b, seamless-m4t-medium, qwen2.5-14b,
  internlm2-20b, gemma3-12b, qwen2-vl-2b, jamba-v0.1-52b, qwen1.5-4b and
  mamba2-780m, the default), with the optimizer its ``ArchSpec`` names
  (Adafactor for kimi-k2 and llama4, in the reference's stacked layout;
  AdamW for the rest): a train step that averages the loss and the
  gradients over ``--microbatches`` micro-batches on one device, as the
  reference's ``--mode spmd`` runs its pjit step on a one-device mesh.
  The sharded step over many devices is
  :func:`repro_torch.distributed.spmd.make_spmd_train_step` (one process a
  device through ``pipeline.ranks.spawn``), reached from the library, as
  the reference's is: neither launcher has a flag for it.  Every full-sequence attention's forward runs the flash kernel
  K1 on the card (an encoder's bidirectional self-attention and the
  decoder's cross attention included), every Mamba2 layer's the chunked
  SSD scan in kernel K2.  The batch is built as the reference's
  ``_batch_dict`` builds it: the encoder-decoder's ``src_embeds`` are the
  dataset's frame embeddings (``max(seq // 8, 1)`` of them), the VLM's
  ``embeds`` its patch embeddings (``seq`` of them) with three equal
  M-RoPE position streams.  ``--ckpt-dir`` resumes from the latest
  checkpoint there (``checkpoint/io.py``) and saves every
  ``--ckpt-every`` steps and at the end, as the reference does.
* ``--mode pipeline`` trains a Table-1 GPT cut into ``--stages`` stages
  under a kFkB plan of group size ``--k``, as the reference's
  ``run_pipeline`` runs ``make_pipeline_step``: one process per stage
  (``pipeline/ranks.py``), each walking its own row of the lowered plan
  and exchanging activations and gradients point to point
  (``pipeline.engine.make_pipeline_step``).  The parent builds the kernels
  once, then spawns the ranks; each rank draws only its own stages from
  the seed; rank 0 prints the log.  The transport is NCCL when every rank
  has a card of its own, else gloo through pinned host buffers (one card:
  the ranks time-slice it).  The config is overridden as the reference's
  ``run_pipeline`` does (``--layers`` layers, vocabulary 1024, fp32
  compute).  Every attention forward runs the flash kernel K1 on the card.
  ``run_pipeline(..., engine="reference")`` runs the one-process reference
  engine instead (a send is a dict entry).

Both draw synthetic token streams (``data/synthetic.py``) and train under a
linear-warmup cosine schedule, clipping at norm 1 (the pipeline with AdamW).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m|qwen1.5-4b|... \\
      [--smoke] [--steps 100] [--batch 8] [--seq 128] [--microbatches 1] \\
      [--lr 3e-4] [--warmup 20] [--seed 0] [--log-every 10] \\
      [--ckpt-dir DIR] [--ckpt-every 0] \\
      [--device cuda] [--profile] [--out summary.json]
  PYTHONPATH=src python -m repro_torch.launch.train --mode pipeline \\
      --gpt GPT-Medium --layers 8 --stages 4 --k 2 --steps 20 --batch 8 \\
      --seq 64 --microbatches 4 [--device cuda] [--out summary.json]

``--smoke`` trains the reduced 2-layer config; ``--device cpu`` runs on the
CPU (the pipeline ranks under gloo); without ``--device`` the run needs a
CUDA card and fails if there is none.  ``--profile`` traces one more step
with ``torch.profiler`` after the run (under ``--mode pipeline``, rank 0's
share of it).  The reference's auto-tuner in ``--mode pipeline`` comes
with its slice.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs.base import ALL_ARCH_IDS, get_arch
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.data import SyntheticTextDataset
from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch.profiling import device_profile
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, param_count
from repro_torch.optim import linear_warmup_cosine, make_optimizer
from repro_torch.pipeline import StagedModel, ranks
from repro_torch.tree import flatten
from repro_torch.training import (
    TrainState,
    create_train_state,
    make_pipeline_train_step,
    make_train_step,
    pipeline_train_step,
)

__all__ = ["train", "dataset", "run_pipeline", "main"]


def _steady(xs: list) -> list:
    """The steps a p50 reads: all but the first, which also loads the kernels."""
    return xs[1:] or xs


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _profile(run, device: torch.device, kernels: dict) -> dict:
    """Time ``run()`` (which ends in a synchronise), then trace it once more
    with ``torch.profiler``."""
    t = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t)
    prof = device_profile(run, device, kernels)
    return {"wall_ms": wall_ms, "device_busy_share": prof["device_ms"] / wall_ms, **prof}


def _batch_dict(cfg: ModelConfig, batch) -> dict:
    """The model API's batch from a dataset batch, as the reference's
    ``_batch_dict``: zeros stand in for frontend embeddings the dataset did
    not draw."""
    B, T = batch.tokens.shape
    dev = batch.tokens.device
    if cfg.family == "encdec":
        S = max(T // 8, 1)
        return {
            "src_embeds": (batch.embeds if batch.embeds is not None
                           else torch.zeros((B, S, cfg.d_model), dtype=torch.float32, device=dev)),
            "tgt_tokens": batch.tokens,
            "labels": batch.labels,
        }
    if cfg.family == "vlm":
        return {
            "embeds": (batch.embeds if batch.embeds is not None
                       else torch.zeros((B, T, cfg.d_model), dtype=torch.float32, device=dev)),
            "labels": batch.labels,
            "mrope_positions": torch.arange(T, dtype=torch.int32, device=dev).expand(3, B, T),
        }
    return {"tokens": batch.tokens, "labels": batch.labels}


def _leaf_norms(params) -> list:
    """Each parameter leaf's L2 norm, summed in fp64 a slice at a time."""
    return [
        math.sqrt(sum(float(c.double().square().sum()) for c in t.detach().reshape(-1).split(1 << 26)))
        for t in flatten(params).values()
    ]


def train(args, num_layers: int | None = None, num_experts: int | None = None) -> tuple[dict, TrainState]:
    """``--mode spmd``'s run; ``num_layers`` cuts the config's depth and
    ``num_experts`` its expert count (top-k kept; a caller's, e.g. a smoke
    run on one card; no flag sets them).  Returns the run's summary and its
    state at the end (updated in place by every step: with ``--profile``,
    by the two traced steps too).  A run resumed at or past ``--steps``
    takes no step and saves nothing: its summary has no losses and no step
    times."""
    device = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.model
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if num_experts is not None:
        cfg = cfg.replace(num_experts=num_experts)
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=args.seed, device=device)
    opt = make_optimizer(
        spec.optimizer, linear_warmup_cosine(args.lr, args.warmup, args.steps),
        layout=tf.reference_layout(cfg, params),
    )
    state = create_train_state(params, opt)
    ckpt_dir, resumed_from = getattr(args, "ckpt_dir", None), None
    if ckpt_dir and (resumed_from := latest_step(ckpt_dir)) is not None:
        state = load_checkpoint(ckpt_dir, resumed_from, state)
        print(f"resumed from step {resumed_from}", flush=True)
    step_fn = make_train_step(
        lambda p, b: api.loss_fn(p, cfg, b), opt, num_microbatches=args.microbatches
    )
    ds = dataset(cfg, args)
    synchronize(device)
    setup = time.perf_counter() - t0

    def batch(i):
        return _batch_dict(cfg, ds.batch_at(i, device))

    first = state.step
    norms0 = _leaf_norms(state.params)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0, flash0, k1_0 = ssd_ops.launches, flash_ops.launches, dict(attn.k1_launches)
    losses, grad_norms, lrs, step_seconds, aux = [], [], [], [], {"moe_load_balance": [], "moe_router_z": []}
    for i in range(first, args.steps):
        b = batch(i)
        synchronize(device)
        t = time.perf_counter()
        state, m = step_fn(state, b)
        synchronize(device)
        step_seconds.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        for k, v in aux.items():  # the MoE terms (a step of one micro-batch reports them)
            if k in m:
                v.append(float(m[k]))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {losses[-1]:.4f}  lr {lrs[-1]:.2e}  "
                  f"grad_norm {grad_norms[-1]:.3e}  {1e3 * step_seconds[-1]:.1f} ms", flush=True)
        if ckpt_dir and getattr(args, "ckpt_every", 0) and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, state)
    if ckpt_dir and step_seconds and latest_step(ckpt_dir) != args.steps:  # the reference saves the last step again
        save_checkpoint(ckpt_dir, args.steps, state)
    launches, flash_launches = ssd_ops.launches - launches0, flash_ops.launches - flash0
    k1 = {f"flash_launches_{k}": attn.k1_launches[k] - k1_0[k] for k in k1_0}
    norms = _leaf_norms(state.params)
    tokens = args.batch * args.seq
    steady = _steady(step_seconds)
    summary = {
        "arch": args.arch,
        "config": cfg.name,
        "num_layers": cfg.num_layers,
        "num_experts": cfg.num_experts,
        "d_model": cfg.d_model,
        "param_count": param_count(cfg),
        "optimizer": spec.optimizer,
        "steps": args.steps,
        "resumed_from": resumed_from,
        "batch": args.batch,
        "seq": args.seq,
        "microbatches": args.microbatches,
        "device": _device_name(device),
        "setup_seconds": setup,
        "losses": losses,
        "grad_norms": grad_norms,
        "lrs": lrs,
        # the parameters' L2 norm before and after the steps, and how many
        # leaves the steps changed
        "param_norm": [math.hypot(*norms0), math.hypot(*norms)],
        "leaves_updated": sum(a != b for a, b in zip(norms0, norms)),
        "leaves": len(norms),
        "step_ms": [1e3 * s for s in step_seconds],
        "step_ms_p50": 1e3 * statistics.median(steady) if steady else None,
        "tokens_per_second": tokens * len(steady) / sum(steady) if steady else None,
        "max_memory_allocated": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "ssd_launches": launches,
        "flash_launches": flash_launches,
        # K1's launches by the attention that made them
        **k1,
        **aux,
    }
    if args.profile:
        def run():
            step_fn(state, batch(args.steps))
            synchronize(device)

        summary["profile"] = _profile(run, device, {"ssd": "ssd_fwd", "flash": "flash_fwd"})
    return summary, state


def dataset(cfg: ModelConfig, args) -> SyntheticTextDataset:
    """``--mode spmd``'s token streams, with the frame (encoder-decoder) or
    patch (VLM) embeddings the reference draws for its family; a step's
    model batch is ``_batch_dict(cfg, dataset(cfg, args).batch_at(i))``."""
    return SyntheticTextDataset(
        cfg.vocab_size, args.seq, args.batch, seed=args.seed,
        embed_dim=cfg.d_model if cfg.family in ("vlm", "encdec") else None,
        embed_len=args.seq if cfg.family == "vlm" else max(args.seq // 8, 1),
    )


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
    engine: str = "ranks",
) -> dict:
    """Train ``cfg`` cut into ``stages`` devices' worth of stages under the
    plan ``plan_spec`` over ``microbatches`` micro-batches.

    ``engine="ranks"``: one process per stage (:func:`_train_rank`), every
    rank on ``device``; ``"reference"``: the one-process reference engine.
    Each step's ``batch`` x ``seq`` tokens are reshaped to ``[M, batch / M,
    seq]``.  ``profile`` runs one more step and traces it (under the ranks,
    every rank steps and rank 0 traces its own).  Returns the run's summary
    (losses, step times, K1 launches, memory; for the ranks, the transport
    and each rank's breakdown)."""
    device = resolve_device(device)
    M = microbatches
    if batch % M:
        raise ValueError(f"batch {batch} does not split into {M} micro-batches")
    plan = make_plan(stages, M, spec=plan_spec)
    if engine == "ranks":
        return _run_ranks(cfg, plan, plan_spec, steps=steps, batch=batch, seq=seq, lr=lr, warmup=warmup,
                          seed=seed, log_every=log_every, device=device, profile=profile)
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r}")
    t0 = time.perf_counter()
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
    summary = _pipeline_summary(
        cfg, plan, "reference", steps=steps, batch=batch, seq=seq, device=_device_name(device), setup=setup,
        losses=losses, grad_norms=grad_norms, lrs=lrs, step_seconds=step_seconds,
        max_memory=torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        flash_launches=flash_ops.launches - launches0,
    )
    if profile:
        def run():
            step_fn(state, *batch_at(steps))
            synchronize(device)

        summary["profile"] = _profile(run, device, {"flash": "flash_fwd"})
    return summary


def _pipeline_summary(cfg, plan, engine, *, steps, batch, seq, device, setup, losses, grad_norms, lrs,
                      step_seconds, max_memory, flash_launches) -> dict:
    """What both engines of :func:`run_pipeline` report; ``device`` is the
    card's name (or ``"cpu"``), ``step_seconds`` one entry a step."""
    M = plan.num_microbatches
    steady = _steady(step_seconds)
    return {
        "mode": "pipeline",
        "engine": engine,
        "config": cfg.name,
        "num_layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "vocab_size": cfg.vocab_size,
        "param_count": param_count(cfg),
        "stages": plan.num_stages,
        "virtual_stages": plan.total_virtual_stages,
        "plan": plan.name,
        "microbatches": M,
        "micro_batch_size": batch // M,
        "steps": steps,
        "batch": batch,
        "seq": seq,
        "device": device,
        "setup_seconds": setup,
        "losses": losses,
        "grad_norms": grad_norms,
        "lrs": lrs,
        "step_ms": [1e3 * s for s in step_seconds],
        "step_ms_p50": 1e3 * statistics.median(steady),
        "tokens_per_second": batch * seq * len(steady) / sum(steady),
        "max_memory_allocated": max_memory,
        "flash_launches": flash_launches,
    }


#: a rank's seconds in a step, as the summary's per-rank breakdown reports them
_LINE_ITEMS = ("compute", "recv_wait", "send_wait", "staging", "reduce", "other")


def _train_rank(group, cfg, plan_spec, steps, batch, seq, M, lr, warmup, seed, log_every, profile) -> dict:
    """One rank of ``run_pipeline(engine="ranks")``: draw this rank's stages
    from ``seed``, train them with ``pipeline_train_step`` and return the
    rank's record (every rank sees the same reduced loss and clip norm).
    A step's breakdown is the rank's spans (:meth:`RankGroup.span`), read
    after the step; ``other`` is the rest of the step on the rank's clock
    (the optimizer, the host)."""
    device, lead = group.device, group.rank == 0
    t0 = time.perf_counter()
    plan = make_plan(group.S, M, spec=plan_spec)
    staged = StagedModel.build(cfg, plan.total_virtual_stages)
    owned = [plan.placement.vstage_of[group.s, c] for c in range(plan.num_virtual)]
    params = staged.init_stages(torch.Generator(device=device).manual_seed(seed), owned)
    opt = make_optimizer(
        "adamw", linear_warmup_cosine(lr, warmup, steps), norm_reduce=lambda t: group.all_reduce_sum(t, "stage")
    )
    state = create_train_state(params, opt)
    step_fn = pipeline_train_step(staged, plan, group, opt)
    ds = SyntheticTextDataset(cfg.vocab_size, seq, batch, seed=seed)

    def batch_at(i):
        b = ds.batch_at(i, device)
        return b.tokens.reshape(M, batch // M, seq), b.labels.reshape(M, batch // M, seq)

    synchronize(device)
    setup = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = flash_ops.launches
    losses, grad_norms, lrs, step_seconds, seconds = [], [], [], [], []
    for i in range(steps):
        tokens, labels = batch_at(i)
        group.barrier()
        t = time.perf_counter()
        state, m = step_fn(state, tokens, labels)
        synchronize(device)
        done = time.perf_counter()
        items = dict(group.take_seconds())
        group.barrier()
        step_seconds.append(time.perf_counter() - t)
        items["other"] = (done - t) - sum(items.values())
        seconds.append(items)
        losses.append(float(m["loss"]))
        grad_norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        if lead and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {losses[-1]:.4f}  lr {lrs[-1]:.2e}  grad_norm {grad_norms[-1]:.3e}  "
                  f"plan {plan.name}  {1e3 * step_seconds[-1]:.1f} ms ({group.S * group.D} ranks, "
                  f"{group.transport})", flush=True)
    rec = {
        "rank": group.rank,
        "stage": group.s,
        "transport": group.transport,
        "device": _device_name(device),
        "setup_seconds": setup,
        "losses": losses,
        "grad_norms": grad_norms,
        "lrs": lrs,
        "step_seconds": step_seconds,
        "seconds": seconds,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
        "flash_launches": flash_ops.launches - launches0,
        "max_in_flight": step_fn.engine.max_in_flight,
    }
    if profile:  # every rank steps twice more, in step with rank 0's timed and traced runs
        def run():
            step_fn(state, *batch_at(steps))
            synchronize(device)

        group.barrier()
        if lead:
            rec["profile"] = _profile(run, device, {"flash": "flash_fwd"})
        else:
            run()
            run()
        group.take_seconds()
    return rec


def _run_ranks(cfg, plan, plan_spec, *, steps, batch, seq, lr, warmup, seed, log_every, device, profile):
    M = plan.num_microbatches
    if device.type == "cuda":
        build.build(flash_ops.SOURCE)  # once, here: the ranks load it
    t0 = time.perf_counter()
    recs = ranks.spawn(
        _train_rank, plan.num_stages,
        args=(cfg, plan_spec, steps, batch, seq, M, lr, warmup, seed, log_every, profile),
        device=device.type, timeout=None,
    )
    wall = time.perf_counter() - t0
    r0, mem = recs[0], [r["max_memory_allocated"] for r in recs]
    summary = _pipeline_summary(
        cfg, plan, "ranks", steps=steps, batch=batch, seq=seq, device=r0["device"],
        setup=max(r["setup_seconds"] for r in recs), losses=r0["losses"], grad_norms=r0["grad_norms"],
        lrs=r0["lrs"], step_seconds=r0["step_seconds"], max_memory=None if None in mem else max(mem),
        flash_launches=sum(r["flash_launches"] for r in recs),
    )
    summary.update(
        ranks=len(recs),
        transport=r0["transport"],
        device_count=torch.cuda.device_count() if device.type == "cuda" else 0,
        run_seconds=wall,
        per_rank=[
            {
                **{k: r[k] for k in ("rank", "stage", "max_memory_allocated", "flash_launches", "max_in_flight")},
                "step_ms_p50": 1e3 * statistics.median(_steady(r["step_seconds"])),
                **{f"{k}_ms_p50": 1e3 * statistics.median(x.get(k, 0.0) for x in _steady(r["seconds"]))
                   for k in _LINE_ITEMS},
            }
            for r in recs
        ],
    )
    if profile:
        summary["profile"] = r0["profile"]
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=("spmd", "pipeline"), default="spmd")
    ap.add_argument("--arch", choices=ALL_ARCH_IDS, default="mamba2-780m")
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
    ap.add_argument("--ckpt-dir", default=None, help="spmd mode: resume from and save checkpoints here")
    ap.add_argument("--ckpt-every", type=int, default=0, help="spmd mode: save every N steps (and at the end)")
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
              f"parameters) in {s['stages']} ranks ({s['transport']}, {s['device_count']} cards), plan "
              f"{s['plan']}, on {s['device']}: step p50 {s['step_ms_p50']:.1f} ms, "
              f"{s['tokens_per_second']:,.0f} tokens/s, {s['flash_launches']} flash kernel launches")
        for r in s["per_rank"]:
            print(f"  rank {r['rank']}: " + ", ".join(f"{k} {r[k + '_ms_p50']:.1f} ms" for k in _LINE_ITEMS))
        kernel = "flash"
    else:
        s, _ = train(args)
        if not s["losses"]:
            print(f"nothing to train: resumed at step {s['resumed_from']} of --steps {args.steps}")
        else:
            print(f"{s['config']} ({s['num_layers']} layers, d_model {s['d_model']}, {s['param_count']:,} "
                  f"parameters, {s['optimizer']}) on {s['device']}: step p50 {s['step_ms_p50']:.1f} ms, "
                  f"{s['tokens_per_second']:,.0f} tokens/s, {s['ssd_launches']} SSD and "
                  f"{s['flash_launches']} flash kernel launches (encoder {s['flash_launches_encoder']}, "
                  f"decoder {s['flash_launches_decoder']}, cross {s['flash_launches_cross']})")
        if s["moe_load_balance"]:
            print(f"moe_load_balance {s['moe_load_balance'][-1]:.4f}, moe_router_z {s['moe_router_z'][-1]:.4f}")
        kernel = "ssd" if s["ssd_launches"] else "flash"
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
    if not losses:  # a finished run's directory: nothing was trained
        return 0
    if not all(math.isfinite(v) for v in losses + s["grad_norms"]):
        print("non-finite loss or gradient norm")
        return 1
    if not losses[-1] < losses[0]:
        raise AssertionError("training must reduce loss")
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
