"""Per-host fabric worker process: connect, train, obey the barrier.

Port of ``repro/launch/fabric_worker.py``.  One of these runs on every
worker host of a multi-process fleet (the two-process test launches two
against an in-test :class:`~repro_torch.runtime.fabric.transport.CoordinatorListener`;
a deployment launches one per node).  It is deliberately thin: build the
SAME candidate universe as every other host (:func:`fig10_parts`: a
:class:`ScheduleSpec` on the wire must resolve to the same logical plan
everywhere), wrap the local :class:`~repro_torch.runtime.executor.PlanRuntime`
in a :class:`~repro_torch.runtime.fabric.worker.WorkerAgent`, dial the
coordinator over TCP, and step.  All control flow (telemetry shipping,
precompile-and-vote, boundary blocking, commit/rollback) lives in the
agent; this file is argument parsing plus a result JSON.

The result JSON carries the observables the tests assert on: per-iteration
losses, the applied switch trail (epoch/boundary/verdict), the final spec,
an L1/L2 digest of the trained parameters for parity against a
single-process oracle run, and per iteration the flash kernel K1's launches
beside the attention forwards of the plan's grid (0 on the CPU, which
launches no kernel).

The model is ``repro``'s ``runtime-tiny`` at ``--d-model`` unless ``--gpt``
names a Table-1 GPT config (``--layers`` cuts its depth).  Without
``--device`` the worker needs a CUDA card and fails if there is none;
``--device cpu`` runs on the CPU.

Usage::

    python -m repro_torch.launch.fabric_worker --connect 127.0.0.1:9123 \\
        --host host0 --host-index 0 --iterations 8 --out host0.json \\
        [--device cpu] [--gpt GPT-2.7B --layers 8 --seq-len 1024 --stages 4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.data import SyntheticTextDataset
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.train_adaptive import expected_flash_launches, fig10_parts
from repro_torch.obs import Observability
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.runtime.executor import PlanRuntime
from repro_torch.runtime.fabric import SocketTransport, WorkerAgent, fabric_probe_links
from repro_torch.tree import flatten

__all__ = ["build_worker", "param_digest", "main"]


def param_digest(params) -> dict:
    """Order-independent L1/L2 digest of a parameter tree, in fp64 on each
    leaf's device: the cross-process parity observable (two runs that
    applied the same updates to the same draw produce the same digest)."""
    leaves = list(flatten(params).values())
    l1 = l2 = 0.0
    for t in leaves:  # one leaf in fp64 at a time
        x = t.detach().double()
        l1, l2 = l1 + float(x.abs().sum()), l2 + float(x.square().sum())
    return {"l1": l1, "l2": l2 ** 0.5, "leaves": len(leaves)}


def build_worker(
    host: str,
    host_index: int,
    transport,
    num_stages: int = 2,
    d_model: int = 8,
    seq_len: int = 16,
    seed: int = 0,
    cache=None,
    obs: Observability | None = None,
    gpt: str | None = None,
    num_layers: int | None = None,
    device=None,
) -> WorkerAgent:
    """The host-side half of ``build_fabric_fleet``: same candidate
    universe, same draw, data shard picked by ``host_index``, on ``device``
    (the card unless given ``"cpu"``).

    ``cache`` may be a :class:`CompiledStepCache` borrowed from another
    same-config runtime: reference-backend steps are pure functions of
    (state, batch) (:class:`PlanRuntime`), so in-process tests share one
    cache across hosts.  ``obs`` (optional) receives this host's
    iteration/switch spans (on ``{host}/*`` tracks), its barrier
    participation instants, and the flight events the failure dump ships."""
    cfg, costs, cands, B = fig10_parts(num_stages, d_model=d_model, gpt=gpt, num_layers=num_layers)
    opt = make_optimizer("adamw", schedule=constant_schedule(1e-3))
    runtime = PlanRuntime(
        cfg, num_stages, opt, global_batch=B, seq_len=seq_len, backend="reference", init_key=seed,
        obs=obs, obs_track=host, device=device, cache=cache,
    )
    dataset = SyntheticTextDataset(cfg.vocab_size, seq_len, B, seed=seed + host_index)

    def batch_fn(it: int):
        batch = dataset.batch_at(it, runtime.device)
        return batch.tokens, batch.labels

    return WorkerAgent(
        host, runtime, transport, batch_fn,
        costs=costs, initial_spec=cands[0].spec,
        probe_links=fabric_probe_links(cands, lambda c: costs),
        obs=obs,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--connect", required=True, metavar="HOST:PORT")
    ap.add_argument("--host", required=True, help="this worker's fabric name")
    ap.add_argument("--host-index", type=int, required=True)
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpt", default=None, choices=sorted(GPT_CONFIGS),
                    help="train this Table-1 GPT config instead of runtime-tiny")
    ap.add_argument("--layers", type=int, default=None, help="cut the --gpt config to this many layers")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument(
        "--trace", default=None, metavar="OUT.json",
        help="write this host's Chrome/Perfetto trace here (its flight "
        "ring goes to OUT.json.flight.json, and auto-dumps there on a "
        "worker failure); merge per-host traces with "
        "repro_torch.obs.trace.merge_traces",
    )
    args = ap.parse_args(argv)

    resolve_device(args.device)  # no card and no --device cpu: fail before dialling
    obs = None
    if args.trace:
        obs = Observability.create(flight_dump_path=args.trace + ".flight.json")
    addr_host, _, addr_port = args.connect.rpartition(":")
    transport = SocketTransport((addr_host, int(addr_port)))
    try:
        agent = build_worker(
            args.host, args.host_index, transport,
            num_stages=args.stages, d_model=args.d_model, seq_len=args.seq_len, seed=args.seed, obs=obs,
            gpt=args.gpt, num_layers=args.layers, device=args.device,
        )
        device = agent.runtime.device
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        launches = []
        try:
            for _ in range(args.iterations):
                before = flash_ops.launches
                agent.step()
                launches.append({
                    "flash_launches": flash_ops.launches - before,
                    "attention_forwards": expected_flash_launches(agent.runtime.current_table.plan, agent.runtime.cfg),
                })
            # success: dump the ring anyway (a failure already auto-dumped with
            # its own reason inside step(), which this must not overwrite)
            if obs is not None:
                obs.flight.dump(args.trace + ".flight.json", reason="run end")
        finally:
            if obs is not None:
                obs.trace.save(args.trace)
            agent.runtime.cache.shutdown()
    finally:
        transport.close()

    rt = agent.runtime
    out = {
        "host": args.host,
        "device": str(device),
        "iterations": len(rt.iterations),
        "losses": [r.loss for r in rt.iterations],
        "seconds": [r.seconds for r in rt.iterations],
        "plans": [r.plan_name for r in rt.iterations],
        "final_spec": dataclasses.asdict(agent.current_spec),
        "applied": [
            {
                "epoch": o.epoch,
                "committed": o.committed,
                "boundary": o.boundary,
                "spec": dataclasses.asdict(o.spec),
                "reason": o.reason,
            }
            for o in agent.applied_outcomes
        ],
        "switch_events": len(rt.switch_events),
        "switch_seconds": [e.seconds for e in rt.switch_events],
        "precompile_hit_rate": rt.cache.stats.hit_rate,
        "param_digest": param_digest(rt.state.params),
        "kernel_launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {os.path.abspath(args.out)}")
    else:
        print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
