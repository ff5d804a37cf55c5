"""Rank entry functions that run the sharded train step on a mesh of ranks.

Each runs inside :func:`repro_torch.pipeline.ranks.spawn` (spawned with
``axes={"data": D, "model": T}``), so it lives in the package where a
spawned process can import it.

:func:`spmd_cases` runs a list of cases and returns, from global rank 0,
each case's metrics after every step and its final state gathered to full
in ``repro``'s flat, stacked numpy layout (the bridge's keys, under
``params/``, ``opt_state/m/``, ``opt_state/v/`` or ``opt_state/v_row/``,
``opt_state/v_col/``), with every rank's K1 launches and local shard
shapes, the leaves its use gathers over "model", its collective counts and
each MoE call's routing.  :func:`shard_round_trips` holds the shard helpers to their
definition.

A case is a dict: ``cfg``, ``strategy``, ``M``, ``steps``, ``batch`` (numpy
arrays by key, the global batch), ``optimizer`` (``"adamw"`` or
``"adafactor"``), ``lr``, optional ``hyper`` (its hyper-parameters),
``gather_params_once`` and ``remat_blocks``, and ``params`` (``repro``'s flat stacked parameters as
numpy) or ``seed`` (drawn on the ranks by the step's ``init_state``).  Each
result also carries every rank's matmul FLOPs in its first step
(``torch.utils.flop_counter``).  With ``record`` (a case key) the rank's
group is wrapped in a :class:`~repro_torch.launch.hlo_analysis.CollectiveRecorder`
and the result carries the collectives of the first step (``collectives``,
each entry a tuple) and the bytes of the step's arguments
(``argument_bytes``: the rank's state and the global batch), what
:mod:`repro_torch.launch.dryrun` predicts for the rank.

:func:`spmd_serve_cases` runs the sharded prefill and decode step: a case
is a dict of ``cfg``, ``params`` (``repro``'s, as above), ``prompt`` [B, T]
tokens, ``cache`` (``repro``'s flat decode cache after its
``prefill_with_cache`` of the prompt; or, without ``params``, ``seed``:
the weights drawn on the ranks and an empty cache), ``kv_len`` and ``decode`` [steps,
B, 1] tokens, stepped from index T, and optionally ``prefill_cache`` (the
prefill run once more, filling a fresh cache, returned gathered).  Rank 0
returns the prefill's and each step's logits and the cache gathered after
the steps (the port's flat layout); every rank returns its counts of
collectives per call, the leaves it gathered over "model" and each MoE
call's routing (``idx``, ``keep``); with ``record``, the recorded
collectives of the prefill and of each step, and each call's argument bytes.

:func:`dry_vs_recorded` runs both lists recorded, then each case's dry run
(:mod:`repro_torch.launch.dryrun`) at the rank's coordinate, for the two to
be held equal; :func:`stateless_runtime` runs a stateless spmd
:class:`~repro_torch.runtime.executor.PlanRuntime` on the rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import bridge
from repro_torch.distributed.sharding import gather, local_shape, local_shard, reduce_scatter, spec_axes
from repro_torch.distributed.spmd import (
    make_spmd_prefill,
    make_spmd_serve_step,
    make_spmd_train_step,
    state_specs_for,
)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.dryrun import argument_bytes, dry_decode, dry_mesh, dry_prefill, dry_train
from repro_torch.launch.hlo_analysis import CollectiveRecorder
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import reference_layout
from repro_torch.optim import AdamWState, constant_schedule, make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.tree import flatten

__all__ = [
    "spmd_cases",
    "spmd_serve_cases",
    "spmd_mixed_cases",
    "repro_state",
    "shard_round_trips",
    "dry_vs_recorded",
    "stateless_runtime",
]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def repro_state(state, cfg) -> dict:
    """A full port state in ``repro``'s flat, stacked numpy layout."""
    out = {f"params/{k}": v for k, v in bridge.params_to_repro(state.params, cfg).items()}
    opt = state.opt_state
    if isinstance(opt, AdamWState):
        for which in ("m", "v"):
            out.update({f"opt_state/{which}/{k}": v for k, v in bridge.params_to_repro(getattr(opt, which), cfg).items()})
    else:
        out.update({f"opt_state/v_row/{k}": _np(v) for k, v in opt.v_row.items()})
        out.update({f"opt_state/v_col/{k}": _np(v) for k, v in opt.v_col.items()})
    return out


def _recorded(group, case):
    return CollectiveRecorder(group) if case.get("record") else group


def _take_log(group) -> list | None:
    return [tuple(dataclasses.astuple(e)) for e in group.take_log()] if isinstance(group, CollectiveRecorder) else None


def _optimizer(case, params=None):
    cfg, layout = case["cfg"], None
    if case["optimizer"] == "adafactor":
        layout = reference_layout(cfg, params if params is not None else state_specs_for(cfg, make_optimizer()).params)
    return make_optimizer(case["optimizer"], constant_schedule(case["lr"]), layout=layout, **case.get("hyper", {}))


def _one(group, case):
    cfg = case["cfg"]
    group = _recorded(group, case)
    mesh = make_local_mesh(group.axes[0][1], group.axes[1][1], group)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    params = None
    if case.get("params") is not None:
        params = bridge.params_from_repro(case["params"], cfg, device=group.device)
    opt = _optimizer(case, params)
    step, (state_specs, _) = make_spmd_train_step(
        cfg, mesh, batch, opt, num_microbatches=case["M"], strategy=case["strategy"],
        gather_params_once=case.get("gather_params_once", False), remat_blocks=case.get("remat_blocks", False),
    )
    state = step.shard_state(params) if params is not None else step.init_state(case["seed"])
    want = {k: local_shape(t.shape, step.specs[k], mesh) for k, t in flatten(state_specs.params).items()}
    got = {k: tuple(t.shape) for k, t in flatten(state.params).items()}
    if step.tp is not None:
        step.tp.keep_routes = True
    n0 = flash_ops.launches
    metrics, flops, log = [], None, None
    nargs = argument_bytes(state, batch)
    for i in range(case["steps"]):
        if i == 0:
            _take_log(group)
            with FlopCounterMode(display=False) as counter:
                state, m = step(state, batch)
            flops = counter.get_total_flops()
            log = _take_log(group)
        else:
            state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = flash_ops.launches - n0
    full = step.gather_state(state)
    return {
        "metrics": metrics, "launches": launches, "shapes_agree": got == want, "row_axes": step.row_axes,
        "flops": flops, "gathered": _gathered_over_model(step), "routes": _routes(step.tp),
        "counts": dict(step.tp.counts) if step.tp is not None else {},
        "state": repro_state(full, cfg) if group.rank == 0 else None,
        "collectives": log, "argument_bytes": nargs,
    }


def _gathered_over_model(step) -> list:
    """The leaf paths whose use gathers them over "model"."""
    return sorted(k for k, spec in step._gather.items() if "model" in {a for e in spec for a in spec_axes(e)})


def _routes(tp) -> list:
    """Each MoE call's routing (``idx``, ``keep``) as numpy, in call order."""
    return [] if tp is None else [(i.cpu().numpy(), k.cpu().numpy()) for i, k in tp.routes]


def spmd_cases(group, cases: list) -> list:
    """Every case on this rank, in order; rank 0's results carry the state."""
    return [_one(group, case) for case in cases]


def _serve_one(group, case):
    cfg = case["cfg"]
    group = _recorded(group, case)
    mesh = make_local_mesh(group.axes[0][1], group.axes[1][1], group)
    prompt = torch.from_numpy(case["prompt"])
    decode = [torch.from_numpy(t) for t in case["decode"]]
    B, T = prompt.shape
    prefill, _ = make_spmd_prefill(cfg, mesh, {"tokens": prompt}, kv_len=case["kv_len"])
    step, _ = make_spmd_serve_step(cfg, mesh, {"tokens": decode[0]}, case["kv_len"])
    if case.get("params") is None:  # drawn on the ranks, into an empty cache
        params, cache = prefill.init_params(case["seed"]), step.init_cache()
    else:
        params = prefill.shard_params(bridge.params_from_repro(case["params"], prefill.cfg, device=group.device))
        cache = step.shard_cache(bridge.cache_from_repro(case["cache"], cfg, device=group.device))
    tp = step.tp
    prefill.tp.keep_routes = tp.keep_routes = True
    n0 = flash_ops.launches
    _take_log(group)
    logits = [_np(prefill(params, {"tokens": prompt}))]
    counts = [dict(prefill.tp.counts)]
    logs = [_take_log(group)]
    nargs = [argument_bytes(params, {"tokens": prompt})]
    k1 = flash_ops.launches - n0
    for i, tokens in enumerate(decode):
        tp.counts.clear()
        nargs.append(argument_bytes(params, cache, {"tokens": tokens}))
        logits.append(_np(step(params, cache, T + i, {"tokens": tokens})[0]))
        counts.append(dict(tp.counts))
        logs.append(_take_log(group))
    full = flatten(step.gather_cache(cache))
    out = {
        "logits": logits if group.rank == 0 else None,
        "cache": {k: _np(v) for k, v in full.items()} if group.rank == 0 else None,
        "counts": counts, "k1": k1, "row_axes": step.row_axes,
        "gathered": sorted(prefill.tp.gathered | tp.gathered),
        "cache_shapes": {k: tuple(v.shape) for k, v in flatten(cache).items()},
        "routes": _routes(prefill.tp) + _routes(tp),
        "collectives": logs if logs[0] is not None else None, "argument_bytes": nargs,
    }
    if case.get("prefill_cache"):  # the prefill again, filling a fresh cache
        filled = prefill.init_cache()
        prefill(params, {"tokens": prompt}, filled)
        out["prefill_cache"] = {k: _np(v) for k, v in flatten(prefill.gather_cache(filled)).items()}
    return out


def spmd_serve_cases(group, cases: list) -> list:
    """Every serving case on this rank, in order (the module docstring)."""
    return [_serve_one(group, case) for case in cases]


def spmd_mixed_cases(group, train: list, serve: list) -> tuple[list, list]:
    """:func:`spmd_cases` of ``train``, then :func:`spmd_serve_cases` of
    ``serve``, in one spawn of the ranks."""
    return spmd_cases(group, train), spmd_serve_cases(group, serve)


def shard_round_trips(group, cases: list, piece_bytes: int | None = None) -> list:
    """For each ``(shape, spec)``: this rank's :func:`local_shard` of a seeded
    full tensor gathered back to full, and the :func:`reduce_scatter` of
    every rank's ``(rank + 1) * full`` against the shard of their sum.
    ``piece_bytes`` shrinks the collectives' pieces (``ranks._PIECE_BYTES``)
    so that small leaves take the piecewise path.  Returns ``(gathered
    equal, reduce-scattered equal)`` per case."""
    if piece_bytes is not None:
        ranks._PIECE_BYTES = piece_bytes
    mesh = make_local_mesh(group.axes[0][1], group.axes[1][1], group)
    out = []
    for shape, spec in cases:
        full = torch.randn(shape, generator=torch.Generator().manual_seed(len(shape)))
        back = gather(local_shard(full, spec, mesh).clone(), spec, mesh)
        summed = reduce_scatter(full * (group.rank + 1), spec, mesh)
        # summed over the ranks that differ from this one along the spec's axes only
        named = {a for entry in spec for a in spec_axes(entry)}
        fixed = [i for i, a in enumerate(mesh.axis_names) if a not in named]
        peers = [r for r in range(mesh.size)
                 if all(np.unravel_index(r, mesh.sizes)[i] == mesh.coords[i] for i in fixed)]
        want = local_shard(full * sum(r + 1 for r in peers), spec, mesh)
        out.append((torch.equal(back, full), bool(torch.allclose(summed, want))))
    return out


def _entries(dry) -> list:
    return [tuple(dataclasses.astuple(e)) for e in dry.log]


def dry_vs_recorded(group, train: list, serve: list, runtime: dict | None = None) -> dict:
    """:func:`spmd_mixed_cases` of ``train`` and ``serve`` with every group
    recorded, then each case's dry run (:mod:`repro_torch.launch.dryrun`)
    at this rank's coordinate: ``{"real": (train results, serve results),
    "dry": (per train case, per serve case: {"collectives", "argument_bytes",
    "peak_bytes", "flops"}; a serve case's lists hold the prefill and one
    decode step)}``; with ``runtime`` also :func:`stateless_runtime`'s."""
    real = spmd_mixed_cases(group, [dict(c, record=True) for c in train], [dict(c, record=True) for c in serve])
    axes, coords = dict(group.axes), dict(group.coords)
    dry_train_out = []
    for c in train:
        batch = {k: torch.from_numpy(v) for k, v in c["batch"].items()}
        d = dry_train(c["cfg"], dry_mesh(axes, coords), batch, _optimizer(c), num_microbatches=c["M"],
                      strategy=c["strategy"], gather_params_once=c.get("gather_params_once", False),
                      remat_blocks=c.get("remat_blocks", False))
        dry_train_out.append({"collectives": _entries(d), "argument_bytes": d.argument_bytes,
                              "peak_bytes": d.peak_bytes, "flops": d.analysis.flops})
    dry_serve_out = []
    for c in serve:
        prompt = torch.from_numpy(c["prompt"])
        tokens = torch.from_numpy(c["decode"][0])
        p = dry_prefill(c["cfg"], dry_mesh(axes, coords), {"tokens": prompt})
        d = dry_decode(c["cfg"], dry_mesh(axes, coords), {"tokens": tokens}, c["kv_len"], index=prompt.shape[1])
        dry_serve_out.append({k: [getattr(x, k) for x in (p, d)] for k in ("argument_bytes", "peak_bytes")}
                             | {"collectives": [_entries(p), _entries(d)]})
    out = {"real": real, "dry": (dry_train_out, dry_serve_out)}
    if runtime is not None:
        out["runtime"] = stateless_runtime(group, **runtime)
    return out


def stateless_runtime(group, cfg, global_batch: int, seq_len: int, plans: list, x) -> dict:
    """A stateless :class:`~repro_torch.runtime.executor.PlanRuntime` on the
    spmd backend (``optimizer=None``): every rank switches through
    ``plans`` (lowered tables) and runs each plan's program on ``x``; the
    program scales ``x`` by the plan's micro-batch count and sums it over
    the stage group.  Returns each run's output and each switch's record."""
    from repro_torch.runtime.executor import PlanRuntime

    def factory(table):
        M = float(table.plan.num_microbatches)
        return lambda t: group.all_reduce_sum(t * M, "stage")

    rt = PlanRuntime(cfg, group.S, None, global_batch, seq_len, backend="spmd", group=group, program_factory=factory)
    outs, events = [], []
    try:
        try:
            rt.run_iteration(None, None)
        except RuntimeError as e:
            refused = str(e)
        for table in plans:
            ev = rt.switch_to(table)
            events.append({"to_plan": ev.to_plan, "from_plan": ev.from_plan, "restacked": ev.restacked,
                           "warm": ev.warm, "v": rt.current_v, "ranks": ev.ranks,
                           "placement": rt.placement.vstage_of.tolist()})
            out, _ = rt.run_program(torch.as_tensor(x, dtype=torch.float32))
            outs.append(out.numpy())
    finally:
        rt.cache.shutdown()
    return {"outputs": outs, "events": events, "refused": refused, "state": rt.state}
