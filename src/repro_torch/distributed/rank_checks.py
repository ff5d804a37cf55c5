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
(``torch.utils.flop_counter``).

:func:`spmd_serve_cases` runs the sharded prefill and decode step: a case
is a dict of ``cfg``, ``params`` (``repro``'s, as above), ``prompt`` [B, T]
tokens, ``cache`` (``repro``'s flat decode cache after its
``prefill_with_cache`` of the prompt), ``kv_len`` and ``decode`` [steps,
B, 1] tokens, stepped from index T, and optionally ``prefill_cache`` (the
prefill run once more, filling a fresh cache, returned gathered).  Rank 0
returns the prefill's and each step's logits and the cache gathered after
the steps (the port's flat layout); every rank returns its counts of
collectives per call, the leaves it gathered over "model" and each MoE
call's routing (``idx``, ``keep``).
"""

from __future__ import annotations

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
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.transformer import reference_layout
from repro_torch.optim import AdamWState, constant_schedule, make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.tree import flatten

__all__ = ["spmd_cases", "spmd_serve_cases", "spmd_mixed_cases", "repro_state", "shard_round_trips"]


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


def _one(group, case):
    cfg = case["cfg"]
    mesh = make_local_mesh(group.axes[0][1], group.axes[1][1], group)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    params = None
    if case.get("params") is not None:
        params = bridge.params_from_repro(case["params"], cfg, device=group.device)
    layout = None
    if case["optimizer"] == "adafactor":
        layout = reference_layout(cfg, params if params is not None else state_specs_for(cfg, make_optimizer()).params)
    opt = make_optimizer(case["optimizer"], constant_schedule(case["lr"]), layout=layout, **case.get("hyper", {}))
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
    metrics, flops = [], None
    for i in range(case["steps"]):
        if i == 0:
            with FlopCounterMode(display=False) as counter:
                state, m = step(state, batch)
            flops = counter.get_total_flops()
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
    mesh = make_local_mesh(group.axes[0][1], group.axes[1][1], group)
    prompt = torch.from_numpy(case["prompt"])
    decode = [torch.from_numpy(t) for t in case["decode"]]
    B, T = prompt.shape
    prefill, _ = make_spmd_prefill(cfg, mesh, {"tokens": prompt}, kv_len=case["kv_len"])
    step, _ = make_spmd_serve_step(cfg, mesh, {"tokens": decode[0]}, case["kv_len"])
    params = prefill.shard_params(bridge.params_from_repro(case["params"], prefill.cfg, device=group.device))
    cache = step.shard_cache(bridge.cache_from_repro(case["cache"], cfg, device=group.device))
    tp = step.tp
    prefill.tp.keep_routes = tp.keep_routes = True
    n0 = flash_ops.launches
    logits = [_np(prefill(params, {"tokens": prompt}))]
    counts = [dict(prefill.tp.counts)]
    k1 = flash_ops.launches - n0
    for i, tokens in enumerate(decode):
        tp.counts.clear()
        logits.append(_np(step(params, cache, T + i, {"tokens": tokens})[0]))
        counts.append(dict(tp.counts))
    full = flatten(step.gather_cache(cache))
    out = {
        "logits": logits if group.rank == 0 else None,
        "cache": {k: _np(v) for k, v in full.items()} if group.rank == 0 else None,
        "counts": counts, "k1": k1, "row_axes": step.row_axes,
        "gathered": sorted(prefill.tp.gathered | tp.gathered),
        "cache_shapes": {k: tuple(v.shape) for k, v in flatten(cache).items()},
        "routes": _routes(prefill.tp) + _routes(tp),
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
