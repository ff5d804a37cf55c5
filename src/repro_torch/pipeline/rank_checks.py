"""Rank entry functions that hold the multi-rank engine to a reference.

Each runs inside :func:`repro_torch.pipeline.ranks.spawn` (so it lives in
the package, where a spawned process can import it) and brings what the
check compares back to global rank 0:

* :func:`engine_case` runs one plan's engine step on this rank and gathers
  the loss and the gradients;
* :func:`engine_matrix` runs a list of such cases and returns rank 0's
  results as ``repro``'s flat, stacked numpy layout;
* :func:`train_steps` runs ``pipeline_train_step`` for a few steps and
  gathers the parameters after each;
* :func:`runtime_checks` runs ``PlanRuntime``'s ``spmd`` backend: walks
  through a list of plans (rank 0 leads, the others follow), cross-rank
  restacks there and back, and the Fig-10 scenario.

A case is a dict: ``cfg`` (a :class:`~repro_torch.models.common.ModelConfig`),
``spec`` (``ScheduleSpec`` keywords), ``M``, ``tokens`` and ``labels``
(numpy ``[M, b, T]``), and either ``params`` (``repro``'s flat stacked
parameters as numpy, carried across by the bridge) or ``seed`` (the rank
draws its own stages with ``StagedModel.init_stages``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline.engine import make_pipeline_step
from repro_torch.pipeline.stage import StagedModel
from repro_torch.training import create_train_state, pipeline_train_step
from repro_torch.tree import flatten, tree_map

__all__ = ["engine_case", "engine_matrix", "train_steps", "runtime_walk", "restack_pairs", "runtime_checks"]


def _setup(group, case):
    """The case's plan, staged model, this rank's parameters and its data."""
    plan = make_plan(group.S, case["M"], spec=ScheduleSpec(**case["spec"]))
    staged = StagedModel.build(case["cfg"], plan.total_virtual_stages)
    if case.get("params") is not None:
        full = bridge.staged_params_from_repro(case["params"], staged, device=group.device)
        local = bridge.rank_params(full, plan, group.s)
    else:
        gen = torch.Generator(device=group.device).manual_seed(case["seed"])
        local = staged.init_stages(gen, [plan.placement.vstage_of[group.s, c] for c in range(plan.num_virtual)])
    tokens, labels = (torch.from_numpy(case[k]).to(group.device) for k in ("tokens", "labels"))
    return plan, staged, local, tokens, labels


def engine_case(group, case):
    """One engine step of ``case`` on this rank.  Returns ``(staged, plan,
    loss, grads, stats)``: the loss (every rank), the full list of gradient
    trees on global rank 0 (``None`` elsewhere), and this rank's K1 launches
    in the step, its transport, its deepest in-flight queues and their
    capacities."""
    plan, staged, local, tokens, labels = _setup(group, case)
    engine = make_pipeline_step(staged, plan, group)
    n0 = flash_ops.launches
    loss, grads = engine(local, tokens, labels)
    stats = {
        "rank": group.rank,
        "transport": group.transport,
        "flash_launches": flash_ops.launches - n0,
        "max_in_flight": engine.max_in_flight,
        "caps": engine.caps,
    }
    return staged, plan, float(loss), bridge.gather_to_rank0(grads, plan, group), stats


def engine_matrix(group, cases) -> list[dict]:
    """Every case's loss and this rank's stats; on rank 0 also the gradients
    as ``repro``'s flat stacked numpy tree (``grads``)."""
    out = []
    for case in cases:
        staged, plan, loss, full, stats = engine_case(group, case)
        res = {"plan": plan.name, "loss": loss, **stats}
        if full is not None:
            res["grads"] = bridge.staged_params_to_repro(full, staged)
        out.append(res)
    return out


def _optimizer(group, lr: float):
    """AdamW at constant ``lr``, clip 1, the norm summed over the stage group."""
    return make_optimizer("adamw", constant_schedule(lr), norm_reduce=lambda t: group.all_reduce_sum(t, "stage"))


def train_steps(group, case, lr: float, steps: list) -> dict:
    """``pipeline_train_step`` (AdamW at constant ``lr``, clip 1, the norm
    summed over the stage group) for one step per ``(tokens, labels)`` of
    ``steps``.  Returns ``{"steps": [...]}``: per step the loss and clip
    norm, and on rank 0 the parameters after it as ``repro``'s flat stacked
    numpy tree; rank 0 also returns the parameters gathered before the
    first step (``initial``)."""
    plan, staged, local, _, _ = _setup(group, case)
    opt = _optimizer(group, lr)
    state = create_train_state(local, opt)
    step = pipeline_train_step(staged, plan, group, opt)

    def gathered():
        full = bridge.gather_to_rank0(state.params, plan, group)
        return None if full is None else bridge.staged_params_to_repro(full, staged)

    out = {"initial": gathered(), "steps": []}
    for tokens, labels in steps:
        state, m = step(state, torch.from_numpy(tokens).to(group.device), torch.from_numpy(labels).to(group.device))
        out["steps"].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "params": gathered()})
    return out


def runtime_walk(group, case) -> list | None:
    """``PlanRuntime(backend="spmd")`` from ``repro``'s flat training state
    (``case["state"]``, numpy) through ``case["walk"]``, a list of
    ``(ScheduleSpec keywords, iterations)``, one batch of ``case["data"]``
    (numpy ``[B, T]`` tokens and labels) an iteration.  Rank 0 leads and
    returns, per iteration, the plan, the loss, the switch's ``restacked``
    and per-rank records, and the state and gradients gathered in the flat
    layout as ``repro``'s flat stacked numpy trees; the other ranks follow
    and return ``None``."""
    from repro_torch.runtime import PlanRuntime

    M, b, T, data = case["M"], case["b"], case["T"], case["data"]
    rt = PlanRuntime(case["cfg"], group.S, _optimizer(group, case["lr"]), global_batch=M * b, seq_len=T,
                     backend="spmd", group=group)
    rt.state = bridge.rank_train_state(case["state"], rt.staged_for(1), rt.placement, group.s, device=group.device)

    def batch(i):
        return tuple(torch.from_numpy(a).to(group.device) for a in data[i])

    if group.rank:
        rt.follow(batch)
        rt.cache.shutdown()
        return None
    out, i = [], 0
    for kw, n in case["walk"]:
        table = make_plan(group.S, M, spec=ScheduleSpec(micro_batch_size=b, **kw)).lower()
        ev = rt.switch_to(table)
        flat = rt.staged_for(1)
        for _ in range(n):
            r = rt.run_iteration(*batch(i), batch_index=i)
            out.append({
                "plan": r.plan_name, "loss": r.loss, "restacked": ev.restacked, "moved": ev.ranks,
                "state": bridge.train_state_to_repro(rt.state_in_flat_layout(), flat),
                "grads": bridge.staged_params_to_repro(rt.grads_in_flat_layout(), flat),
            })
            ev = dataclasses.replace(ev, restacked=False, ranks=None)
            i += 1
    rt.stop()
    rt.cache.shutdown()
    return out


def restack_pairs(group, case) -> list:
    """``restack_across_ranks`` from every plan of ``case["plans"]`` (spec
    keywords at ``case["M"]``) to every other and back, on ``case["state"]``
    (``repro``'s flat training state, numpy, its replicated copies equal).
    Per ordered pair: on rank 0 whether the state gathered in the middle
    equals the one-process ``restack_train_state`` of the whole state
    bitwise (``mid``); on every rank whether the way back returned its
    state bitwise (``back``), and the bytes it sent and received."""
    from repro_torch.runtime import restack_across_ranks, restack_train_state

    S = group.S
    plans = [make_plan(S, case["M"], spec=ScheduleSpec(**kw)) for kw in case["plans"]]
    flat = bridge.train_state_from_repro(case["state"], StagedModel.build(case["cfg"], S), device=group.device)
    full = {p.num_virtual: restack_train_state(flat, S, 1, p.num_virtual) for p in plans}

    def local(plan):  # this rank's share, copied (a restack consumes its state)
        state = full[plan.num_virtual]
        return dataclasses.replace(
            state,
            params=tree_map(torch.clone, bridge.rank_params(state.params, plan, group.s)),
            opt_state=dataclasses.replace(
                state.opt_state,
                m=tree_map(torch.clone, bridge.rank_params(state.opt_state.m, plan, group.s)),
                v=tree_map(torch.clone, bridge.rank_params(state.opt_state.v, plan, group.s)),
            ),
        )

    def leaves(state):
        return flatten([state.params, state.opt_state.m, state.opt_state.v])

    def same(a, b):
        return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)

    out = []
    for a in plans:
        for b in plans:
            if a is b:
                continue
            before = local(a)
            want = leaves(before)
            mid, there = restack_across_ranks(local(a), group, a.placement, b.placement)
            got = bridge.gather_train_state_to_rank0(mid, b, group)
            ok_mid = None if got is None else same(leaves(got), leaves(full[b.num_virtual]))
            back, _ = restack_across_ranks(mid, group, b.placement, a.placement)
            out.append({
                "from": a.name, "to": b.name, "mid": ok_mid, "back": same(leaves(back), want),
                "sent": there["bytes_sent"], "received": there["bytes_received"],
                "layers_sent": there["layers_sent"],
            })
    return out


def runtime_checks(group, items: list) -> list:
    """Run each ``(name, arguments)`` of ``items`` on this rank, in order:
    ``("walk", case)`` (:func:`runtime_walk`), ``("pairs", case)``
    (:func:`restack_pairs`) or ``("fig10", (iterations, scenario keywords,
    checks))`` (``launch.train_adaptive.fig10_rank``).  Returns each one's
    result on this rank."""
    from repro_torch.launch import train_adaptive

    fns = {"walk": runtime_walk, "pairs": restack_pairs,
           "fig10": lambda g, args: train_adaptive.fig10_rank(g, *args)}
    return [fns[name](group, args) for name, args in items]
