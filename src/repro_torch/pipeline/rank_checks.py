"""Rank entry functions that hold the multi-rank engine to a reference.

Each runs inside :func:`repro_torch.pipeline.ranks.spawn` (so it lives in
the package, where a spawned process can import it) and brings what the
check compares back to global rank 0:

* :func:`engine_case` runs one plan's engine step on this rank and gathers
  the loss and the gradients;
* :func:`engine_matrix` runs a list of such cases and returns rank 0's
  results as ``repro``'s flat, stacked numpy layout;
* :func:`train_steps` runs ``pipeline_train_step`` for a few steps and
  gathers the parameters after each.

A case is a dict: ``cfg`` (a :class:`~repro_torch.models.common.ModelConfig`),
``spec`` (``ScheduleSpec`` keywords), ``M``, ``tokens`` and ``labels``
(numpy ``[M, b, T]``), and either ``params`` (``repro``'s flat stacked
parameters as numpy, carried across by the bridge) or ``seed`` (the rank
draws its own stages with ``StagedModel.init_stages``).
"""

from __future__ import annotations

import torch

from repro_torch import bridge
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline.engine import make_pipeline_step
from repro_torch.pipeline.stage import StagedModel
from repro_torch.training import create_train_state, pipeline_train_step

__all__ = ["engine_case", "engine_matrix", "train_steps"]


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


def train_steps(group, case, lr: float, steps: list) -> dict:
    """``pipeline_train_step`` (AdamW at constant ``lr``, clip 1, the norm
    summed over the stage group) for one step per ``(tokens, labels)`` of
    ``steps``.  Returns ``{"steps": [...]}``: per step the loss and clip
    norm, and on rank 0 the parameters after it as ``repro``'s flat stacked
    numpy tree; rank 0 also returns the parameters gathered before the
    first step (``initial``)."""
    plan, staged, local, _, _ = _setup(group, case)
    opt = make_optimizer(
        "adamw", constant_schedule(lr), norm_reduce=lambda t: group.all_reduce_sum(t, "stage")
    )
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
