"""Step factories: the gradient-accumulated train step, the pipeline train
step, the eval step and the serve step.

Port of ``repro/training/steps.py:55-119`` and of the pipeline ``step_fn``
of ``repro/launch/train.py::run_pipeline``.  The train and eval steps
take a ``loss_fn(params, batch) -> (loss, metrics)`` over a dict batch.
``make_train_step(..., num_microbatches=M)`` cuts the batch into M equal
micro-batches along its first axis and runs them one after another (the
reference's ``lax.scan``), summing fp32 gradients; the step's loss and
gradients are the means over the micro-batches, which equal the
global-batch ones when the micro-batches are equal-sized.

Gradients are taken with ``torch.autograd.grad`` with respect to detached
copies of the parameter leaves, so the parameters themselves never carry
autograd state; the optimizer then updates them in place.

``make_pipeline_train_step(staged, plan, optimizer)`` runs one step of a
pipeline schedule on one card: the reference engine walks the plan over
``[M, b, T]`` tokens and labels, the replicated leaves' gradients are
summed over the stages (``reduce_replicated``), and the optimizer clips and
applies them.

``pipeline_train_step(staged, plan, group, optimizer)`` is the multi-rank
form (``repro``'s ``pipeline_train_step``): one rank's engine gradients
(``pipeline.engine.make_pipeline_step``), already summed and reduced over
the ranks, then the optimizer on the rank's own parameters and moments.
Build the optimizer with ``norm_reduce`` summing over the stage group, so
that every rank clips by the norm of the whole model.

``make_serve_step(decode_fn, temperature)`` is one sampled decode step:
greedy at temperature 0 (or without a generator), else a categorical draw
from ``softmax(logits / T)`` with the caller's ``torch.Generator``, so a
fixed generator reproduces the draws.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from repro_torch.core.schedule import SchedulePlan
from repro_torch.optim import Optimizer
from repro_torch.pipeline.engine import make_pipeline_step, reduce_replicated, reference_pipeline_grads
from repro_torch.pipeline.stage import StagedModel
from repro_torch.training.state import TrainState
from repro_torch.tree import flatten, tree_map

__all__ = ["make_train_step", "make_pipeline_train_step", "pipeline_train_step", "make_eval_step", "make_serve_step"]

LossFn = Callable[[Any, Mapping[str, torch.Tensor]], tuple[torch.Tensor, dict]]


def _microbatches(batch: Mapping[str, torch.Tensor], M: int) -> list[dict]:
    """[B, ...] -> M dicts of [B/M, ...] views."""
    for name, x in batch.items():
        if x.shape[0] % M:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not split into {M} micro-batches")
    return [{k: v.chunk(M)[i] for k, v in batch.items()} for i in range(M)]


def _grads_of(loss_fn: LossFn, params, batch):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(leaves, batch)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    return loss.detach(), metrics, tree_map(lambda _: next(grads), params)


def make_train_step(loss_fn: LossFn, optimizer: Optimizer, num_microbatches: int = 1):
    """Returns ``step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned."""
    M = num_microbatches

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        if M == 1:
            loss, metrics, grads = _grads_of(loss_fn, state.params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            loss_sum, grad_sum = None, None
            for mb in _microbatches(batch, M):
                loss, _, grads = _grads_of(loss_fn, state.params, mb)
                if grad_sum is None:  # an fp32 copy: the sum is ours to add into
                    loss_sum = loss
                    grad_sum = tree_map(lambda g: g.to(torch.float32, copy=True), grads)
                else:
                    loss_sum = loss_sum + loss
                    tree_map(lambda s, g: s.add_(g), grad_sum, grads)
                del grads
            loss = loss_sum / M
            grads = tree_map(lambda g: g / M, grad_sum)
            metrics = {}
        params, opt_state, opt_metrics = optimizer.update(state.params, grads, state.opt_state)
        state.step, state.params, state.opt_state = state.step + 1, params, opt_state
        return state, {"loss": loss, **metrics, **opt_metrics}

    return step


def make_pipeline_train_step(staged: StagedModel, plan: SchedulePlan, optimizer: Optimizer):
    """Returns ``step(state, tokens, labels) -> (state, metrics)`` over
    ``[M, b, T]`` tokens and labels, ``state.params`` a list of
    per-virtual-stage trees; the state is updated in place and returned."""

    def step(state: TrainState, tokens, labels):
        loss, grads = reference_pipeline_grads(staged, state.params, tokens, labels, plan)
        grads = reduce_replicated(grads)
        params, opt_state, metrics = optimizer.update(state.params, grads, state.opt_state)
        state.step, state.params, state.opt_state = state.step + 1, params, opt_state
        return state, {"loss": loss, **metrics}

    return step


def pipeline_train_step(staged: StagedModel, plan: SchedulePlan, group, optimizer: Optimizer):
    """Returns one rank's ``step(state, tokens, labels) -> (state, metrics)``
    over the global ``[M, b, T]`` tokens and labels, ``state.params`` the
    rank's list of per-chunk trees; the state is updated in place and
    returned.  ``step.engine`` is the rank's engine (its channel figures)."""
    engine = make_pipeline_step(staged, plan, group)

    def step(state: TrainState, tokens, labels):
        loss, grads = engine(state.params, tokens, labels)
        params, opt_state, metrics = optimizer.update(state.params, grads, state.opt_state)
        state.step, state.params, state.opt_state = state.step + 1, params, opt_state
        return state, {"loss": loss, **metrics}

    step.engine = engine
    return step


def make_eval_step(loss_fn: LossFn):
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = loss_fn(params, batch)
        return {"loss": loss, **metrics}

    return step


def make_serve_step(decode_fn: Callable[..., tuple[torch.Tensor, Any]], temperature: float = 0.0):
    """Returns ``serve(params, cache, index, inputs, generator=None) -> (tokens, cache)``.

    ``decode_fn(params, cache, index, **inputs)`` produces next-token logits
    ``[B, 1, V]`` and the updated cache; sampling is greedy at T=0 (or
    without a generator), else categorical, drawn with ``generator``."""

    @torch.no_grad()
    def serve(params, cache, index, inputs: Mapping[str, torch.Tensor], generator: torch.Generator | None = None):
        logits, new_cache = decode_fn(params, cache, index, **inputs)
        logits = logits[:, -1, :].float()
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            tokens = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tokens = logits.argmax(dim=-1)
        return tokens, new_cache

    return serve
