"""Optimizer facade: name -> (init, update) with clipping and a schedule.

Port of ``repro/optim/optimizer.py``.  ``make_optimizer("adamw" |
"adafactor", schedule)`` returns an :class:`Optimizer` whose
``update(params, grads, state)`` clips the gradients by their global norm,
takes the rate from the schedule at the state's step and applies the
update.

``layout`` is the reference's stacking of a model's leaves
(:func:`repro_torch.models.transformer.reference_layout`): Adafactor takes
its ranks, statistics and RMS clip over those stacks; without it each leaf
is its own group.  AdamW does not read it: its decay rule is
:func:`~repro_torch.optim.adamw.decay_mask`'s.

``norm_reduce`` is for a model split over ranks: a function that sums the
rank's squared gradient norm over the ranks (the pipeline stages), so that
every rank clips by the norm of the whole tree, as ``repro`` clips its
stacked one.  ``shards`` is Adafactor's view of sharded leaves (its
reductions across a leaf, :mod:`repro_torch.optim.adafactor`).
``Optimizer.config`` keeps the arguments, so that :func:`make_optimizer`
can rebuild the optimizer for a rank's shards
(:mod:`repro_torch.distributed.spmd`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.clipping import clip_by_global_norm
from repro_torch.optim.schedules import Schedule, constant_schedule

__all__ = ["Optimizer", "make_optimizer"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple]  # (params, grads, state) -> (params, state, metrics)
    schedule: Schedule
    #: make_optimizer's arguments: make_optimizer(**{**config, ...}) rebuilds it
    config: dict = dataclasses.field(default_factory=dict)


def make_optimizer(
    name: str = "adamw",
    schedule: Schedule | None = None,
    max_grad_norm: float | None = 1.0,
    norm_reduce=None,
    layout=None,
    shards=None,
    **hyper,
) -> Optimizer:
    config = dict(
        name=name, schedule=schedule, max_grad_norm=max_grad_norm, norm_reduce=norm_reduce, layout=layout,
        shards=shards, **hyper,
    )
    schedule = schedule or constant_schedule(3e-4)
    if name == "adamw":
        init_fn, update_fn = adamw_init, adamw_update
    elif name == "adafactor":

        def init_fn(params):
            return adafactor_init(params, layout, shards)

        def update_fn(params, grads, state, lr, **h):
            return adafactor_update(params, grads, state, lr, layout=layout, shards=shards, **h)

    else:
        raise ValueError(f"unknown optimizer {name!r}")

    def update(params, grads, state):
        lr = schedule(state.step)
        metrics = {"lr": lr}
        if max_grad_norm is not None:
            grads, norm = clip_by_global_norm(grads, max_grad_norm, norm_reduce)
            metrics["grad_norm"] = norm
        new_params, new_state = update_fn(params, grads, state, lr, **hyper)
        return new_params, new_state, metrics

    return Optimizer(name=name, init=init_fn, update=update, schedule=schedule, config=config)
