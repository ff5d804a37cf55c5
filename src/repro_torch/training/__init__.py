"""Training state and steps (port of ``repro.training``; the serve step stays with ``serve``)."""

from repro_torch.training.state import TrainState, create_train_state
from repro_torch.training.steps import (
    make_eval_step,
    make_pipeline_train_step,
    make_train_step,
    pipeline_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_pipeline_train_step",
    "pipeline_train_step",
    "make_eval_step",
]
