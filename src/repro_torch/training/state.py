"""Train state: params, optimizer state and step (port of ``repro/training/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.optim import Optimizer

__all__ = ["TrainState", "create_train_state"]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any


def create_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(step=0, params=params, opt_state=optimizer.init(params))
