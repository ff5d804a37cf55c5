"""Learning-rate schedules as step -> lr functions (port of ``repro/optim/schedules.py``).

Steps are Python ints and rates Python floats: the step count lives on the
host, so no device value is read to set the rate.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["Schedule", "constant_schedule", "cosine_schedule", "linear_warmup_cosine"]

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(lr)


def cosine_schedule(peak_lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        frac = min(max(step / max(total_steps, 1), 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return peak_lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(
    peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1
) -> Schedule:
    cos = cosine_schedule(peak_lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        return cos(step - warmup_steps)

    return fn
