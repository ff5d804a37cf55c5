"""Optimizers and learning-rate schedules (port of ``repro.optim``: AdamW and Adafactor)."""

from repro_torch.optim.adafactor import AdafactorState, adafactor_init, adafactor_update
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, decay_mask
from repro_torch.optim.clipping import clip_by_global_norm, global_norm
from repro_torch.optim.optimizer import Optimizer, make_optimizer
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = [
    "AdafactorState",
    "adafactor_init",
    "adafactor_update",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "decay_mask",
    "constant_schedule",
    "cosine_schedule",
    "linear_warmup_cosine",
    "Optimizer",
    "make_optimizer",
    "global_norm",
    "clip_by_global_norm",
]
