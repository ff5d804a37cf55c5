"""The schedule layer of the port: copies of ``repro.core.schedule`` and
``repro.core.kinds`` (numpy only).  The rest of ``repro.core`` (simulator,
cost and memory models, tuner, calibration) comes with later slices."""

from repro_torch.core.kinds import (
    KindSpec,
    ScheduleSpec,
    get_kind,
    registered_kinds,
    saved_residual_kinds,
    warmup_kinds,
)
from repro_torch.core.schedule import (
    Op,
    SchedulePlan,
    TabularPlan,
    Task,
    lower_to_table,
    make_plan,
    peak_live_activations,
)

__all__ = [
    "KindSpec",
    "ScheduleSpec",
    "get_kind",
    "registered_kinds",
    "saved_residual_kinds",
    "warmup_kinds",
    "Op",
    "SchedulePlan",
    "TabularPlan",
    "Task",
    "lower_to_table",
    "make_plan",
    "peak_live_activations",
]
