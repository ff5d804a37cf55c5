"""The schedule and decision layer of the port: copies of ``repro.core``
(numpy and the standard library only).

    plan      = make_plan(S, M, spec=ScheduleSpec(...))
    cands     = enumerate_candidates(S, B, memory_model, limit)
    tuner     = AutoTuner(cands, stage_costs_for, NetworkProfiler(net))
    summary   = Coordinator(tuner, net, B, interval).run(iters)

Device specs (``devicespec.py``) are exported here.  Calibration runs the
engines' task bodies, so it imports torch and the pipeline: import it from
``repro_torch.core.calibrate``.  The ASCII renderer is
``repro_torch.core.viz`` (``render_tick_table``, ``render_sim_timeline``).
"""

from repro_torch.core.candidates import (
    Candidate,
    enumerate_candidates,
    largest_admissible_warmup,
)
from repro_torch.core.coordinator import (
    Coordinator,
    IterationRecord,
    RunSummary,
    shifted_network,
)
from repro_torch.core.costmodel import CostModel, closed_form_1f1b_length, link_probe_specs
from repro_torch.core.devicespec import (
    DeviceSpec,
    DeviceSpecError,
    ProgramCounts,
    WorkloadProfile,
    derive_memory_model,
    derive_stage_costs,
    load_device_spec,
    load_workload_profile,
)
from repro_torch.core.interfaces import IterationHook, TelemetrySink
from repro_torch.core.kinds import (
    KindSpec,
    ScheduleSpec,
    SearchSpace,
    get_kind,
    known_kinds,
    register_kind,
    registered_kinds,
    saved_residual_kinds,
    warmup_kinds,
)
from repro_torch.core.memory_model import (
    ZB_SLOT_POLICIES,
    MemoryModel,
    StageMemorySpec,
    limit_curve,
    predicted_peak_live,
)
from repro_torch.core.network import (
    BandwidthTrace,
    BurstyTrace,
    Network,
    PeriodicPreemptionTrace,
    RegimeTrace,
    StableTrace,
    uniform_network,
)
from repro_torch.core.placement import optimize_weight_placement
from repro_torch.core.profiler import (
    ComputeProfiler,
    LinkSample,
    MovingAverage,
    NetworkProfiler,
    merge_link_samples,
)
from repro_torch.core.schedule import (
    Op,
    PlanEdge,
    SchedulePlan,
    TabularPlan,
    Task,
    lower_to_table,
    make_plan,
    normalize_warmup,
    peak_live_activations,
    tick_table,
)
from repro_torch.core.simulator import PipelineSimulator, SimResult, simulate, simulate_plan
from repro_torch.core.taskgraph import StageCosts, TaskGraph, TransferSpec, build_task_graph
from repro_torch.core.tuner import AutoTuner, TuningRecord

__all__ = [
    "Candidate",
    "enumerate_candidates",
    "largest_admissible_warmup",
    "Coordinator",
    "IterationRecord",
    "RunSummary",
    "shifted_network",
    "CostModel",
    "closed_form_1f1b_length",
    "link_probe_specs",
    "DeviceSpec",
    "DeviceSpecError",
    "ProgramCounts",
    "WorkloadProfile",
    "derive_memory_model",
    "derive_stage_costs",
    "load_device_spec",
    "load_workload_profile",
    "IterationHook",
    "TelemetrySink",
    "KindSpec",
    "ScheduleSpec",
    "SearchSpace",
    "get_kind",
    "known_kinds",
    "register_kind",
    "registered_kinds",
    "saved_residual_kinds",
    "warmup_kinds",
    "ZB_SLOT_POLICIES",
    "MemoryModel",
    "StageMemorySpec",
    "limit_curve",
    "predicted_peak_live",
    "BandwidthTrace",
    "BurstyTrace",
    "Network",
    "PeriodicPreemptionTrace",
    "RegimeTrace",
    "StableTrace",
    "uniform_network",
    "optimize_weight_placement",
    "ComputeProfiler",
    "LinkSample",
    "MovingAverage",
    "NetworkProfiler",
    "merge_link_samples",
    "Op",
    "PlanEdge",
    "SchedulePlan",
    "TabularPlan",
    "Task",
    "lower_to_table",
    "make_plan",
    "normalize_warmup",
    "peak_live_activations",
    "tick_table",
    "PipelineSimulator",
    "SimResult",
    "simulate",
    "simulate_plan",
    "StageCosts",
    "TaskGraph",
    "TransferSpec",
    "build_task_graph",
    "AutoTuner",
    "TuningRecord",
]

