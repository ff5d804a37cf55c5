"""Live plan-switch runtime: the adaptive loop on the port's engines.

Port of ``repro.runtime`` (the reference and spmd backends; the fabric
comes with ROADMAP queue 1, item 8):

``compile_cache``  step programs keyed by the lowered ``TabularPlan``, built
                   on a background worker for the tuner's top-N candidates
``executor``       :class:`PlanRuntime`: owns parameters and AdamW state,
                   switches plans at iteration boundaries across schedule
                   kinds, restacking the layout bitwise at the interleaved
                   boundary (across the ranks under spmd, wherever the
                   placement changes)
``telemetry``      the per-iteration timing bus; simulated iteration lengths
                   feed ``NetworkProfiler``'s windows passively
``harness``        ``RealEngineHarness``: the coordinator's hook that mirrors
                   each tuner decision onto the live runtime (entry point:
                   ``python -m repro_torch.launch.train_adaptive``)
"""

from repro_torch.runtime.compile_cache import CacheStats, CompiledEntry, CompiledStepCache
from repro_torch.runtime.executor import (
    IterationResult,
    PlanRuntime,
    SwitchEvent,
    restack_across_ranks,
    restack_train_state,
)
from repro_torch.runtime.harness import HarnessRecord, RealEngineHarness
from repro_torch.runtime.telemetry import (
    IterationTiming,
    PassiveLinkFeed,
    TelemetryBus,
    invert_effective_bandwidth,
    link_probe_specs,
)

__all__ = [
    "CacheStats",
    "CompiledEntry",
    "CompiledStepCache",
    "IterationResult",
    "PlanRuntime",
    "SwitchEvent",
    "restack_train_state",
    "restack_across_ranks",
    "HarnessRecord",
    "RealEngineHarness",
    "IterationTiming",
    "PassiveLinkFeed",
    "TelemetryBus",
    "invert_effective_bandwidth",
    "link_probe_specs",
]
