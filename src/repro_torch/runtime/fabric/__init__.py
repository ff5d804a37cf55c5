"""Cross-host coordinator fabric: typed control plane + barrier-safe switches.

Port of ``repro/runtime/fabric/`` (the reference backend, as in ``repro``).
The single-process runtime closes the adaptive loop in ONE process:
coordinator, tuner, telemetry bus and PlanRuntime share an address space.  The
fabric is the same loop stretched over N worker hosts — the paper's §5.4
coordinator-worker dispatch ("the coordinator dispatches the decided plan
to all workers and swaps plans with minimal overhead") as a real control
plane:

==================  ========================================================
module              role
==================  ========================================================
``messages``        the wire protocol: five frozen dataclasses; the wire
                    carries :class:`~repro_torch.core.kinds.ScheduleSpec`
                    coordinates, never plans or compiled artifacts
``protocols``       typed surfaces (``ControlTransport``,
                    ``SwitchParticipant``, re-exported ``TelemetrySink`` /
                    ``IterationHook``) — structural, so core stays
                    runtime-free and tests stay transport-free
``barrier``         the two-phase, deadline-forced switch collective:
                    all hosts switch at one iteration boundary or none;
                    a missed deadline is an ABORT (fleet-wide rollback to
                    the incumbent spec), never a deadlock
``coordinator``     :class:`CoordinatorServer`: aggregates per-host
                    telemetry windows, merges the partitioned network
                    views pessimistically into the central tuner's
                    offline profiler, runs the unmodified AutoTuner, and
                    drives the barrier
``worker``          :class:`WorkerAgent`: wraps a local
                    :class:`~repro_torch.runtime.executor.PlanRuntime` +
                    compiled-step cache; resolves specs locally,
                    precompiles in phase 1, switches warm at the boundary
``transport``       :class:`LocalTransport` (in-process, tier-1 tests,
                    fault-injectable) and :class:`SocketTransport` /
                    :class:`CoordinatorListener` (length-prefixed TCP RPC
                    for real multi-process fleets)
==================  ========================================================

Entry points: ``python -m repro_torch.launch.train_adaptive --fabric N`` runs an
N-host fleet in-process; ``python -m repro_torch.launch.fabric_worker`` is the
per-host process the multi-process integration test (and a real
deployment) launches against a :class:`CoordinatorListener`.
"""

from repro_torch.runtime.fabric.barrier import BarrierPhase, BarrierRecord, SwitchBarrier
from repro_torch.runtime.fabric.coordinator import CoordinatorServer, FabricConfig
from repro_torch.runtime.fabric.messages import (
    OutcomePoll,
    PrepareSwitch,
    ReadyVote,
    SwitchOutcome,
    TelemetryWindow,
)
from repro_torch.runtime.fabric.protocols import (
    ControlTransport,
    IterationHook,
    SwitchParticipant,
    TelemetrySink,
)
from repro_torch.runtime.fabric.transport import (
    CoordinatorListener,
    LocalTransport,
    SocketTransport,
)
from repro_torch.runtime.fabric.worker import WorkerAgent, fabric_probe_links

__all__ = [
    "BarrierPhase",
    "BarrierRecord",
    "SwitchBarrier",
    "CoordinatorServer",
    "FabricConfig",
    "TelemetryWindow",
    "PrepareSwitch",
    "ReadyVote",
    "OutcomePoll",
    "SwitchOutcome",
    "ControlTransport",
    "SwitchParticipant",
    "TelemetrySink",
    "IterationHook",
    "CoordinatorListener",
    "LocalTransport",
    "SocketTransport",
    "WorkerAgent",
    "fabric_probe_links",
]
