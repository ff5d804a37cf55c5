"""The fabric wire protocol: every message that crosses the control plane.

Port of ``repro/runtime/fabric/messages.py``; every field is a plain Python
value (a ``ScheduleSpec``, ints, floats, strings), never a tensor, so
:class:`~repro_torch.runtime.fabric.transport.SocketTransport` pickles no
device memory.

The coordinator fabric exchanges exactly five typed messages, all frozen
dataclasses (hashable, picklable, diffable in traces).  The design rule:
**the wire carries coordinates, never artifacts** — a plan switch ships the
frozen :class:`~repro_torch.core.kinds.ScheduleSpec` (a few ints and a string)
and each worker resolves it to its own locally-lowered
:class:`~repro_torch.core.schedule.TabularPlan` and locally-compiled executable.
Nothing lowered, traced, or compiled ever crosses a host boundary.

Message flow (worker-initiated — commands piggyback on replies, so workers
never need a listening socket)::

    worker                          coordinator
      |--- TelemetryWindow ------------>|   per iteration: timings + link
      |<-- PrepareSwitch | None --------|   samples; reply carries a pending
      |                                 |   PREPARE if a barrier is open
      |--- ReadyVote ------------------>|   after precompiling the target
      |<-- None ------------------------|
      |--- OutcomePoll ---------------->|   blocking at the boundary
      |<-- SwitchOutcome | None --------|   None = undecided, poll again
                                            (a deadline forces a decision,
                                            so the poll loop terminates)

Barrier state machine and rollback rules: see
:mod:`repro_torch.runtime.fabric.barrier`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.profiler import LinkSample

__all__ = [
    "TelemetryWindow",
    "PrepareSwitch",
    "ReadyVote",
    "OutcomePoll",
    "SwitchOutcome",
]


@dataclasses.dataclass(frozen=True)
class TelemetryWindow:
    """One host's telemetry for one completed iteration.

    ``samples`` are the per-link effective transfer times the host inferred
    from its own iteration timing (its *partition* of the fleet's network
    view); the coordinator merges partitions pessimistically before feeding
    the central profiler.  ``spec`` is what the host actually ran — the
    coordinator cross-checks it against the fleet incumbent to detect
    divergence (a host that missed a commit would show up here)."""

    host: str
    iteration: int
    seconds: float
    end_time: float
    spec: ScheduleSpec
    samples: tuple[LinkSample, ...] = ()
    loss: float = float("nan")


@dataclasses.dataclass(frozen=True)
class PrepareSwitch:
    """Phase 1: the coordinator proposes switching the fleet to ``spec``
    at iteration ``boundary`` (the first iteration to RUN the new spec).

    ``deadline`` is on the coordinator's clock: votes landing after it are
    void and the barrier aborts — the deadline is what makes the boundary
    poll loop terminate (decision by ``deadline`` at the latest, commit or
    abort, never silence)."""

    epoch: int
    spec: ScheduleSpec
    boundary: int
    deadline: float


@dataclasses.dataclass(frozen=True)
class ReadyVote:
    """Phase 1 response: the host resolved + precompiled the target spec
    (``ready=True``) or could not (``ready=False``, ``reason`` says why).
    A single not-ready vote aborts the epoch immediately."""

    epoch: int
    host: str
    ready: bool
    precompile_seconds: float = 0.0
    reason: str = ""


@dataclasses.dataclass(frozen=True)
class OutcomePoll:
    """A host blocked at the switch boundary asking for the verdict."""

    epoch: int
    host: str
    iteration: int


@dataclasses.dataclass(frozen=True)
class SwitchOutcome:
    """Phase 2: the barrier's verdict for ``epoch``.

    ``committed=True``: every host applies ``spec`` before running
    iteration ``boundary`` — all hosts switch at the same boundary.
    ``committed=False``: every host keeps (or rolls back to) the incumbent
    spec; ``reason`` records why (a refusing vote, or hosts missing at the
    deadline)."""

    epoch: int
    committed: bool
    spec: ScheduleSpec
    boundary: int
    reason: str = ""
