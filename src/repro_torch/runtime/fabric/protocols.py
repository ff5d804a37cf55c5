"""Typed control-plane protocols of the coordinator fabric.

Port of ``repro/runtime/fabric/protocols.py``.

Structural (:class:`typing.Protocol`) rather than nominal, for the same
reason :mod:`repro_torch.core.interfaces` is: the decision stack (``core/``)
must stay importable without the runtime, and third-party transports or
participants plug in by shape, not by inheritance.

Three roles:

* :class:`ControlTransport` — the client half a worker holds: one
  ``request(msg) -> reply`` call.  The fabric is worker-initiated (workers
  have no listening socket; coordinator commands piggyback on replies), so
  this one method IS the whole transport surface.  Implementations:
  :class:`~repro_torch.runtime.fabric.transport.LocalTransport` (in-process,
  tier-1 testable) and
  :class:`~repro_torch.runtime.fabric.transport.SocketTransport` (length-prefixed
  TCP RPC across processes/hosts).
* :class:`SwitchParticipant` — anything that can take part in the two-phase
  switch collective: prepare (resolve + precompile a spec, vote), commit
  (apply at the boundary), abort (keep the incumbent).
  :class:`~repro_torch.runtime.fabric.worker.WorkerAgent` implements it over a
  live :class:`~repro_torch.runtime.executor.PlanRuntime`; tests implement it
  over nothing at all.
* :class:`TelemetrySink` / :class:`IterationHook` — re-exported from
  :mod:`repro_torch.core.interfaces`: the fabric's telemetry windows flow into
  the same typed sink surface the single-process Coordinator publishes to.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.interfaces import IterationHook, TelemetrySink
from repro_torch.core.kinds import ScheduleSpec
from repro_torch.runtime.fabric.messages import PrepareSwitch, SwitchOutcome

__all__ = [
    "ControlTransport",
    "SwitchParticipant",
    "TelemetrySink",
    "IterationHook",
]


@runtime_checkable
class ControlTransport(Protocol):
    """Client-side control-plane channel to the coordinator."""

    def request(self, msg: object) -> object | None:
        """Deliver ``msg``; return the coordinator's reply (None = no
        command pending).  Raises on a dead coordinator — the fabric treats
        transport failure as fatal for the worker, never as silence."""
        ...


@runtime_checkable
class SwitchParticipant(Protocol):
    """A party in the two-phase plan-switch collective."""

    def prepare(self, cmd: PrepareSwitch) -> object:
        """Phase 1: resolve ``cmd.spec`` locally, warm the executable, and
        return the ReadyVote to send (ready=False if resolution failed)."""
        ...

    def apply_outcome(self, outcome: SwitchOutcome) -> None:
        """Phase 2: commit (switch to the prepared spec before running
        iteration ``outcome.boundary``) or abort (keep the incumbent)."""
        ...

    @property
    def current_spec(self) -> ScheduleSpec:
        """The spec this participant is actually running."""
        ...
