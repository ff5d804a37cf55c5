"""Typed control-plane interfaces: the contracts core exposes to runtimes.

A copy of ``repro/core/interfaces.py`` for the port: the standard library
and numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py``
holds it equal to the original on the same inputs.

Before these protocols the coordinator's two extension points were duck-typed — a bare
``telemetry=`` object "with ``publish_iteration``" and an untyped
``on_iteration`` callable — which worked for one in-process harness but
made the cross-host fabric impossible to reason about: a wire protocol
needs *named* contracts.  This module states them as structural
:class:`typing.Protocol`\\ s, so implementations register by shape, not by
import (``core`` still never imports ``repro_torch.runtime``):

* :class:`TelemetrySink` — anything that accepts per-iteration timing
  observations.  Implemented by
  :class:`repro_torch.runtime.telemetry.TelemetryBus` (in-process pub/sub) and
  by the fabric's :class:`~repro_torch.runtime.fabric.worker.WorkerAgent`
  window buffer (cross-host batching).
* :class:`IterationHook` — a participant that reacts to each coordinator
  iteration *by method* (``on_iteration(rec)``), replacing the bare
  callable.  Implemented by
  :class:`repro_torch.runtime.harness.RealEngineHarness`; the method form is
  what lets the fabric treat hooks and switch participants uniformly.

The :class:`~repro_torch.core.coordinator.Coordinator` consumes both via its
``telemetry_sink=`` / ``hooks=`` parameters; the legacy ``telemetry=`` /
``on_iteration=`` kwargs survive as :class:`DeprecationWarning` shims (see
its docstring).  The transport-level protocols of the fabric itself
(``ControlTransport``, ``SwitchParticipant``) live with the fabric in
:mod:`repro_torch.runtime.fabric.protocols` — they are wire contracts, not core
contracts — and re-export these two so the whole control plane is
importable from one place.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, runtime_checkable

if TYPE_CHECKING:  # circular-import-free: only for annotations
    from repro_torch.core.coordinator import IterationRecord
    from repro_torch.core.schedule import SchedulePlan
    from repro_torch.core.taskgraph import StageCosts

__all__ = ["TelemetrySink", "IterationHook"]


@runtime_checkable
class TelemetrySink(Protocol):
    """Receives one observed training-iteration timing.

    ``end_time`` is the absolute time on the *feeding* clock (simulated
    seconds for ``source="sim"``, host wall clock for ``source="engine"``);
    freshness comparisons only ever happen within one clock.  ``costs`` is
    the per-stage compute profile the observation ran under, when the
    publisher knows it (the bandwidth inversion needs it; sinks must
    tolerate ``None``).
    """

    def publish_iteration(
        self,
        *,
        index: int,
        plan: "SchedulePlan",
        seconds: float,
        end_time: float,
        costs: "StageCosts | None" = None,
        source: str = "sim",
    ) -> None: ...


@runtime_checkable
class IterationHook(Protocol):
    """Reacts to one completed coordinator iteration.

    The method form (vs the deprecated bare callable) is deliberate: a
    hook is an *agent* with its own state — the real-engine harness, a
    fabric worker — and the named method is what the fabric's
    ``SwitchParticipant`` protocol extends.
    """

    def on_iteration(self, rec: "IterationRecord") -> object: ...
