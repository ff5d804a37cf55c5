"""Unified observability layer: traces, metrics, flight recorder, drift.

A copy of ``repro/obs/__init__.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

The observe half of Ada-Grouper's observe-then-adapt loop as a first-class
subsystem (see ``src/repro/obs/README.md`` for the Perfetto walkthrough):

===================  =======================================================
module               provides
===================  =======================================================
``trace``            :class:`TraceRecorder` spans/instants -> Chrome/Perfetto
                     JSON; :func:`render_simulated_trace` for the predicted
                     timeline; schema + overlap validators (CI gate)
``metrics``          :class:`MetricsRegistry` — labeled counter/gauge/
                     histogram series with snapshot/delta export; the single
                     currency behind ``fabric_metrics()``, ``CacheStats``,
                     and switch timings
``flight_recorder``  :class:`FlightRecorder` — bounded ring of structured
                     events (tuner decisions, barrier transitions, plan
                     switches), auto-dumped on barrier abort / worker failure
``drift``            :class:`DriftMonitor` — rolling observed/predicted
                     ``model_drift_ratio`` gauge off the telemetry bus
===================  =======================================================

Everything here is stdlib-only at module level, so any layer (core, runtime,
fabric, launch) may depend on it without import cycles; only
:func:`render_simulated_trace` touches the core stack, lazily.

:class:`Observability` bundles one of each for plumbing through
constructors: ``obs = Observability.create(trace_clock=...)`` then pass
``obs`` (or its parts) down.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.flight_recorder import FlightRecorder
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import (
    TraceRecorder,
    TraceValidationError,
    merge_traces,
    render_simulated_trace,
    spans_by_track,
    validate_chrome_trace,
    validate_no_overlap,
)

__all__ = [
    "Observability",
    "TraceRecorder",
    "TraceValidationError",
    "merge_traces",
    "render_simulated_trace",
    "spans_by_track",
    "validate_chrome_trace",
    "validate_no_overlap",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "FlightRecorder",
    "DriftMonitor",
]


@dataclasses.dataclass
class Observability:
    """One trace recorder + metrics registry + flight recorder, passed as a
    unit through constructors that want all three."""

    trace: TraceRecorder
    metrics: MetricsRegistry
    flight: FlightRecorder

    @classmethod
    def create(
        cls,
        clock: Callable[[], float] | None = None,
        flight_capacity: int = 256,
        flight_dump_path: str | None = None,
    ) -> "Observability":
        """Build a bundle sharing one injected ``clock`` (tests pass a tick
        clock; production defaults to ``time.monotonic``)."""
        return cls(
            trace=TraceRecorder(clock=clock),
            metrics=MetricsRegistry(),
            flight=FlightRecorder(
                capacity=flight_capacity, dump_path=flight_dump_path, clock=clock
            ),
        )
