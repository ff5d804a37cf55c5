"""Predicted-vs-observed drift: how far has the cost model wandered?

A copy of ``repro/obs/drift.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

Every adaptive decision in this repo rests on the simulator's makespan
predictions (``simulate()`` over a :class:`TaskGraph`).  If those
predictions drift from what the engine actually measures — stale profiler
bandwidths, a mis-calibrated device spec, interference the model doesn't
represent — the tuner keeps "optimizing" against fiction.  The
:class:`DriftMonitor` is the smoke detector: it subscribes to the
:class:`TelemetryBus`, joins each observed iteration duration against the
predicted duration for the plan that ran it, and maintains

    ``model_drift_ratio`` = median(observed / predicted) over a rolling
    window

as a registry gauge.  1.0 is a perfect model; persistent deviation past
``alert_threshold`` flips :attr:`drifting` (and records a flight event) —
the signal a future recalibration loop will consume (see ROADMAP).

Predictions come from an injected ``predict_fn(plan_name) -> seconds``
(typically closing over the tuner's latest per-candidate estimates, which
are exactly the numbers the decision was made with), so the monitor itself
stays stdlib-only and import-cycle-free.
"""

from __future__ import annotations

import collections
from typing import Callable

from repro_torch.obs.flight_recorder import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["DriftMonitor"]


def _median(values: list[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return ordered[mid]
    return 0.5 * (ordered[mid - 1] + ordered[mid])


class DriftMonitor:
    """Joins observed iteration durations against model predictions.

    Parameters
    ----------
    predict_fn:
        ``plan_name -> predicted seconds`` or ``None`` when the model has no
        current prediction for that plan (the sample is then skipped and
        counted in ``drift_samples_skipped_total``).
    registry:
        Metrics registry receiving the ``model_drift_ratio`` gauge and the
        sample counters; a private one is created if omitted.
    window:
        Rolling window length (median over the last ``window`` ratios).
    alert_threshold:
        Relative deviation from 1.0 that flips :attr:`drifting`
        (0.5 -> alert outside [1/1.5, 1.5]).
    source:
        Which bus samples to join: ``"engine"`` (wall-clock measurements),
        ``"sim"`` (coordinator-simulated durations — deterministic, what the
        bench gate uses), or ``None`` for all.
    """

    def __init__(
        self,
        predict_fn: Callable[[str], float | None],
        registry: MetricsRegistry | None = None,
        window: int = 16,
        alert_threshold: float = 0.5,
        source: str | None = None,
        flight: FlightRecorder | None = None,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.predict_fn = predict_fn
        self.registry = registry or MetricsRegistry()
        self.window = window
        self.alert_threshold = alert_threshold
        self.source = source
        self.flight = flight
        self._ratios: collections.deque[float] = collections.deque(maxlen=window)
        self.drifting = False
        self._gauge = self.registry.gauge("model_drift_ratio")
        self._joined = self.registry.counter("drift_samples_joined_total")
        self._skipped = self.registry.counter("drift_samples_skipped_total")

    # TelemetryBus subscriber entry point
    def on_iteration(self, timing) -> None:
        """Bus callback: join one :class:`IterationTiming` sample."""
        if self.source is not None and getattr(timing, "source", None) != self.source:
            return
        predicted = self.predict_fn(timing.plan.name)
        if not predicted or predicted <= 0 or timing.seconds <= 0:
            self._skipped.inc()
            return
        ratio = timing.seconds / predicted
        self._ratios.append(ratio)
        self._joined.inc()
        current = self.ratio()
        self._gauge.set(current)
        was = self.drifting
        self.drifting = (
            current > 1.0 + self.alert_threshold
            or current < 1.0 / (1.0 + self.alert_threshold)
        )
        if self.drifting and not was and self.flight is not None:
            self.flight.record(
                "drift_alert",
                ratio=current,
                plan=timing.plan.name,
                threshold=self.alert_threshold,
                samples=len(self._ratios),
            )

    def ratio(self) -> float:
        """Rolling-median observed/predicted ratio (1.0 before any sample)."""
        if not self._ratios:
            return 1.0
        return _median(list(self._ratios))

    @property
    def samples(self) -> int:
        return len(self._ratios)
