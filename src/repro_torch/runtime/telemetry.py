"""Passive telemetry (§5.4 / §5.2): iteration timings -> profiler windows.

A copy of ``repro/runtime/telemetry.py`` for the port: the standard library
and numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py``
holds it equal to the original on the same inputs.

The paper's tuner *suspends* the pipeline to probe every cross-stage link
— pure overhead charged to ``tuning_overhead`` at every interval.  But a
running pipeline is itself a continuous network measurement: every
iteration's wall time already reflects what the preempted links did to the
schedule.  This module closes that loop:

* :class:`IterationTiming` — one observed iteration (which plan ran, how
  long it took, on which clock).  Published by
  :class:`~repro_torch.core.coordinator.Coordinator` for simulated iterations
  (``source="sim"`` — the ground-truth timing in this repo's trace world)
  and by :class:`~repro_torch.runtime.executor.PlanRuntime` for real compiled
  steps (``source="engine"``).
* :class:`TelemetryBus` — a tiny synchronous pub/sub fan-out; subscribers
  are plain callables.
* :class:`PassiveLinkFeed` — the subscriber that feeds
  :class:`~repro_torch.core.profiler.NetworkProfiler` windows *passively*: given
  one whole-iteration timing it solves the scalar inverse problem "which
  uniform effective bandwidth makes the cost model reproduce the observed
  length" (:func:`invert_effective_bandwidth` — the estimate is monotone
  non-increasing in bandwidth, so bisection is exact) and records the
  implied per-link transfer times into the moving-average windows.

With the windows warm, ``AutoTuner(passive_staleness=...)`` skips the
suspend-and-probe for every fresh link and the coordinator's charged
``tuning_overhead`` drops toward zero — suspend-and-probe survives only as
the fallback for links whose windows went stale (e.g. right after a long
idle period or before the first iteration).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.costmodel import CostModel, link_probe_specs
from repro_torch.core.profiler import NetworkProfiler
from repro_torch.core.schedule import SchedulePlan
from repro_torch.core.taskgraph import StageCosts

__all__ = [
    "IterationTiming",
    "TelemetryBus",
    "PassiveLinkFeed",
    "link_probe_specs",  # re-export: the tuner/telemetry shared link list
    "invert_effective_bandwidth",
]


@dataclasses.dataclass
class IterationTiming:
    """One observed training iteration on some clock.

    ``seconds`` is the iteration's wall time; ``end_time`` is the absolute
    time on the *feeding* clock (simulated seconds for ``source="sim"``,
    host wall clock for ``source="engine"``) — freshness comparisons only
    ever happen within one clock.
    """

    index: int
    plan: SchedulePlan
    seconds: float
    end_time: float
    costs: StageCosts | None = None
    source: str = "sim"


class TelemetryBus:
    """Synchronous pub/sub for iteration timings (the per-iteration bus).

    ``metrics`` (optional :class:`~repro_torch.obs.metrics.MetricsRegistry`) makes
    the bus self-reporting: every publish bumps
    ``telemetry_published_total{source=...}`` and observes the iteration
    length into ``telemetry_iteration_seconds{source=...}``."""

    def __init__(self, metrics=None) -> None:
        self.history: list[IterationTiming] = []
        self._subscribers: list[Callable[[IterationTiming], None]] = []
        self.metrics = metrics
        if metrics is not None:
            self._m_published = metrics.counter("telemetry_published_total")
            self._m_seconds = metrics.histogram("telemetry_iteration_seconds")

    def subscribe(self, fn: Callable[[IterationTiming], None]) -> None:
        self._subscribers.append(fn)

    def publish(self, timing: IterationTiming) -> None:
        self.history.append(timing)
        if self.metrics is not None:
            self._m_published.inc(source=timing.source)
            self._m_seconds.observe(timing.seconds, source=timing.source)
        for fn in self._subscribers:
            fn(timing)

    def publish_iteration(self, **kw) -> None:
        """Keyword convenience used by the coordinator (which stays
        duck-typed against this class — core never imports runtime)."""
        self.publish(IterationTiming(**kw))


def invert_effective_bandwidth(
    plan: SchedulePlan,
    costs: StageCosts,
    observed_seconds: float,
    cost_model: CostModel | None = None,
    bw_lo: float = 1e-6,
    bw_hi: float = 1e15,
    rel_tol: float = 1e-6,
    max_iters: int = 60,
) -> float:
    """Scalar effective bandwidth whose frozen-network cost-model estimate
    reproduces the observed iteration length.

    The estimate is monotone non-increasing in the uniform link bandwidth
    (faster links never lengthen a schedule), so bisection recovers the
    unique crossing.  Saturated cases clamp: an iteration at least as fast
    as the infinite-bandwidth estimate returns ``bw_hi`` (compute-bound —
    the wire told us nothing beyond "fast enough"), one slower than the
    ``bw_lo`` estimate returns ``bw_lo``.
    """
    cm = cost_model or CostModel()
    links = {(s, d) for s, d, _ in link_probe_specs(plan, costs)}
    if not links:
        return bw_hi

    def estimate(bw: float) -> float:
        return cm.estimate(plan, costs, {link: bw for link in links})

    if observed_seconds <= estimate(bw_hi):
        return bw_hi
    if observed_seconds >= estimate(bw_lo):
        return bw_lo
    lo, hi = bw_lo, bw_hi
    for _ in range(max_iters):
        mid = math.sqrt(lo * hi)  # bandwidths span decades: bisect in log space
        est = estimate(mid)
        if abs(est - observed_seconds) <= rel_tol * observed_seconds:
            return mid
        if est > observed_seconds:  # too slow a wire: raise bandwidth
            lo = mid
        else:
            hi = mid
        if hi / lo <= 1.0 + rel_tol:
            break
    return math.sqrt(lo * hi)


class PassiveLinkFeed:
    """Bus subscriber that keeps the profiler's windows warm for free.

    Each published iteration with a ``costs`` profile is inverted to a
    scalar effective bandwidth and written into every exercised link's
    moving-average window via :meth:`NetworkProfiler.record` — zero wire
    traffic, zero suspension.  ``sources`` filters which clock feeds the
    profiler (timings from a different clock must not mix)."""

    def __init__(
        self,
        profiler: NetworkProfiler,
        cost_model: CostModel | None = None,
        sources: tuple[str, ...] = ("sim",),
    ) -> None:
        self.profiler = profiler
        self.cost_model = cost_model or CostModel()
        self.sources = sources
        self.inferred: list[tuple[int, float]] = []  # (iteration index, bw)

    def __call__(self, timing: IterationTiming) -> None:
        if timing.costs is None or timing.source not in self.sources:
            return
        bw = invert_effective_bandwidth(
            timing.plan, timing.costs, timing.seconds, self.cost_model
        )
        self.inferred.append((timing.index, bw))
        for src, dst, nbytes in link_probe_specs(timing.plan, timing.costs):
            duration = nbytes / bw if bw > 0 else float("inf")
            self.profiler.record(src, dst, nbytes, duration, now=timing.end_time)
