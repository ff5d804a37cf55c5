"""Profiling (§4.3, §5.2): stable compute profiles + windowed network probes.

A copy of ``repro/core/profiler.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

Two profilers, with very different lifetimes, exactly as in the paper:

* :class:`ComputeProfiler` — stage forward/backward times.  Devices are
  exclusively assigned, so these are profiled once per (plan, stage) and
  **reused** for the whole run.  Sources: wall-clock timing of the stage
  functions, or an analytic FLOPs/peak model.

* :class:`NetworkProfiler` — cross-stage transfer times are *measured
  end-to-end* ("instead of estimating ... by measuring the bandwidth ...,
  we measure the cross-stage communication time directly"), because neither
  contention nor shape-dependent utilization make bytes/bandwidth reliable.
  Measurements go into a per-(link, nbytes-class) moving-average window and
  must be refreshed periodically.  In this repo the "wire" is a ground-truth
  :class:`~repro_torch.core.network.Network` trace the profiler probes at the
  current simulated time — the same way the paper suspends the schedule and
  probes the real wire.

Windows accept two kinds of samples: *active* probes (``measure`` — the
paper's suspend-and-probe, which costs pipeline time) and *passive* feeds
(``record`` — per-link effective times inferred from whole-iteration
timings by :mod:`repro_torch.runtime.telemetry`, which cost nothing).  Every
sample stamps its link with the feed time, so the tuner can ask
``is_fresh(src, dst, now, max_age)`` and skip the suspension entirely
while passive telemetry keeps the windows warm (see
``AutoTuner(passive_staleness=...)``).
"""

from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Mapping, Sequence

from repro_torch.core.network import Network

__all__ = [
    "MovingAverage",
    "ComputeProfiler",
    "LinkSample",
    "NetworkProfiler",
    "merge_link_samples",
    "time_callable",
]


class MovingAverage:
    def __init__(self, window: int = 8) -> None:
        self.window = window
        self.samples: collections.deque[float] = collections.deque(maxlen=window)

    def add(self, x: float) -> None:
        self.samples.append(float(x))

    @property
    def value(self) -> float:
        if not self.samples:
            raise ValueError("no samples")
        return statistics.fmean(self.samples)

    def __len__(self) -> int:
        return len(self.samples)


def time_callable(fn: Callable[[], object], repeats: int = 3, warmup: int = 1) -> float:
    """Wall-clock a callable (seconds, mean over repeats after warmup)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


@dataclasses.dataclass
class ComputeProfiler:
    """Caches per-(key) stage compute times; profile once, reuse forever."""

    repeats: int = 3
    _cache: dict[object, float] = dataclasses.field(default_factory=dict)

    def profile(self, key: object, fn: Callable[[], object] | None = None,
                analytic_seconds: float | None = None) -> float:
        if key in self._cache:
            return self._cache[key]
        if analytic_seconds is not None:
            value = float(analytic_seconds)
        elif fn is not None:
            value = time_callable(fn, self.repeats)
        else:
            raise ValueError("need fn or analytic_seconds")
        self._cache[key] = value
        return value

    def get(self, key: object) -> float:
        return self._cache[key]


@dataclasses.dataclass(frozen=True)
class LinkSample:
    """One observed effective transfer on a cross-stage link.

    The unit of partitioned telemetry in the coordinator fabric: worker
    hosts ship windows of these (inferred from their own iteration
    timings), and the central tuner's *offline* profiler is fed the merged
    fleet view — see :func:`merge_link_samples`."""

    src: int
    dst: int
    nbytes: float
    duration: float
    now: float

    @property
    def bandwidth(self) -> float:
        return self.nbytes / self.duration if self.duration > 0 else float("inf")


def merge_link_samples(
    per_host: Mapping[str, Sequence[LinkSample]],
    policy: str = "pessimistic",
) -> list[LinkSample]:
    """Merge per-host partitioned link observations into one fleet view.

    Every host sees the same logical pipeline links but its own slice of
    the wire, so the fleet profile per (src, dst, nbytes) class must pick a
    representative.  ``pessimistic`` (the fabric default) keeps the slowest
    observation — min effective bandwidth — because a group-schedule switch
    is only safe if it pays off on the WORST host: the barrier commits all
    hosts or none, and a plan tuned to the fastest host's wire would
    regress the straggler the fleet must wait for anyway.  ``mean`` keeps
    the per-class average instead (load-balanced clusters where transient
    skew should not dominate).  Output is time-ordered so feeding it into
    :meth:`NetworkProfiler.record` reproduces each class's window state
    deterministically.
    """
    if policy not in ("pessimistic", "mean"):
        raise ValueError(f"unknown merge policy {policy!r}")
    by_class: dict[tuple[int, int, float], list[LinkSample]] = {}
    for samples in per_host.values():
        for s in samples:
            by_class.setdefault((s.src, s.dst, float(s.nbytes)), []).append(s)
    merged: list[LinkSample] = []
    for (src, dst, nbytes), group in by_class.items():
        if policy == "pessimistic":
            worst = max(group, key=lambda s: s.duration)
            merged.append(worst)
        else:
            merged.append(
                LinkSample(
                    src, dst, nbytes,
                    statistics.fmean(s.duration for s in group),
                    max(s.now for s in group),
                )
            )
    merged.sort(key=lambda s: (s.now, s.src, s.dst))
    return merged


class NetworkProfiler:
    """Windowed end-to-end transfer-time measurement against a trace world.

    ``measure(src, dst, nbytes, now)`` probes the ground-truth trace at the
    given simulated time (one probe == one timed transfer of ``nbytes``).
    ``effective_time`` returns the moving-average measured duration for that
    link/byte-class, which is what the cost model consumes.

    ``network=None`` builds an **offline** profiler — the coordinator-fabric
    configuration, where the central tuner has no wire of its own and every
    window is fed exclusively through :meth:`record` /
    :meth:`record_samples` with telemetry merged from the worker hosts
    (:func:`merge_link_samples`).  An offline profiler refuses
    :meth:`measure` loudly; pair it with
    ``AutoTuner(passive_staleness=...)`` so fresh windows are read instead
    of probed.
    """

    def __init__(self, network: Network | None, window: int = 8) -> None:
        self.network = network
        self.window = window
        self._avg: dict[tuple[int, int, float], MovingAverage] = {}
        # (src, dst) -> (last feed time, nbytes class of that feed): one
        # stamp per link, because bandwidth extrapolates across byte
        # classes while durations do not
        self._link_stamp: dict[tuple[int, int], tuple[float, float]] = {}

    def _slot(self, src: int, dst: int, nbytes: float) -> MovingAverage:
        key = (src, dst, float(nbytes))
        if key not in self._avg:
            self._avg[key] = MovingAverage(self.window)
        return self._avg[key]

    def _stamp(self, src: int, dst: int, nbytes: float, now: float) -> None:
        prev = self._link_stamp.get((src, dst))
        if prev is None or now >= prev[0]:
            self._link_stamp[(src, dst)] = (float(now), float(nbytes))

    def measure(self, src: int, dst: int, nbytes: float, now: float,
                probes: int = 3, spacing: float = 0.05) -> float:
        """Run ``probes`` timed transfers starting at ``now``; record & return mean."""
        if self.network is None:
            raise RuntimeError(
                "offline NetworkProfiler (network=None) cannot probe the wire; "
                "feed it via record()/record_samples() and run the tuner with "
                "passive_staleness set"
            )
        slot = self._slot(src, dst, nbytes)
        t = now
        durations = []
        trace = self.network.trace(src, dst)
        for _ in range(probes):
            fin = trace.finish_time(t, nbytes)
            durations.append(fin - t)
            t = fin + spacing
        mean = statistics.fmean(durations)
        slot.add(mean)
        self._stamp(src, dst, nbytes, now)
        return mean

    def record(self, src: int, dst: int, nbytes: float, duration: float,
               now: float) -> None:
        """Passive feed: push an *observed* effective transfer time into the
        link's window without touching the wire (no suspension, no probe).
        Used by the runtime telemetry bus with per-link times inferred from
        real iteration timings."""
        self._slot(src, dst, nbytes).add(duration)
        self._stamp(src, dst, nbytes, now)

    def record_samples(self, samples: Sequence[LinkSample]) -> None:
        """Bulk passive feed of (merged) :class:`LinkSample` observations —
        the coordinator fabric's path into the central windows."""
        for s in samples:
            self.record(s.src, s.dst, s.nbytes, s.duration, now=s.now)

    def last_update(self, src: int, dst: int) -> float | None:
        """Time of the most recent sample (active or passive) on the link."""
        stamp = self._link_stamp.get((src, dst))
        return stamp[0] if stamp else None

    def is_fresh(self, src: int, dst: int, now: float, max_age: float) -> bool:
        last = self.last_update(src, dst)
        return last is not None and (now - last) <= max_age

    def link_bandwidth(self, src: int, dst: int) -> float:
        """Effective bandwidth implied by the link's most recently fed byte
        class (bandwidth extrapolates across classes; durations do not)."""
        stamp = self._link_stamp.get((src, dst))
        if stamp is None:
            raise ValueError(f"no samples on link {(src, dst)}")
        _, nbytes = stamp
        return self.effective_bandwidth(src, dst, nbytes)

    def effective_time(self, src: int, dst: int, nbytes: float) -> float:
        return self._slot(src, dst, nbytes).value

    def effective_bandwidth(self, src: int, dst: int, nbytes: float) -> float:
        t = self.effective_time(src, dst, nbytes)
        return nbytes / t if t > 0 else float("inf")
