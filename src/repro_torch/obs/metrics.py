"""Labeled counter/gauge/histogram registry — the repo's single metrics
currency.

A copy of ``repro/obs/metrics.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

Before this module, every subsystem grew its own ad-hoc numbers dict:
``CoordinatorServer.fabric_metrics()`` hand-maintained nine keys,
``CompiledStepCache`` mutated a ``CacheStats`` dataclass, ``PlanRuntime``
kept a ``SwitchEvent`` list.  Those public dict/dataclass *shapes* stay
(back-compat), but their values now come from one
:class:`MetricsRegistry` so a trace/export/bench consumer sees every
subsystem through the same lens.

Model (deliberately Prometheus-shaped, stdlib-only):

* a **counter** only goes up (``events_published_total``),
* a **gauge** is set to the current value (``model_drift_ratio``,
  ``telemetry_windows`` — resident count, falls on compaction),
* a **histogram** records observations and exposes
  count/sum/min/max/mean (``barrier_latency_seconds``); registered with
  ``buckets=`` (ascending upper bounds) it additionally keeps per-bucket
  counts and answers :meth:`HistogramValue.quantile` — the single p50/p99
  implementation the serve SLO tracker, the bench gates and the tests all
  read instead of each re-deriving bucket math.

Series are keyed by ``(name, frozen-labels)``; :meth:`MetricsRegistry.snapshot`
returns a flat deterministic dict and :meth:`MetricsRegistry.delta` diffs two
snapshots (counters/histograms subtract, gauges take the newer value).
Bucketed histograms keep the same four-suffix snapshot shape as unbucketed
ones — buckets exist for quantiles, not for export bloat.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field

__all__ = [
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramValue",
]

_LabelKey = tuple[tuple[str, str], ...]


def _labelkey(labels: dict[str, str] | None) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: _LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


@dataclass
class HistogramValue:
    """Aggregate view of one histogram series.

    With ``buckets`` (ascending upper bounds) each observation also lands in
    a bucket count (one extra overflow bucket past the last bound), which is
    what :meth:`quantile` interpolates over."""

    count: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    buckets: tuple[float, ...] | None = None
    bucket_counts: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.buckets is not None and not self.bucket_counts:
            self.bucket_counts = [0] * (len(self.buckets) + 1)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if self.buckets is not None:
            self.bucket_counts[bisect.bisect_left(self.buckets, value)] += 1

    def quantile(self, q: float) -> float:
        """Quantile estimate by linear interpolation inside the landing
        bucket (Prometheus-style), clamped to the observed [min, max] so a
        coarse top bucket cannot report a latency nobody saw.  Requires the
        series to have been registered with ``buckets=``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.buckets is None:
            raise ValueError(
                "quantile() needs a bucketed histogram — register it with "
                "histogram(name, buckets=(...))"
            )
        if not self.count:
            return 0.0
        rank = q * self.count
        cum = 0.0
        for i, n in enumerate(self.bucket_counts):
            if not n:
                continue
            if cum + n >= rank:
                lo = self.buckets[i - 1] if i > 0 else self.min
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return min(max(lo, self.min), self.max)
                frac = (rank - cum) / n
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            cum += n
        return self.max


class _Instrument:
    """Handle bound to one (name, registry) pair; label-resolved on use."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self._registry = registry
        self.name = name


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease ({amount})")
        self._registry._add(self.name, _labelkey(labels), amount)

    def value(self, **labels) -> float:
        return self._registry._get(self.name, _labelkey(labels), 0.0)


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._registry._set(self.name, _labelkey(labels), value)

    def inc(self, amount: float = 1, **labels) -> None:
        self._registry._add(self.name, _labelkey(labels), amount)

    def dec(self, amount: float = 1, **labels) -> None:
        self._registry._add(self.name, _labelkey(labels), -amount)

    def value(self, **labels) -> float:
        return self._registry._get(self.name, _labelkey(labels), 0.0)


class Histogram(_Instrument):
    kind = "histogram"

    def observe(self, value: float, **labels) -> None:
        self._registry._observe(self.name, _labelkey(labels), value)

    def value(self, **labels) -> HistogramValue:
        v = self._registry._get(self.name, _labelkey(labels), None)
        return v if isinstance(v, HistogramValue) else HistogramValue()

    def quantile(self, q: float, **labels) -> float:
        return self.value(**labels).quantile(q)


@dataclass
class _Series:
    kind: str
    values: dict = field(default_factory=dict)  # _LabelKey -> float | HistogramValue
    buckets: tuple[float, ...] | None = None  # histogram series only


class MetricsRegistry:
    """Thread-safe registry of named, labeled series.

    Instruments are created idempotently: asking twice for
    ``counter("x")`` returns handles onto the same series; asking for the
    same name with a different type raises (one name, one meaning).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}

    # -- instrument factories -------------------------------------------------

    def _instrument(self, cls, name: str):
        with self._lock:
            series = self._series.get(name)
            if series is None:
                self._series[name] = _Series(kind=cls.kind)
            elif series.kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {series.kind}, "
                    f"requested {cls.kind}"
                )
        return cls(self, name)

    def counter(self, name: str) -> Counter:
        return self._instrument(Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._instrument(Gauge, name)

    def histogram(self, name: str, buckets=None) -> Histogram:
        """``buckets``: optional strictly-ascending upper bounds enabling
        :meth:`Histogram.quantile`.  One name, one meaning: re-registering
        with *different* buckets raises; re-registering with ``None``
        inherits the existing boundaries."""
        if buckets is not None:
            buckets = tuple(float(b) for b in buckets)
            if list(buckets) != sorted(set(buckets)):
                raise ValueError(
                    f"histogram {name!r} buckets must be strictly ascending: {buckets}"
                )
        handle = self._instrument(Histogram, name)
        with self._lock:
            series = self._series[name]
            if buckets is not None:
                if series.buckets is not None and series.buckets != buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{series.buckets}, requested {buckets}"
                    )
                if series.buckets is None and series.values:
                    raise ValueError(
                        f"histogram {name!r} already has bucketless observations; "
                        "register buckets before the first observe()"
                    )
                series.buckets = buckets
        return handle

    # -- storage (called by instrument handles) -------------------------------

    def _add(self, name: str, key: _LabelKey, amount: float) -> None:
        with self._lock:
            values = self._series[name].values
            values[key] = values.get(key, 0.0) + amount

    def _set(self, name: str, key: _LabelKey, value: float) -> None:
        with self._lock:
            self._series[name].values[key] = value

    def _observe(self, name: str, key: _LabelKey, value: float) -> None:
        with self._lock:
            values = self._series[name].values
            hist = values.get(key)
            if hist is None:
                hist = values[key] = HistogramValue(
                    buckets=self._series[name].buckets
                )
            hist.observe(value)

    def _get(self, name: str, key: _LabelKey, default):
        with self._lock:
            series = self._series.get(name)
            if series is None:
                return default
            return series.values.get(key, default)

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> dict[str, float]:
        """Flat deterministic dict: ``name`` / ``name{k=v,...}`` -> value.
        Histogram series expand into ``_count``/``_sum``/``_min``/``_max``
        suffixed entries."""
        out: dict[str, float] = {}
        with self._lock:
            for name in sorted(self._series):
                series = self._series[name]
                for key in sorted(series.values):
                    value = series.values[key]
                    label = _series_name(name, key)
                    if isinstance(value, HistogramValue):
                        out[f"{label}_count"] = value.count
                        out[f"{label}_sum"] = value.sum
                        if value.count:
                            out[f"{label}_min"] = value.min
                            out[f"{label}_max"] = value.max
                    else:
                        out[label] = value
        return out

    def delta(self, before: dict[str, float], after: dict[str, float] | None = None) -> dict[str, float]:
        """Diff two snapshots: counters/histogram aggregates subtract, gauges
        take the newer value; series absent from ``before`` count from 0."""
        if after is None:
            after = self.snapshot()
        kinds: dict[str, str] = {}
        with self._lock:
            for name, series in self._series.items():
                kinds[name] = series.kind
        out: dict[str, float] = {}
        for label, value in after.items():
            base = label.split("{", 1)[0]
            for suffix in ("_count", "_sum", "_min", "_max"):
                if base.endswith(suffix) and base[: -len(suffix)] in kinds:
                    base = base[: -len(suffix)]
                    break
            if kinds.get(base) == "gauge":
                out[label] = value
            else:
                out[label] = value - before.get(label, 0.0)
        return out
