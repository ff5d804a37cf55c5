"""Time-varying link bandwidth models for preempted-network simulation.

A copy of ``repro/core/network.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

The paper evaluates on shared production clusters where cross-stage links are
preempted by other tenants' traffic.  A CPU container cannot create real
contention, so the discrete-event simulator consumes *bandwidth traces*:
piecewise-constant ``bytes/s`` as a function of time, per directed link.

Trace families (each maps to a scenario in the paper):

* :class:`StableTrace` — dedicated cluster (the 1F1B-optimal baseline world).
* :class:`PeriodicPreemptionTrace` — "network resources between two stages
  are periodically occupied by other tasks" (§2.5).
* :class:`BurstyTrace` — Markov on/off contention, the general cloud case
  (§4.4, Fig 4 sudden fluctuations).
* :class:`RegimeTrace` — piecewise regimes over hours, for the Fig-10
  adaptive-tuning experiment (preemption appears, eases, returns).

All traces implement ``bw_at(t) -> (bandwidth, valid_until)`` and transfers
are integrated exactly over the piecewise segments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

__all__ = [
    "BandwidthTrace",
    "StableTrace",
    "PeriodicPreemptionTrace",
    "BurstyTrace",
    "RegimeTrace",
    "ScaledTrace",
    "Network",
    "uniform_network",
]

_INF = math.inf


class BandwidthTrace:
    """Piecewise-constant bandwidth over time (bytes/second)."""

    def bw_at(self, t: float) -> tuple[float, float]:
        """Return ``(bandwidth, valid_until)`` — constant on ``[t, valid_until)``."""
        raise NotImplementedError

    def finish_time(self, start: float, nbytes: float) -> float:
        """Absolute time at which ``nbytes`` started at ``start`` completes."""
        if nbytes <= 0:
            return start
        t = float(start)
        remaining = float(nbytes)
        for _ in range(10_000_000):
            bw, until = self.bw_at(t)
            if bw <= 0.0:
                if until == _INF:
                    raise RuntimeError("link permanently dead; transfer never completes")
                t = until
                continue
            dt = remaining / bw
            if until == _INF or t + dt <= until + 1e-15:
                return t + dt
            remaining -= bw * (until - t)
            t = until
        raise RuntimeError("finish_time did not converge")

    def mean_bw(self, t0: float, t1: float) -> float:
        """Average bandwidth over ``[t0, t1]`` (for diagnostics/plots)."""
        if t1 <= t0:
            return self.bw_at(t0)[0]
        total = 0.0
        t = t0
        while t < t1:
            bw, until = self.bw_at(t)
            seg_end = min(until, t1)
            total += bw * (seg_end - t)
            t = seg_end
        return total / (t1 - t0)


@dataclasses.dataclass
class StableTrace(BandwidthTrace):
    bandwidth: float  # bytes/s

    def bw_at(self, t: float) -> tuple[float, float]:
        return self.bandwidth, _INF


@dataclasses.dataclass
class PeriodicPreemptionTrace(BandwidthTrace):
    """Full bandwidth, dropping to ``low`` for ``duty`` fraction of each period."""

    high: float
    low: float
    period: float
    duty: float  # fraction of the period spent preempted, in [0, 1]
    phase: float = 0.0

    def bw_at(self, t: float) -> tuple[float, float]:
        x = (t + self.phase) % self.period
        pre_len = self.duty * self.period
        if x < pre_len:  # preempted window first
            return self.low, t + (pre_len - x)
        return self.high, t + (self.period - x)


class BurstyTrace(BandwidthTrace):
    """Markov on/off contention: exponential dwell times, pre-sampled lazily.

    While "contended", bandwidth is ``high * contended_frac`` (other tenants
    take the rest); dwell times are exponential with the given means.
    Deterministic given the seed, so experiments are reproducible.
    """

    def __init__(
        self,
        high: float,
        contended_frac: float = 0.2,
        mean_free: float = 1.0,
        mean_contended: float = 0.5,
        seed: int = 0,
    ) -> None:
        self.high = high
        self.low = high * contended_frac
        self.mean_free = mean_free
        self.mean_contended = mean_contended
        self._rng = np.random.default_rng(seed)
        self._breaks = [0.0]
        self._states = [True]  # True = free
        self._extend_until(16.0)

    def _extend_until(self, t: float) -> None:
        while self._breaks[-1] <= t:
            free = self._states[-1]
            mean = self.mean_free if free else self.mean_contended
            dwell = float(self._rng.exponential(mean)) + 1e-9
            self._breaks.append(self._breaks[-1] + dwell)
            self._states.append(not free)

    def bw_at(self, t: float) -> tuple[float, float]:
        self._extend_until(t + 1.0)
        i = int(np.searchsorted(np.asarray(self._breaks), t, side="right")) - 1
        i = max(i, 0)
        bw = self.high if self._states[i] else self.low
        return bw, self._breaks[i + 1]


class RegimeTrace(BandwidthTrace):
    """Concatenation of traces over ``[t_i, t_{i+1})`` windows (Fig-10 hours)."""

    def __init__(self, breakpoints: list[float], traces: list[BandwidthTrace]) -> None:
        assert len(traces) == len(breakpoints) + 1
        self.breakpoints = list(breakpoints)
        self.traces = list(traces)

    def _regime(self, t: float) -> tuple[BandwidthTrace, float]:
        i = int(np.searchsorted(np.asarray(self.breakpoints), t, side="right"))
        end = self.breakpoints[i] if i < len(self.breakpoints) else _INF
        return self.traces[i], end

    def bw_at(self, t: float) -> tuple[float, float]:
        trace, regime_end = self._regime(t)
        bw, until = trace.bw_at(t)
        return bw, min(until, regime_end)


@dataclasses.dataclass
class ScaledTrace(BandwidthTrace):
    base: BandwidthTrace
    scale: float

    def bw_at(self, t: float) -> tuple[float, float]:
        bw, until = self.base.bw_at(t)
        return bw * self.scale, until


class Network:
    """Per-directed-link traces: ``(src_stage, dst_stage) -> BandwidthTrace``."""

    def __init__(
        self,
        default: BandwidthTrace,
        links: dict[tuple[int, int], BandwidthTrace] | None = None,
    ) -> None:
        self.default = default
        self.links = dict(links or {})

    def trace(self, src: int, dst: int) -> BandwidthTrace:
        return self.links.get((src, dst), self.default)

    @classmethod
    def build(
        cls,
        num_stages: int,
        factory: Callable[[int, int], BandwidthTrace],
    ) -> "Network":
        links = {}
        for s in range(num_stages - 1):
            links[(s, s + 1)] = factory(s, s + 1)
            links[(s + 1, s)] = factory(s + 1, s)
        return cls(default=StableTrace(_INF), links=links)


def uniform_network(num_stages: int, trace_factory: Callable[[], BandwidthTrace]) -> Network:
    """A network where every directed link gets an independent trace instance."""
    return Network.build(num_stages, lambda a, b: trace_factory())
