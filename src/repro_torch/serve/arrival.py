"""Seeded request-arrival processes for decode serving.

A verbatim copy of ``repro/serve/arrival.py`` (numpy only): the same seed
gives the same requests in both packages.

The serving counterpart of :class:`repro.core.network.BurstyTrace`: where the
network layer models *link* contention as a seeded Markov on/off process, this
module models *demand* the same way — a Poisson base arrival rate modulated by
exponential calm/burst dwell phases.  Arrivals are pre-sampled lazily off one
``np.random.default_rng(seed)`` stream (the BurstyTrace idiom), so a scenario
is bit-reproducible given its seed and never depends on the wall clock: the
serve runtime advances simulated time and asks ``drain(until)`` for everything
that has arrived by then.

``burst_factor=1`` degenerates to a plain Poisson process; ``rate=0`` is an
empty process (useful for hand-built batcher tests).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Request", "ArrivalProcess"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a prompt to prefill plus a decode budget."""

    rid: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int


class ArrivalProcess:
    """Markov-modulated Poisson arrivals, deterministic given ``seed``.

    * ``rate`` — base arrivals/second during calm phases.
    * ``burst_factor`` / ``mean_calm`` / ``mean_burst`` — during a burst
      phase (exponential dwell ``mean_burst``) the instantaneous rate is
      ``rate * burst_factor``; phases alternate like a bursty link trace.
    * ``prompt_len`` / ``new_tokens`` — inclusive ``(lo, hi)`` ranges each
      request samples its prompt length and decode budget from.

    Exponential inter-arrival sampling is memoryless, so crossing a phase
    boundary simply re-draws at the new rate from the boundary — exact, not
    a thinning approximation.
    """

    def __init__(
        self,
        rate: float,
        seed: int = 0,
        burst_factor: float = 1.0,
        mean_calm: float = 10.0,
        mean_burst: float = 2.0,
        prompt_len: tuple[int, int] = (16, 16),
        new_tokens: tuple[int, int] = (8, 8),
    ) -> None:
        if rate < 0:
            raise ValueError(f"rate must be >= 0, got {rate}")
        if burst_factor < 1.0:
            raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
        self.rate = rate
        self.burst_factor = burst_factor
        self.mean_calm = mean_calm
        self.mean_burst = mean_burst
        self.prompt_len = prompt_len
        self.new_tokens = new_tokens
        self._rng = np.random.default_rng(seed)
        self._requests: list[Request] = []
        self._cursor = 0  # next index drain() hands out
        self._t = 0.0  # sampling frontier
        self._in_burst = False
        self._phase_end = self._draw_phase_end(0.0)

    # -- lazy pre-sampling ----------------------------------------------------

    def _draw_phase_end(self, start: float) -> float:
        if self.burst_factor == 1.0:
            return math.inf  # plain Poisson: one infinite calm phase
        mean = self.mean_burst if self._in_burst else self.mean_calm
        return start + float(self._rng.exponential(mean)) + 1e-9

    def _current_rate(self) -> float:
        return self.rate * (self.burst_factor if self._in_burst else 1.0)

    def _extend_until(self, t: float) -> None:
        if self.rate == 0.0:
            return
        while self._t <= t:
            rate = self._current_rate()
            dt = float(self._rng.exponential(1.0 / rate)) + 1e-12
            if self._t + dt > self._phase_end:
                # memoryless: jump to the boundary and re-draw at the new rate
                self._t = self._phase_end
                self._in_burst = not self._in_burst
                self._phase_end = self._draw_phase_end(self._t)
                continue
            self._t += dt
            self._requests.append(
                Request(
                    rid=len(self._requests),
                    arrival_time=self._t,
                    prompt_len=int(
                        self._rng.integers(self.prompt_len[0], self.prompt_len[1] + 1)
                    ),
                    max_new_tokens=int(
                        self._rng.integers(self.new_tokens[0], self.new_tokens[1] + 1)
                    ),
                )
            )

    # -- consumption ----------------------------------------------------------

    def drain(self, until: float) -> list[Request]:
        """Every request with ``arrival_time <= until`` not yet drained, in
        arrival order.  Monotone: later calls only see later arrivals."""
        self._extend_until(until)
        out = []
        while (
            self._cursor < len(self._requests)
            and self._requests[self._cursor].arrival_time <= until
        ):
            out.append(self._requests[self._cursor])
            self._cursor += 1
        return out

    def next_arrival_after(self, t: float) -> float | None:
        """Arrival time of the first undrained request after ``t`` (for the
        idle skip when the batch and queue are both empty)."""
        if self.rate == 0.0:
            return None
        self._extend_until(t + 1.0)
        i = self._cursor
        while True:
            while i < len(self._requests):
                if self._requests[i].arrival_time > t:
                    return self._requests[i].arrival_time
                i += 1
            self._extend_until(self._t + max(2.0 / self.rate, 1.0))
