"""SLO accounting: per-request TTFT/TPOT, token-latency quantiles, queue gauges.

Copy of ``repro/serve/slo.py`` over the port's ``obs``.  Everything lands
in the observability currency — labeled
:class:`~repro_torch.obs.metrics.MetricsRegistry` series (bucketed histograms, so
p50/p99 come from ``Histogram.quantile`` instead of re-implemented bucket
math) plus request-lifecycle spans on per-slot trace tracks:

==============================  =============================================
series                          meaning
==============================  =============================================
``serve_ttft_seconds``          arrival -> first token (queue wait + prefill)
``serve_tpot_seconds``          mean inter-token gap per completed request
``serve_token_latency_seconds``  every decode token's gap to its predecessor
``serve_queue_depth``           gauge, sampled at each boundary
``serve_batch_occupancy``       gauge, in-flight slots after admission
``serve_requests_*_total``      admitted / completed counters
``serve_tokens_total``          decode tokens emitted
==============================  =============================================

Trace tracks are ``{track}/slot{j}`` (``track`` defaults to
``host0/requests``): one span per request from admission to completion.  One
slot holds one request at a time, so spans per track are pairwise disjoint
and the existing ``validate_no_overlap`` gate covers serving timelines.

Definitions: TTFT is measured from *arrival* (queue wait counts — that is the
latency a client sees), TPOT from the first token over the remaining
``n - 1`` gaps.  A request that never decodes past its prefill token has no
TPOT sample.  SLO attainment is the fraction of completed requests meeting
both targets (a missing target always passes).
"""

from __future__ import annotations

from repro_torch.serve.batching import InFlight

__all__ = ["DEFAULT_LATENCY_BUCKETS", "SLOTracker"]

#: log-spaced upper bounds, 100 µs .. ~100 s — wide enough for simulated
#: ticks and real smoke-model wall clock alike
DEFAULT_LATENCY_BUCKETS = tuple(
    round(base * 10.0**exp, 10)
    for exp in range(-4, 3)
    for base in (1.0, 1.6, 2.5, 4.0, 6.3)
)


class SLOTracker:
    def __init__(
        self,
        metrics,
        trace=None,
        track: str = "host0/requests",
        ttft_slo: float | None = None,
        tpot_slo: float | None = None,
        buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS,
    ) -> None:
        self.metrics = metrics
        self.trace = trace
        self.track = track
        self.ttft_slo = ttft_slo
        self.tpot_slo = tpot_slo
        self.h_ttft = metrics.histogram("serve_ttft_seconds", buckets=buckets)
        self.h_tpot = metrics.histogram("serve_tpot_seconds", buckets=buckets)
        self.h_token = metrics.histogram("serve_token_latency_seconds", buckets=buckets)
        # exact samples alongside the bucketed wire format: the bench gates
        # compare p99 across runs whose distributions often share a bucket,
        # so quantiles in summary() come from the raw simulated-time samples
        self._ttft: list[float] = []
        self._tpot: list[float] = []
        self._token: list[float] = []
        self.g_queue = metrics.gauge("serve_queue_depth")
        self.g_occupancy = metrics.gauge("serve_batch_occupancy")
        self.c_admitted = metrics.counter("serve_requests_admitted_total")
        self.c_completed = metrics.counter("serve_requests_completed_total")
        self.c_tokens = metrics.counter("serve_tokens_total")
        self.completed = 0
        self.slo_met = 0

    # -- boundary gauges -------------------------------------------------------

    def on_boundary(self, queue_depth: int, occupancy: int) -> None:
        self.g_queue.set(queue_depth)
        self.g_occupancy.set(occupancy)

    # -- request lifecycle -----------------------------------------------------

    def on_admit(self, inf: InFlight, now: float) -> None:
        self.c_admitted.inc()

    def on_first_token(self, inf: InFlight, now: float) -> None:
        """Prefill completed and emitted the request's first token."""
        inf.first_token_time = now
        inf.last_token_time = now
        inf.tokens_emitted += 1
        self.c_tokens.inc()
        self.h_ttft.observe(now - inf.request.arrival_time)
        self._ttft.append(now - inf.request.arrival_time)

    def on_token(self, inf: InFlight, now: float) -> None:
        """One decode token emitted at simulated/observed time ``now``."""
        if inf.last_token_time is not None:
            self.h_token.observe(now - inf.last_token_time)
            self._token.append(now - inf.last_token_time)
        inf.last_token_time = now
        inf.tokens_emitted += 1
        self.c_tokens.inc()

    def on_complete(self, inf: InFlight, now: float) -> None:
        req = inf.request
        ttft = (
            inf.first_token_time - req.arrival_time
            if inf.first_token_time is not None
            else now - req.arrival_time
        )
        tpot = None
        if inf.tokens_emitted > 1 and inf.first_token_time is not None:
            tpot = (inf.last_token_time - inf.first_token_time) / (
                inf.tokens_emitted - 1
            )
            self.h_tpot.observe(tpot)
            self._tpot.append(tpot)
        self.c_completed.inc()
        self.completed += 1
        ok = (self.ttft_slo is None or ttft <= self.ttft_slo) and (
            self.tpot_slo is None or tpot is None or tpot <= self.tpot_slo
        )
        if ok:
            self.slo_met += 1
        if self.trace is not None:
            from repro_torch.obs.trace import quantize_sim_span

            start_s, dur_s = quantize_sim_span(inf.admit_time, now - inf.admit_time)
            self.trace.add_span(
                f"{self.track}/slot{inf.slot}",
                f"req{req.rid}",
                start_s=start_s,
                dur_s=dur_s,
                ttft=round(ttft, 6),
                tokens=inf.tokens_emitted,
                slo_met=ok,
            )

    # -- summaries -------------------------------------------------------------

    def attainment(self) -> float:
        """Fraction of completed requests inside both SLO targets (1.0 when
        nothing has completed — an empty server violates no SLO)."""
        return self.slo_met / self.completed if self.completed else 1.0

    @staticmethod
    def _quantile(samples: list[float], q: float) -> float:
        """Exact linear-interpolated quantile over the raw samples (the
        bucketed ``Histogram.quantile`` stays the dashboard view; gates that
        compare two runs need sub-bucket resolution)."""
        if not samples:
            return 0.0
        xs = sorted(samples)
        pos = q * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def summary(self) -> dict:
        """The quantile slate every consumer (entry point, bench, tests)
        reads — exact quantiles from the retained samples; the bucketed
        histograms carry the same distributions into the metrics registry."""
        return {
            "completed": self.completed,
            "tokens": self.c_tokens.value(),
            "ttft_p50": self._quantile(self._ttft, 0.5),
            "ttft_p99": self._quantile(self._ttft, 0.99),
            "tpot_p50": self._quantile(self._tpot, 0.5),
            "tpot_p99": self._quantile(self._tpot, 0.99),
            "token_latency_p50": self._quantile(self._token, 0.5),
            "token_latency_p99": self._quantile(self._token, 0.99),
            "slo_attainment": self.attainment(),
        }
