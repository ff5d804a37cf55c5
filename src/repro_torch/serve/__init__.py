"""Serving: adaptive pipeline-parallel decode serving (port of ``repro.serve``).

=============  ==============================================================
module         contents
=============  ==============================================================
``arrival``    :class:`Request`, :class:`ArrivalProcess` -- seeded Poisson /
               Markov-modulated bursty arrivals (a copy of the reference's)
``batching``   :class:`RequestQueue`, :class:`ContinuousBatcher`,
               :class:`InFlight` -- admit/retire at tick boundaries over
               fixed decode slots (a copy of the reference's)
``slo``        :class:`SLOTracker` -- TTFT/TPOT/token-latency histograms,
               queue gauges, per-slot request-lifecycle trace spans (a copy)
``runtime``    :class:`ServeRuntime` -- the simulated-time tick loop wiring
               arrivals, the batcher, the tuner (with
               :func:`make_slo_objective`), the telemetry bus and the SLO
               tracker together, measuring each tick's wall time
``engine``     :class:`ServeEngine` -- real prefill/decode programs behind
               the tick loop, per plan through the stateless
               :class:`~repro_torch.runtime.executor.PlanRuntime`
               warm-switch path
=============  ==============================================================

Entry points: ``python -m repro_torch.launch.serve_adaptive`` and
``python -m repro_torch.launch.serve_decode``.
"""

from repro_torch.serve.arrival import ArrivalProcess, Request
from repro_torch.serve.batching import ContinuousBatcher, InFlight, RequestQueue
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.runtime import ServeRuntime, ServeTick, make_slo_objective
from repro_torch.serve.slo import DEFAULT_LATENCY_BUCKETS, SLOTracker

__all__ = [
    "ArrivalProcess",
    "Request",
    "RequestQueue",
    "ContinuousBatcher",
    "InFlight",
    "SLOTracker",
    "DEFAULT_LATENCY_BUCKETS",
    "ServeRuntime",
    "ServeTick",
    "make_slo_objective",
    "ServeEngine",
]
