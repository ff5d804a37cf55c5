"""Serving: seeded arrivals, continuous batching and the serving engine.

Port of ``repro.serve``: ``arrival`` and ``batching`` are copies of the
reference's numpy-only modules, ``engine`` and ``runtime`` are ported.  The
entry point is ``python -m repro_torch.launch.serve_decode``.
"""

from repro_torch.serve.arrival import ArrivalProcess, Request
from repro_torch.serve.batching import ContinuousBatcher, InFlight, RequestQueue
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.runtime import ServeRuntime, ServeTick

__all__ = [
    "ArrivalProcess",
    "Request",
    "RequestQueue",
    "ContinuousBatcher",
    "InFlight",
    "ServeEngine",
    "ServeRuntime",
    "ServeTick",
]
