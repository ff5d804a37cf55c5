"""ServeRuntime: the continuous-batching tick loop over a fixed decode grid.

Port of the boundary loop of ``repro/serve/runtime.py::ServeRuntime.run``.
Each tick:

1. **boundary** -- drain arrivals into the FIFO queue, retire finished
   requests, admit queued ones into freed slots (retire before admit);
2. **prefill** -- a boundary that admitted requests prefills them and emits
   each one's first token;
3. **decode tick** -- otherwise every in-flight request advances one token
   through the engine's grouped decode.

The simulated clock advances by a caller-given ``price_fn(phase) ->
seconds`` where the reference prices the tick with ``simulate_plan``; a
fixed price keeps admissions identical on the CPU and on the card.  The
measured wall time of every tick is recorded beside it.  The tuner, the
telemetry bus and the SLO tracker of the reference come with the
schedule-layer and observability slices.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from repro_torch.serve.arrival import ArrivalProcess
from repro_torch.serve.batching import ContinuousBatcher, RequestQueue

__all__ = ["ServeTick", "ServeRuntime"]


@dataclasses.dataclass
class ServeTick:
    index: int
    start: float  # simulated clock
    seconds: float  # simulated price
    wall_seconds: float  # measured, the engine's work synchronised
    phase: str  # "prefill" | "decode"
    occupancy: int
    queue_depth: int


class ServeRuntime:
    """Drives continuous-batching serving of ``engine`` on an ``[M, b]`` grid."""

    def __init__(
        self,
        engine,
        arrivals: ArrivalProcess,
        price_fn: Callable[[str], float],
        num_microbatches: int,
    ) -> None:
        self.engine = engine
        self.arrivals = arrivals
        self.price_fn = price_fn
        self.num_microbatches = num_microbatches
        self.queue = RequestQueue()
        self.batcher = ContinuousBatcher(engine.max_slots)
        self.ticks: list[ServeTick] = []
        self.completed: list = []  # retired InFlight records, completion order
        self.now = 0.0

    def _tick(self, phase: str, work: Callable[[], None]) -> None:
        start = self.now
        t0 = time.perf_counter()
        work()
        self.engine.synchronize()
        wall = time.perf_counter() - t0
        self.now += self.price_fn(phase)
        self.ticks.append(
            ServeTick(
                index=len(self.ticks),
                start=start,
                seconds=self.now - start,
                wall_seconds=wall,
                phase=phase,
                occupancy=self.batcher.occupancy,
                queue_depth=len(self.queue),
            )
        )

    def run(self, max_requests: int, max_ticks: int = 100_000) -> dict:
        """Serve until ``max_requests`` requests completed (or ``max_ticks``)."""
        self.engine.switch_to(self.num_microbatches)
        while len(self.completed) < max_requests and len(self.ticks) < max_ticks:
            # -- boundary: drain -> retire -> admit ---------------------------
            for req in self.arrivals.drain(self.now):
                self.queue.push(req)
            done = self.batcher.retire_finished(self.now)
            self.completed.extend(done)
            if done:
                self.engine.release([inf.slot for inf in done])
            if len(self.completed) >= max_requests:
                break
            admitted = self.batcher.admit(self.queue, self.now)
            if self.batcher.occupancy == 0:
                nxt = self.arrivals.next_arrival_after(self.now)
                if nxt is None:
                    break
                self.now = nxt
                continue
            # -- prefill pass (admission boundary) ----------------------------
            if admitted:
                self._tick("prefill", lambda: self.engine.prefill(admitted))
                for inf in admitted:
                    inf.first_token_time = inf.last_token_time = self.now
                    inf.tokens_emitted += 1
                continue  # back to the boundary: budget-1 requests retire now
            # -- decode tick --------------------------------------------------
            in_flight = self.batcher.in_flight
            self._tick("decode", lambda: self.engine.decode_tick(in_flight))
            for inf in in_flight:
                inf.last_token_time = self.now
                inf.tokens_emitted += 1
        return self.summary()

    def summary(self) -> dict:
        decode = [t.wall_seconds for t in self.ticks if t.phase == "decode"]
        prefill = self.engine.prefill_seconds
        wall = sum(t.wall_seconds for t in self.ticks)
        tokens = sum(inf.tokens_emitted for inf in self.completed)
        return {
            "requests_completed": len(self.completed),
            "requests_admitted": self.batcher.total_admitted,
            "tokens": tokens,
            "ticks": len(self.ticks),
            "decode_ticks": len(decode),
            "prefill_ticks": len(self.ticks) - len(decode),
            "prefill_calls": len(prefill),
            "sim_time": self.now,
            "wall_seconds": wall,
            "prefill_ms_p50": 1e3 * statistics.median(prefill) if prefill else 0.0,
            "decode_tick_ms_p50": 1e3 * statistics.median(decode) if decode else 0.0,
            "tokens_per_second": tokens / wall if wall else 0.0,
            "nonfinite_logits": self.engine.nonfinite,
        }
