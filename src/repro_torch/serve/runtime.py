"""ServeRuntime: the continuous-batching decode loop on the pipeline engine.

Port of ``repro/serve/runtime.py``.  One simulated-time tick loop closes the
whole adaptive loop for serving:

1. **boundary** -- drain arrivals into the FIFO queue, retire finished
   requests, admit queued ones into freed slots (retire before admit);
2. **retune** -- at the configured interval the
   :class:`~repro_torch.core.tuner.AutoTuner` re-decides ``ScheduleSpec``
   (kind and k) against the profiler windows that this loop's own ticks keep
   fresh through the telemetry bus and, with :func:`make_slo_objective`,
   against arrival pressure too; the engine follows the decision through
   ``switch_to(tuner.current_table)``;
3. **prefill** -- a boundary that admitted requests prices one
   full-sequence prefill pass of the current plan (prefill stage costs) and
   emits each admission's first token (TTFT ends here);
4. **decode tick** -- otherwise the in-flight batch advances one token
   through the pipeline: the tick costs ``simulate_plan(plan, decode_costs,
   shifted_network(net, now))``, evaluated mid-regime so preemption phase
   matters.

The network stays the seeded trace world (one card has no cross-stage
network to preempt), so the clock, the tuner's decisions and the SLO
quantiles are simulated and do not depend on the engine.  The tokens are
real: pass an ``engine`` (:class:`~repro_torch.serve.engine.ServeEngine`)
and every prefill and decode tick runs on it.  The port adds one
measurement: each tick's ``wall_seconds``, the engine's work synchronised,
from which the summary adds the wall-clock keys (:meth:`ServeRuntime.summary`).

Tick timings publish to the telemetry bus with ``source="serve"``; wire the
profiler with ``PassiveLinkFeed(profiler, sources=("serve",))`` so the tuner
reads link health from observed serving iterations instead of suspending the
batch to probe.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

from repro_torch.core.candidates import Candidate
from repro_torch.core.coordinator import shifted_network
from repro_torch.core.network import Network
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.taskgraph import StageCosts
from repro_torch.core.tuner import AutoTuner
from repro_torch.serve.arrival import ArrivalProcess
from repro_torch.serve.batching import ContinuousBatcher, RequestQueue
from repro_torch.serve.slo import SLOTracker

__all__ = ["ServeTick", "ServeRuntime", "make_slo_objective"]


@dataclasses.dataclass
class ServeTick:
    index: int
    start: float
    seconds: float
    phase: str  # "prefill" | "decode"
    plan_name: str
    kind: str
    k: int
    occupancy: int
    queue_depth: int
    wall_seconds: float = 0.0  # measured: the engine's work, synchronised


def make_slo_objective(
    pressure_fn: Callable[[], float], latency_weight: float = 1.0
) -> Callable[[Candidate, float, float], float]:
    """The serving decision objective: SLO-weighted makespan under arrival
    pressure.

    Under pressure (deep queue) throughput is everything and the score is
    the raw makespan.  On a slack queue the per-token latency matters more
    than marginal throughput, so grouped plans pay for the *emission delay*
    grouping buys them: a k-deep group holds its first k-1 micro-batches'
    tokens back until the group completes, a delay worth roughly
    ``(k - 1) / M`` of the tick.  Score::

        makespan * (1 + latency_weight * relief * (k - 1) / M)

    with ``relief = clamp(1 - pressure, 0, 1)`` and ``pressure`` from
    :meth:`ServeRuntime.queue_pressure`.  Raw makespans still land in
    ``TuningRecord.estimates``; the scores land in ``objective_scores``.
    """

    def objective(cand: Candidate, makespan: float, now: float) -> float:
        relief = max(0.0, 1.0 - min(1.0, pressure_fn()))
        group_delay = (cand.k - 1) / max(1, cand.num_microbatches)
        return makespan * (1.0 + latency_weight * relief * group_delay)

    return objective


def _p50_ms(seconds: list[float]) -> float:
    return 1e3 * statistics.median(seconds) if seconds else 0.0


class ServeRuntime:
    """Drives continuous-batching decode over simulated time.

    ``decode_costs_for`` / ``prefill_costs_for`` map a candidate to the
    :class:`StageCosts` of one decode tick / one full prefill pass (the
    prefill-vs-decode asymmetry of the committed decode workload profile).
    ``engine`` (optional) runs the real prefill and decode programs beside
    the simulated pricing; see the module docstring.
    """

    def __init__(
        self,
        tuner: AutoTuner,
        network: Network,
        arrivals: ArrivalProcess,
        slo: SLOTracker,
        max_slots: int,
        decode_costs_for: Callable[[Candidate], StageCosts],
        prefill_costs_for: Callable[[Candidate], StageCosts] | None = None,
        telemetry_sink=None,
        retune_interval: float | None = None,
        tuning_overhead: float = 0.0,
        engine=None,
        obs=None,
        track: str = "host0",
    ) -> None:
        self.tuner = tuner
        self.network = network
        self.arrivals = arrivals
        self.slo = slo
        self.queue = RequestQueue()
        self.batcher = ContinuousBatcher(max_slots)
        self.decode_costs_for = decode_costs_for
        self.prefill_costs_for = prefill_costs_for or decode_costs_for
        self.telemetry_sink = telemetry_sink
        self.retune_interval = retune_interval
        self.tuning_overhead = tuning_overhead
        self.engine = engine
        self.obs = obs
        self.track = track
        self.ticks: list[ServeTick] = []
        self.completed: list = []  # retired InFlight records, completion order
        self.now = 0.0
        self.total_tuning_overhead = 0.0
        self._next_tune = 0.0

    def queue_pressure(self) -> float:
        """Queued-demand-to-capacity ratio the SLO objective consumes."""
        return len(self.queue) / self.batcher.max_slots

    # -- tick pricing ----------------------------------------------------------

    def _price(self, cand: Candidate, phase: str) -> tuple[float, StageCosts]:
        costs = (
            self.prefill_costs_for(cand)
            if phase == "prefill"
            else self.decode_costs_for(cand)
        )
        net = shifted_network(self.network, self.now)
        return simulate_plan(cand.plan, costs, net).pipeline_length, costs

    def _run_engine(self, work: Callable[[], None]) -> float:
        """Run ``work`` on the engine; its wall seconds, synchronised."""
        if self.engine is None:
            return 0.0
        t0 = time.perf_counter()
        work()
        self.engine.synchronize()
        return time.perf_counter() - t0

    def _record_tick(self, phase: str, cand: Candidate, start: float, seconds: float, wall: float):
        tick = ServeTick(
            index=len(self.ticks),
            start=start,
            seconds=seconds,
            phase=phase,
            plan_name=cand.name,
            kind=cand.plan.kind,
            k=cand.k,
            occupancy=self.batcher.occupancy,
            queue_depth=len(self.queue),
            wall_seconds=wall,
        )
        self.ticks.append(tick)
        if self.obs is not None:
            from repro_torch.obs.trace import quantize_sim_span

            q_start, q_dur = quantize_sim_span(start, seconds)
            self.obs.trace.add_span(
                f"{self.track}/ticks",
                f"{phase} {cand.name}",
                start_s=q_start,
                dur_s=q_dur,
                occupancy=tick.occupancy,
                queue=tick.queue_depth,
            )
        return tick

    # -- the loop --------------------------------------------------------------

    def run(self, max_requests: int, max_ticks: int = 100_000) -> dict:
        """Serve until ``max_requests`` requests completed (or ``max_ticks``
        safety valve).  Returns the summary dict shared by the entry points
        and the tests."""
        if self.engine is not None:
            self.engine.switch_to(self.tuner.current_table)
        while len(self.completed) < max_requests and len(self.ticks) < max_ticks:
            # -- boundary: drain -> retire -> admit ---------------------------
            for req in self.arrivals.drain(self.now):
                self.queue.push(req)
            done = self.batcher.retire_finished(self.now)
            for inf in done:
                self.slo.on_complete(inf, self.now)
                self.completed.append(inf)
            if done and self.engine is not None:
                self.engine.release([inf.slot for inf in done])
            if len(self.completed) >= max_requests:
                break
            admitted = self.batcher.admit(self.queue, self.now)
            self.slo.on_boundary(len(self.queue), self.batcher.occupancy)
            for inf in admitted:
                self.slo.on_admit(inf, self.now)
            if self.batcher.occupancy == 0:
                nxt = self.arrivals.next_arrival_after(self.now)
                if nxt is None:
                    break
                self.now = nxt
                continue
            # -- retune -------------------------------------------------------
            if self.retune_interval is not None and self.now >= self._next_tune:
                rec = self.tuner.tune(self.now)
                charged = self.tuning_overhead * rec.probe_fraction
                self.now += charged
                self.total_tuning_overhead += charged
                self._next_tune = self.now + self.retune_interval
                if self.engine is not None:
                    self.engine.switch_to(self.tuner.current_table)
                if self.obs is not None:
                    self.obs.trace.add_instant(
                        f"{self.track}/tuner",
                        f"decision {rec.chosen}",
                        self.now,
                        kind=rec.chosen_kind,
                        k=rec.chosen_k,
                        queue=len(self.queue),
                    )
            cand = self.tuner.current
            start = self.now
            # -- prefill pass (admission boundary) ----------------------------
            if admitted:
                seconds, costs = self._price(cand, "prefill")
                wall = self._run_engine(lambda: self.engine.prefill(admitted))
                self.now += seconds
                for inf in admitted:
                    self.slo.on_first_token(inf, self.now)
                self._publish(cand, costs, seconds)
                self._record_tick("prefill", cand, start, seconds, wall)
                continue  # back to the boundary: budget-1 requests retire now
            # -- decode tick --------------------------------------------------
            seconds, costs = self._price(cand, "decode")
            in_flight = self.batcher.in_flight
            wall = self._run_engine(lambda: self.engine.decode_tick(in_flight))
            self.now += seconds
            for inf in in_flight:
                self.slo.on_token(inf, self.now)
            self._publish(cand, costs, seconds)
            self._record_tick("decode", cand, start, seconds, wall)
        return self.summary()

    def _publish(self, cand: Candidate, costs: StageCosts, seconds: float) -> None:
        if self.telemetry_sink is not None:
            self.telemetry_sink.publish_iteration(
                index=len(self.ticks),
                plan=cand.plan,
                costs=costs,
                seconds=seconds,
                end_time=self.now,
                source="serve",
            )

    # -- summaries -------------------------------------------------------------

    def summary(self) -> dict:
        """``repro``'s summary (every value on the simulated clock); with an
        engine also the measured keys: ``wall_seconds``, ``prefill_calls``,
        ``prefill_ms_p50`` (each prefill call, one request), ``decode_tick_ms_p50``
        and ``decode_tick_ms_p50_by_plan``, ``tokens_per_second_wall``,
        ``nonfinite_logits``, ``requests_completed_exactly`` (the completed
        requests whose engine output holds exactly their ``max_new_tokens``),
        each switch's seconds and the compile cache's counters."""
        decode_ticks = [t for t in self.ticks if t.phase == "decode"]
        out = dict(self.slo.summary())
        out.update(
            {
                "sim_time": self.now,
                "ticks": len(self.ticks),
                "decode_ticks": len(decode_ticks),
                "prefill_ticks": len(self.ticks) - len(decode_ticks),
                "requests_admitted": self.batcher.total_admitted,
                "requests_completed": len(self.completed),
                "queue_depth_final": len(self.queue),
                "tuning_overhead_charged": self.total_tuning_overhead,
                "decision_trail": [
                    {
                        "t": round(r.time, 3),
                        "chosen": r.chosen,
                        "kind": r.chosen_kind,
                        "k": r.chosen_k,
                    }
                    for r in self.tuner.history
                ],
                "kinds_chosen": sorted(
                    {r.chosen_kind for r in self.tuner.history}
                ),
                "tokens_per_second": (
                    out["tokens"] / self.now if self.now else 0.0
                ),
            }
        )
        if self.engine is None:
            return out
        wall = sum(t.wall_seconds for t in self.ticks)
        by_plan: dict[str, list[float]] = {}
        for t in decode_ticks:
            by_plan.setdefault(t.plan_name, []).append(t.wall_seconds)
        rt = self.engine.runtime
        out.update(
            {
                "wall_seconds": wall,
                "prefill_calls": len(self.engine.prefill_seconds),
                "prefill_ms_p50": _p50_ms(self.engine.prefill_seconds),
                "decode_tick_ms_p50": _p50_ms([t.wall_seconds for t in decode_ticks]),
                "decode_tick_ms_p50_by_plan": {name: _p50_ms(s) for name, s in by_plan.items()},
                "tokens_per_second_wall": out["tokens"] / wall if wall else 0.0,
                "nonfinite_logits": self.engine.nonfinite,
                "requests_completed_exactly": sum(
                    len(self.engine.outputs[inf.request.rid]) == inf.tokens_emitted == inf.request.max_new_tokens
                    for inf in self.completed
                ),
                "switch_seconds": [e.seconds for e in rt.switch_events],
                "compile_cache": dataclasses.asdict(rt.cache.stats),
            }
        )
        return out
