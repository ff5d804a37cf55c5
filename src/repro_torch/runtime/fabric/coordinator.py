"""CoordinatorServer: the fleet's control plane in one process.

Port of ``repro/runtime/fabric/coordinator.py``.

The paper's §5.4 coordinator ("dispatches the decided plan to all workers
and swaps plans with minimal overhead"), lifted from the single-process
harness to N worker hosts:

* **aggregate** — every worker ships a :class:`TelemetryWindow` per
  iteration; the server stores them partitioned per host and, once every
  host has reported a round, merges the per-link samples pessimistically
  (:func:`repro_torch.core.profiler.merge_link_samples` — min effective
  bandwidth across hosts, because the barrier commits all-or-none and the
  fleet is as fast as its worst wire) into the central tuner's *offline*
  :class:`~repro_torch.core.profiler.NetworkProfiler`.
* **decide** — the unmodified single-process :class:`~repro_torch.core.tuner
  .AutoTuner` runs on the merged view at the configured interval.  With
  ``passive_staleness`` covering the telemetry cadence it never probes
  (it has no wire to probe — the offline profiler would refuse).
* **dispatch** — a decision that changes the incumbent spec opens a
  two-phase :class:`~repro_torch.runtime.fabric.barrier.SwitchBarrier` epoch:
  PREPARE goes out piggybacked on each host's next telemetry reply, votes
  come back, and the verdict (all ready before the deadline -> COMMIT,
  anything else -> ABORT + fleet-wide rollback to the incumbent) is served
  to hosts blocked at the boundary.  Aborted epochs are telemetry, not
  errors: the incumbent keeps running and the tuner may retry later.

The server is transport-agnostic: it exposes one serialized
``handle(msg) -> reply`` entry point that both the in-process
LocalTransport and the TCP listener drive.  ``decision_fn`` lets tests and
the multi-process integration drive a *scripted* decision trail through
the identical barrier path (determinism without faking telemetry).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable

from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.profiler import merge_link_samples
from repro_torch.core.tuner import AutoTuner
from repro_torch.obs import Observability
from repro_torch.runtime.fabric.barrier import BarrierPhase, SwitchBarrier
from repro_torch.runtime.fabric.messages import (
    OutcomePoll,
    PrepareSwitch,
    ReadyVote,
    SwitchOutcome,
    TelemetryWindow,
)

__all__ = ["FabricConfig", "CoordinatorServer"]


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Control-plane knobs shared by server and launch entry points."""

    tuning_interval: float = 50.0  # telemetry-clock seconds between decisions
    vote_timeout: float = 30.0  # PREPARE -> deadline span
    boundary_lead: int = 2  # switch lands this many iterations ahead
    merge_policy: str = "pessimistic"
    # bounded telemetry ring: at most this many MERGED rounds stay resident
    # per host (the profiler has already consumed dropped rounds; the
    # unmerged tail of a straggling round is always kept).  Long-running
    # fleets hold O(hosts * retention) windows instead of O(hosts * steps).
    telemetry_retention: int = 64


class CoordinatorServer:
    """One lock, one state machine, N hosts.

    ``tuner`` may be None when every decision comes from ``decision_fn``
    (the scripted mode integration tests use); otherwise it must be an
    AutoTuner over an offline profiler (the server feeds it merged
    telemetry and calls ``tune`` on the telemetry clock)."""

    def __init__(
        self,
        hosts: tuple[str, ...],
        initial_spec: ScheduleSpec,
        tuner: AutoTuner | None = None,
        config: FabricConfig | None = None,
        clock: Callable[[], float] | None = None,
        decision_fn: Callable[["CoordinatorServer"], ScheduleSpec | None] | None = None,
        obs: Observability | None = None,
    ) -> None:
        self.hosts = tuple(hosts)
        self.incumbent = initial_spec
        self.tuner = tuner
        self.config = config or FabricConfig()
        self.clock = clock or time.monotonic
        self.decision_fn = decision_fn
        if self.config.telemetry_retention < 1:
            raise ValueError(
                f"telemetry_retention must be >= 1, got {self.config.telemetry_retention}"
            )
        # observability: fabric_metrics()/telemetry_trace() read these
        # registry series (the single metrics currency); barrier transitions
        # and telemetry merges land in the flight ring, which auto-dumps on
        # abort when a dump_path is configured.  A private bundle on the
        # server's own clock is created when the caller doesn't supply one.
        self.obs = obs or Observability.create(clock=self.clock)
        m = self.obs.metrics
        self._m_hosts = m.gauge("fabric_hosts")
        self._m_hosts.set(len(self.hosts))
        self._m_retention = m.gauge("fabric_telemetry_retention")
        self._m_retention.set(self.config.telemetry_retention)
        self._m_windows = m.gauge("fabric_telemetry_windows")
        self._m_dropped = m.gauge("fabric_telemetry_rounds_dropped")
        self._m_rounds = m.counter("fabric_telemetry_rounds_merged_total")
        self._m_committed = m.counter("fabric_committed_switches_total")
        self._m_aborted = m.counter("fabric_aborted_switches_total")
        self._m_latency = m.histogram("fabric_barrier_latency_seconds")
        self._epoch_spans: dict[int, object] = {}
        self.barrier = SwitchBarrier(self.hosts, flight=self.obs.flight)
        self._lock = threading.Lock()
        # host -> resident windows (the RETAINED tail of the partitioned
        # telemetry trace — `_window_base` oldest merged rounds were dropped)
        self.windows: dict[str, list[TelemetryWindow]] = {h: [] for h in self.hosts}
        # rounds compacted away so far: windows[h][i] is global round
        # `_window_base + i`
        self._window_base = 0
        # host -> PrepareSwitch not yet delivered (piggybacks on next reply)
        self._pending_prepare: dict[str, PrepareSwitch] = {}
        self._prepared_epoch_spec: ScheduleSpec | None = None
        self._rounds_merged = 0
        self._last_tune_time: float | None = None
        self.decision_log: list[dict] = []

    # -- transport entry point ------------------------------------------------

    def handle(self, msg: object) -> object | None:
        """THE server: every transport delivers here, serialized."""
        with self._lock:
            if isinstance(msg, TelemetryWindow):
                return self._on_telemetry(msg)
            if isinstance(msg, ReadyVote):
                self.barrier.vote(msg, now=self.clock())
                self._collect_verdict()
                return None
            if isinstance(msg, OutcomePoll):
                return self._on_poll(msg)
            raise TypeError(f"unknown fabric message {type(msg).__name__}")

    # -- telemetry aggregation + decision -------------------------------------

    def _on_telemetry(self, win: TelemetryWindow) -> PrepareSwitch | None:
        if win.host not in self.windows:
            raise ValueError(f"telemetry from unknown host {win.host!r}")
        self.windows[win.host].append(win)
        self._merge_complete_rounds()
        self._m_windows.set(sum(len(w) for w in self.windows.values()))
        self._maybe_decide(win.end_time)
        # deliver a pending PREPARE exactly once per host
        return self._pending_prepare.pop(win.host, None)

    def _merge_complete_rounds(self) -> None:
        """Feed the central profiler every telemetry round all hosts have
        completed (partition merge happens per-round so the pessimum is
        taken across hosts at the SAME iteration, not across time), then
        compact the resident ring down to ``telemetry_retention`` merged
        rounds.  Scripted (tuner-less) fleets count and compact rounds the
        same way — only the profiler feed is tuner-gated — so their
        resident footprint is bounded too."""
        while all(
            len(w) + self._window_base > self._rounds_merged
            for w in self.windows.values()
        ):
            r = self._rounds_merged - self._window_base
            if self.tuner is not None:
                per_host = {h: self.windows[h][r].samples for h in self.hosts}
                merged = merge_link_samples(per_host, self.config.merge_policy)
                self.tuner.net_profiler.record_samples(merged)
            self.obs.flight.record(
                "telemetry_merge",
                round=self._rounds_merged,
                iteration=self.windows[self.hosts[0]][r].iteration,
                policy=self.config.merge_policy,
                fed_tuner=self.tuner is not None,
            )
            self._rounds_merged += 1
            self._m_rounds.inc()
        self._compact_windows()

    def _compact_windows(self) -> None:
        """Uniformly drop the oldest MERGED rounds beyond the retention
        horizon.  Only the fully-merged prefix is eligible, so per-host
        indices stay aligned and a straggler's unmerged tail is never
        touched; ``max/min_reported_iteration`` read ``w[-1]`` and are
        unaffected."""
        merged_resident = self._rounds_merged - self._window_base
        drop = merged_resident - self.config.telemetry_retention
        if drop <= 0:
            return
        for h in self.hosts:
            del self.windows[h][:drop]
        self._window_base += drop
        self._m_dropped.set(self._window_base)

    def _maybe_decide(self, now: float) -> None:
        if self.barrier.phase is BarrierPhase.PREPARING:
            return  # one collective at a time
        if self.barrier.history:
            # the previous epoch's boundary must drain fleet-wide before a
            # new collective opens: every host past it has either applied
            # the committed spec or discarded the aborted epoch, so epochs
            # can never overlap on a worker
            last = self.barrier.history[-1]
            if self.min_reported_iteration() < last.boundary:
                return
        target: ScheduleSpec | None = None
        if self.tuner is not None and self._rounds_merged > 0:
            due = (
                self._last_tune_time is None
                or now - self._last_tune_time >= self.config.tuning_interval
            )
            if due:
                rec = self.tuner.tune(now)
                self._last_tune_time = now
                self.decision_log.append(
                    {"t": now, "chosen": rec.chosen, "spec": rec.chosen_spec}
                )
                # the decision trail in the trace: winner + the full
                # per-candidate score table (what Perfetto shows on click)
                self.obs.trace.instant(
                    "coordinator/tuner", f"decision {rec.chosen}",
                    chosen=rec.chosen,
                    estimates={k: rec.estimates[k] for k in sorted(rec.estimates)},
                    rejected=[
                        {"name": n, "estimate": e, "reason": r}
                        for n, e, r in rec.rejected_candidates
                    ],
                    switched=rec.switched,
                )
                target = rec.chosen_spec
        if self.decision_fn is not None:
            # scripted override: the tuner (if any) still runs on its own
            # cadence above — telemetry -> tune stays exercised — but the
            # dispatched target comes from the script (deterministic
            # integration tests drive known switch trails this way)
            target = self.decision_fn(self)
        if target is not None and target != self.incumbent:
            self._begin_switch(target, now)

    def _begin_switch(self, spec: ScheduleSpec, now: float) -> None:
        boundary = self.max_reported_iteration() + 1 + self.config.boundary_lead
        wall = self.clock()
        epoch = self.barrier.begin(
            spec, boundary, deadline=wall + self.config.vote_timeout, now=wall
        )
        self._prepared_epoch_spec = spec
        self._epoch_spans[epoch] = self.obs.trace.span(
            "coordinator/barrier", f"barrier epoch {epoch}",
            spec=str(spec), boundary=boundary,
        )
        self.obs.trace.instant(
            "coordinator/barrier", f"PREPARE epoch {epoch}", spec=str(spec)
        )
        cmd = PrepareSwitch(
            epoch=epoch, spec=spec, boundary=boundary,
            deadline=wall + self.config.vote_timeout,
        )
        for h in self.hosts:
            self._pending_prepare[h] = cmd

    # -- the boundary ----------------------------------------------------------

    def _on_poll(self, poll: OutcomePoll) -> SwitchOutcome | None:
        out = self.barrier.outcome_for(poll.epoch, now=self.clock())
        if out is not None:
            self._collect_verdict()
        return out

    def _collect_verdict(self) -> None:
        """Apply a finished epoch to the server's own view of the fleet."""
        if self.barrier.phase is BarrierPhase.COMMITTED:
            self.incumbent = self._prepared_epoch_spec
            self._record_verdict(committed=True)
            # the tuner's own current candidate already matches (it decided);
            # scripted mode has no tuner state to sync
            self.barrier.reset_for_next_epoch()
            # drop PREPAREs not yet delivered for this epoch (verdict known)
            self._pending_prepare.clear()
        elif self.barrier.phase is BarrierPhase.ABORTED:
            # fleet-wide rollback: the incumbent simply stays; clear the
            # undelivered PREPAREs so stragglers never see a dead epoch
            self._record_verdict(committed=False)
            self.barrier.reset_for_next_epoch()
            self._pending_prepare.clear()

    def _record_verdict(self, committed: bool) -> None:
        """Registry + trace bookkeeping for the epoch that just finished
        (runs exactly once per epoch: the barrier is reset to IDLE right
        after, so a second pass cannot reach here)."""
        rec = self.barrier.history[-1]
        verdict = "COMMIT" if committed else "ABORT"
        (self._m_committed if committed else self._m_aborted).inc()
        self._m_latency.observe(rec.latency)
        sp = self._epoch_spans.pop(rec.epoch, None)
        if sp is not None:
            self.obs.trace.end_span(
                sp, verdict=verdict, boundary=rec.boundary, reason=rec.reason
            )
        self.obs.trace.instant(
            "coordinator/barrier", f"{verdict} epoch {rec.epoch}", reason=rec.reason
        )
        if not committed:
            # post-mortem before any state unwinds: the ring holds the whole
            # PREPARE -> vote -> ABORT trail that led here
            self.obs.flight.auto_dump(f"barrier_abort epoch {rec.epoch}: {rec.reason}")

    # -- introspection ---------------------------------------------------------

    def max_reported_iteration(self) -> int:
        its = [w[-1].iteration for w in self.windows.values() if w]
        return max(its) if its else -1

    def min_reported_iteration(self) -> int:
        its = [w[-1].iteration if w else -1 for w in self.windows.values()]
        return min(its) if its else -1

    def fabric_metrics(self) -> dict:
        """The fabric's own health metrics (benchmarked + traced).

        The dict SHAPE is frozen for existing consumers
        (``benchmarks/trajectory.py``, the distributed CI artifact); the
        values are read back from the shared metrics registry, which is the
        single currency these numbers live on now."""
        committed = int(self._m_committed.value())
        aborted = int(self._m_aborted.value())
        latency = self._m_latency.value()
        return {
            "hosts": int(self._m_hosts.value()),
            "telemetry_windows": int(self._m_windows.value()),
            "telemetry_rounds_dropped": int(self._m_dropped.value()),
            "telemetry_retention": int(self._m_retention.value()),
            "barrier_epochs": committed + aborted,
            "committed_switches": committed,
            "aborted_switches": aborted,
            "barrier_latency_max": latency.max if latency.count else 0.0,
            "incumbent": dataclasses.asdict(self.incumbent),
        }

    def telemetry_trace(self) -> dict:
        """The partitioned telemetry trace (the CI artifact): every RETAINED
        window per host plus the barrier trail, JSON-serializable.  Rounds
        older than the retention horizon were compacted away after the
        profiler consumed them; ``window_base`` records how many, so global
        round ``window_base + i`` is ``windows[h][i]``."""
        return {
            "hosts": list(self.hosts),
            "window_base": self._window_base,
            "windows": {
                h: [
                    {
                        "iteration": w.iteration,
                        "seconds": w.seconds,
                        "end_time": w.end_time,
                        "spec": dataclasses.asdict(w.spec),
                        "loss": w.loss,
                        "samples": [dataclasses.asdict(s) for s in w.samples],
                    }
                    for w in ws
                ]
                for h, ws in self.windows.items()
            },
            "barrier": [
                {
                    "epoch": r.epoch,
                    "committed": r.committed,
                    "reason": r.reason,
                    "boundary": r.boundary,
                    "latency": r.latency,
                    "spec": dataclasses.asdict(r.spec),
                    "votes": {
                        h: {"ready": v.ready, "precompile_seconds": v.precompile_seconds}
                        for h, v in r.votes.items()
                    },
                }
                for r in self.barrier.history
            ],
            "metrics": self.fabric_metrics(),
            # additive: the full registry snapshot (every labeled series the
            # control plane maintains beyond the frozen metrics dict above)
            "registry": self.obs.metrics.snapshot(),
        }
