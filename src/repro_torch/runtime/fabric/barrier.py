"""Two-phase, deadline-forced switch barrier: all hosts switch, or none.

Port of ``repro/runtime/fabric/barrier.py``.

The §5.4 dispatch problem across hosts: a plan switch is a *collective* —
every worker's compiled step must change at the same iteration boundary,
or the pipeline's cross-host sends/receives (and the data-parallel
gradient reduction) would be issued under mismatched schedules.  The
barrier realizes that as a two-phase commit with one twist that makes it
deadlock-free: **the deadline is itself a decision**.

State machine (one :class:`SwitchBarrier` instance per epoch)::

            begin(epoch, spec, boundary, deadline)
    IDLE ------------------------------------------> PREPARING
                                                      |  |  |
       every host voted ready before the deadline ----+  |  |
       -> COMMITTED                                      |  |
       any host voted ready=False --------------------- -+  |
       -> ABORTED("refused")                                |
       decide(now) with now >= deadline and votes missing --+
       -> ABORTED("deadline")

Rollback rules:

* ABORTED is fleet-wide: hosts that already precompiled the target simply
  keep the incumbent executable (precompilation is side-effect-free; the
  warm cache entry stays for a future epoch, so an aborted epoch's work is
  not wasted).
* A host blocked at the boundary polls the verdict; because ``decide`` is
  evaluated on every poll and the deadline forces ABORTED, the poll loop
  always terminates — a crashed/stalled host can abort an epoch (the
  fleet rolls back) but can never deadlock it.
* Epochs are monotone; a vote or poll for a stale epoch is answered from
  ``history`` (idempotent), never an error — late messages are expected
  under preemption, not faults.
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.kinds import ScheduleSpec
from repro_torch.runtime.fabric.messages import ReadyVote, SwitchOutcome

__all__ = ["BarrierPhase", "BarrierRecord", "SwitchBarrier"]


class BarrierPhase(enum.Enum):
    IDLE = "idle"
    PREPARING = "preparing"
    COMMITTED = "committed"
    ABORTED = "aborted"


@dataclasses.dataclass
class BarrierRecord:
    """Telemetry for one finished epoch (the fabric metrics read these)."""

    epoch: int
    spec: ScheduleSpec
    boundary: int
    committed: bool
    reason: str
    begin_time: float
    decide_time: float
    votes: dict[str, ReadyVote]

    @property
    def latency(self) -> float:
        """begin -> decision, the barrier's wall-clock footprint."""
        return self.decide_time - self.begin_time


class SwitchBarrier:
    """Coordinator-side barrier over a fixed host set.

    Not thread-safe by itself — the transport server serializes access
    (one lock around the whole coordinator, see
    :class:`~repro_torch.runtime.fabric.coordinator.CoordinatorServer`)."""

    def __init__(self, hosts: tuple[str, ...], flight=None) -> None:
        if not hosts:
            raise ValueError("barrier needs at least one host")
        self.hosts = tuple(hosts)
        # optional FlightRecorder: every PREPARE/vote/verdict transition is
        # appended so an abort dump shows the whole epoch unfold
        self.flight = flight
        self.phase = BarrierPhase.IDLE
        self.epoch = 0
        self.history: list[BarrierRecord] = []
        self._spec: ScheduleSpec | None = None
        self._boundary = -1
        self._deadline = 0.0
        self._begin_time = 0.0
        self._votes: dict[str, ReadyVote] = {}
        self._outcome: SwitchOutcome | None = None

    # -- phase 1 --------------------------------------------------------------

    def begin(
        self, spec: ScheduleSpec, boundary: int, deadline: float, now: float
    ) -> int:
        """Open a new epoch proposing ``spec`` at ``boundary``; returns the
        epoch number.  Only legal from IDLE (one collective at a time)."""
        if self.phase is BarrierPhase.PREPARING:
            raise RuntimeError(f"epoch {self.epoch} still preparing")
        self.epoch += 1
        self.phase = BarrierPhase.PREPARING
        self._spec = spec
        self._boundary = boundary
        self._deadline = deadline
        self._begin_time = now
        self._votes = {}
        self._outcome = None
        if self.flight is not None:
            self.flight.record(
                "barrier_begin",
                epoch=self.epoch,
                spec=str(spec),
                boundary=boundary,
                deadline=deadline,
                now=now,
            )
        return self.epoch

    def vote(self, v: ReadyVote, now: float) -> None:
        """Record a host's phase-1 vote.  Stale-epoch and late votes are
        dropped (the epoch they belong to already has its verdict)."""
        if v.epoch != self.epoch or self.phase is not BarrierPhase.PREPARING:
            return
        if v.host not in self.hosts:
            raise ValueError(f"vote from unknown host {v.host!r}")
        if now > self._deadline:
            # the vote is void; decide() will abort on the missing set
            return
        self._votes[v.host] = v
        if self.flight is not None:
            self.flight.record(
                "barrier_vote",
                epoch=self.epoch,
                host=v.host,
                ready=v.ready,
                reason=v.reason,
                now=now,
            )
        self.decide(now)

    # -- phase 2 --------------------------------------------------------------

    def decide(self, now: float) -> SwitchOutcome | None:
        """Evaluate the verdict at time ``now``; None while undecided.

        Called on every vote AND every outcome poll — the latter is what
        turns the deadline into a guaranteed decision."""
        if self.phase in (BarrierPhase.COMMITTED, BarrierPhase.ABORTED):
            return self._outcome
        if self.phase is not BarrierPhase.PREPARING:
            return None
        refusals = [v for v in self._votes.values() if not v.ready]
        missing = [h for h in self.hosts if h not in self._votes]
        if refusals:
            return self._finish(
                False,
                "refused: " + ", ".join(f"{v.host} ({v.reason})" for v in refusals),
                now,
            )
        if not missing:
            return self._finish(True, "", now)
        if now >= self._deadline:
            return self._finish(
                False, "deadline: no vote from " + ", ".join(missing), now
            )
        return None

    def _finish(self, committed: bool, reason: str, now: float) -> SwitchOutcome:
        self.phase = BarrierPhase.COMMITTED if committed else BarrierPhase.ABORTED
        self._outcome = SwitchOutcome(
            epoch=self.epoch,
            committed=committed,
            spec=self._spec,
            boundary=self._boundary,
            reason=reason,
        )
        self.history.append(
            BarrierRecord(
                epoch=self.epoch,
                spec=self._spec,
                boundary=self._boundary,
                committed=committed,
                reason=reason,
                begin_time=self._begin_time,
                decide_time=now,
                votes=dict(self._votes),
            )
        )
        if self.flight is not None:
            self.flight.record(
                "barrier_verdict",
                epoch=self.epoch,
                committed=committed,
                reason=reason,
                latency=now - self._begin_time,
                votes=sorted(self._votes),
            )
        return self._outcome

    def outcome_for(self, epoch: int, now: float) -> SwitchOutcome | None:
        """The verdict for ``epoch`` (answering an OutcomePoll): from
        history for finished epochs, via :meth:`decide` for the live one.
        History is consulted first so late polls stay idempotent even after
        the barrier was reset to IDLE for the next epoch."""
        for rec in reversed(self.history):
            if rec.epoch == epoch:
                return SwitchOutcome(
                    epoch=rec.epoch,
                    committed=rec.committed,
                    spec=rec.spec,
                    boundary=rec.boundary,
                    reason=rec.reason,
                )
        if epoch == self.epoch:
            return self.decide(now)
        return None

    # -- telemetry ------------------------------------------------------------

    @property
    def aborted_count(self) -> int:
        return sum(1 for r in self.history if not r.committed)

    @property
    def committed_count(self) -> int:
        return sum(1 for r in self.history if r.committed)

    def reset_for_next_epoch(self) -> None:
        """COMMITTED/ABORTED -> IDLE (the coordinator calls this once the
        verdict is recorded; history keeps the full trail)."""
        if self.phase in (BarrierPhase.COMMITTED, BarrierPhase.ABORTED):
            self.phase = BarrierPhase.IDLE
