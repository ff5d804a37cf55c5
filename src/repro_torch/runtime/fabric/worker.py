"""WorkerAgent: one host's side of the fabric, wrapping a live PlanRuntime.

Port of ``repro/runtime/fabric/worker.py``.

Each worker host owns a full :class:`~repro_torch.runtime.executor.PlanRuntime`
(params + optimizer state + step-program cache) training on its own
data shard; the fabric's job is to keep every host running the SAME
schedule spec and to move the fleet between specs at one shared iteration
boundary.  The agent implements the
:class:`~repro_torch.runtime.fabric.protocols.SwitchParticipant` protocol:

* ``prepare`` — resolve the proposed :class:`ScheduleSpec` to this host's
  own lowered table (``spec`` -> ``make_plan(S, M, spec=...)`` — the wire
  never carries plans), warm the executable through the local
  :class:`~repro_torch.runtime.compile_cache.CompiledStepCache`, and vote.  A
  spec this host cannot run (OOM-lowering, divisibility) votes
  ``ready=False`` — which aborts the epoch fleet-wide, the typed version
  of "the fleet is only as capable as its least host".
* ``apply_outcome`` — at the boundary: COMMIT switches via the runtime's
  warm path (:meth:`PlanRuntime.switch_to` — bitwise re-stack across
  layout changes); ABORT keeps the incumbent executable (the prepared
  entry stays cached for a future epoch).

One :meth:`step` = run one iteration, ship the telemetry window, react to
whatever command piggybacked on the reply, and — when the *next* iteration
is a prepared epoch's boundary — block-poll the verdict first.  The poll
loop is safe: the coordinator's deadline forces a decision, so polling
terminates with COMMIT or ABORT, never spins forever (tested with a
straggler that never votes).

Telemetry: each iteration's wall time is inverted to per-link effective
transfer times (:func:`~repro_torch.runtime.telemetry.invert_effective_bandwidth`
— this host's *partition* of the network view) and shipped as
:class:`LinkSample` tuples for the coordinator's pessimistic merge.
"""

from __future__ import annotations

import time
from typing import Callable

from repro_torch.core.costmodel import CostModel, link_probe_specs
from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.profiler import LinkSample
from repro_torch.core.schedule import TabularPlan, make_plan
from repro_torch.core.taskgraph import StageCosts
from repro_torch.obs import Observability
from repro_torch.runtime.executor import IterationResult, PlanRuntime
from repro_torch.runtime.fabric.messages import (
    OutcomePoll,
    PrepareSwitch,
    ReadyVote,
    SwitchOutcome,
    TelemetryWindow,
)
from repro_torch.runtime.fabric.protocols import ControlTransport
from repro_torch.runtime.telemetry import invert_effective_bandwidth

__all__ = ["WorkerAgent", "fabric_probe_links"]


def fabric_probe_links(candidates, stage_costs_for) -> tuple:
    """Union of every candidate's probe links, one byte class per link.

    Workers report THIS set each window (not just the running plan's own
    links) so the coordinator's passive tuner finds every candidate's link
    fresh — e.g. the interleaved ring's wrap link ``S-1 -> 0`` stays warm
    even while a flat plan runs — and never falls back to suspend-probing,
    which its offline profiler would refuse anyway."""
    seen: dict[tuple[int, int], tuple[int, int, float]] = {}
    for cand in candidates:
        costs = stage_costs_for(cand)
        for src, dst, nbytes in link_probe_specs(cand.plan, costs):
            seen.setdefault((src, dst), (src, dst, nbytes))
    return tuple(seen.values())


class WorkerAgent:
    """One host: PlanRuntime + transport client + the participant logic."""

    def __init__(
        self,
        host: str,
        runtime: PlanRuntime,
        transport: ControlTransport,
        batch_fn: Callable[[int], tuple],
        costs: StageCosts,
        initial_spec: ScheduleSpec,
        cost_model: CostModel | None = None,
        probe_links: tuple | None = None,
        poll_sleep: float = 0.01,
        max_poll_seconds: float = 300.0,
        obs: Observability | None = None,
    ) -> None:
        self.host = host
        # observability (optional): barrier participation instants on the
        # "{host}/fabric" track, worker_* flight events, and an automatic
        # flight dump if step() dies (the post-mortem the distributed CI
        # job uploads)
        self.obs = obs
        self.runtime = runtime
        self.transport = transport
        self.batch_fn = batch_fn
        self.costs = costs
        self.cost_model = cost_model or CostModel()
        # links to report each window: the UNION of every fleet candidate's
        # probe links (see fabric_probe_links), so the coordinator's passive
        # tuner finds every window fresh and never needs a wire of its own;
        # None falls back to the running plan's own links
        self.probe_links = probe_links
        self.poll_sleep = poll_sleep
        self.max_poll_seconds = max_poll_seconds
        self._pending: PrepareSwitch | None = None
        self._prepared_table: TabularPlan | None = None
        self.applied_outcomes: list[SwitchOutcome] = []
        self._spec = initial_spec
        self.runtime.switch_to(self.resolve(initial_spec))

    # -- spec resolution (the wire carries coordinates, workers own plans) -----

    def resolve(self, spec: ScheduleSpec) -> TabularPlan:
        """This host's lowered table for ``spec`` — derived purely from the
        local model/runtime shape, so every host resolves the same spec to
        the same logical schedule."""
        M = self.runtime.global_batch // spec.micro_batch_size
        plan = make_plan(self.runtime.num_stages, M, spec=spec)
        return plan.lower()

    @property
    def current_spec(self) -> ScheduleSpec:
        return self._spec

    @property
    def iteration(self) -> int:
        return len(self.runtime.iterations)

    # -- SwitchParticipant ------------------------------------------------------

    def prepare(self, cmd: PrepareSwitch) -> ReadyVote:
        if self.obs is not None:
            self.obs.trace.instant(
                f"{self.host}/fabric", f"PREPARE epoch {cmd.epoch}",
                spec=str(cmd.spec), boundary=cmd.boundary,
            )
        t0 = time.perf_counter()
        try:
            table = self.resolve(cmd.spec)
            # warm the executable NOW (phase 1), so the boundary switch is
            # the warm path: fetch + re-stack + pointer swap
            self.runtime.cache.get(table)
        except Exception as e:  # vote no — aborting beats a broken fleet
            self._pending = cmd
            self._prepared_table = None
            vote = ReadyVote(
                epoch=cmd.epoch, host=self.host, ready=False, reason=repr(e)
            )
            self._record_vote(vote)
            return vote
        self._pending = cmd
        self._prepared_table = table
        vote = ReadyVote(
            epoch=cmd.epoch,
            host=self.host,
            ready=True,
            precompile_seconds=time.perf_counter() - t0,
        )
        self._record_vote(vote)
        return vote

    def _record_vote(self, vote: ReadyVote) -> None:
        if self.obs is None:
            return
        self.obs.trace.instant(
            f"{self.host}/fabric",
            f"vote {'ready' if vote.ready else 'refuse'} epoch {vote.epoch}",
            ready=vote.ready, reason=vote.reason,
        )
        self.obs.flight.record(
            "worker_prepare", host=self.host, epoch=vote.epoch,
            ready=vote.ready, reason=vote.reason,
        )

    def apply_outcome(self, outcome: SwitchOutcome) -> None:
        self.applied_outcomes.append(outcome)
        if self.obs is not None:
            verdict = "COMMIT" if outcome.committed else "ABORT"
            self.obs.trace.instant(
                f"{self.host}/fabric", f"{verdict} epoch {outcome.epoch}",
                reason=outcome.reason,
            )
            self.obs.flight.record(
                "worker_outcome", host=self.host, epoch=outcome.epoch,
                committed=outcome.committed, reason=outcome.reason,
            )
        if outcome.committed:
            if self._prepared_table is None:  # committed epoch we refused?
                raise RuntimeError(
                    f"host {self.host}: commit for epoch {outcome.epoch} "
                    "without a prepared table"
                )
            self.runtime.switch_to(self._prepared_table)
            self._spec = outcome.spec
        # abort: incumbent stays — nothing to roll back, the prepared entry
        # remains cached for a future epoch
        self._pending = None
        self._prepared_table = None

    # -- the per-iteration loop -------------------------------------------------

    def _poll_boundary(self) -> None:
        """Block until the pending epoch has a verdict.  Terminates because
        the coordinator's deadline forces a decision on every poll."""
        cmd = self._pending
        give_up = time.monotonic() + self.max_poll_seconds
        while True:
            out = self.transport.request(
                OutcomePoll(epoch=cmd.epoch, host=self.host, iteration=self.iteration)
            )
            if isinstance(out, SwitchOutcome):
                self.apply_outcome(out)
                return
            if time.monotonic() >= give_up:
                raise TimeoutError(
                    f"host {self.host}: no verdict for epoch {cmd.epoch} after "
                    f"{self.max_poll_seconds}s (coordinator unreachable?)"
                )
            if self.poll_sleep:
                time.sleep(self.poll_sleep)

    def _handle_command(self, reply: object) -> None:
        if reply is None:
            return
        if isinstance(reply, PrepareSwitch):
            vote = self.prepare(reply)
            self.transport.request(vote)
            return
        raise TypeError(f"unknown coordinator command {type(reply).__name__}")

    def _link_samples(self, result: IterationResult, end_time: float) -> tuple:
        plan = self.runtime.current_table.plan
        bw = invert_effective_bandwidth(
            plan, self.costs, result.seconds, self.cost_model
        )
        links = self.probe_links or link_probe_specs(plan, self.costs)
        return tuple(
            LinkSample(src, dst, nbytes, nbytes / bw if bw > 0 else float("inf"),
                       end_time)
            for src, dst, nbytes in links
        )

    def step(self) -> IterationResult:
        """One fabric round: boundary check -> train one iteration -> ship
        telemetry -> react to any piggybacked command.  A failure anywhere
        in the round dumps the flight ring first (post-mortem), then
        re-raises."""
        try:
            return self._step()
        except Exception as e:
            if self.obs is not None:
                self.obs.flight.record(
                    "worker_failure", host=self.host,
                    iteration=self.iteration, error=repr(e),
                )
                self.obs.flight.auto_dump(f"worker_failure {self.host}: {e!r}")
            raise

    def _step(self) -> IterationResult:
        if self._pending is not None and self.iteration >= self._pending.boundary:
            self._poll_boundary()
        tokens, labels = self.batch_fn(self.iteration)
        result = self.runtime.run_iteration(tokens, labels)
        # epoch time, not monotonic: telemetry stamps must be comparable
        # across worker processes when the coordinator merges partitions
        end_time = time.time()
        win = TelemetryWindow(
            host=self.host,
            iteration=result.index,
            seconds=result.seconds,
            end_time=end_time,
            spec=self._spec,
            samples=self._link_samples(result, end_time),
            loss=result.loss,
        )
        self._handle_command(self.transport.request(win))
        return result

    def run(self, num_iterations: int) -> list[IterationResult]:
        return [self.step() for _ in range(num_iterations)]
