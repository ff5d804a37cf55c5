"""§3.2/§5.4 online auto-tuner: re-profile, re-evaluate, switch plans.

A copy of ``repro/core/tuner.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

At every tuning interval the tuner (a) suspends the pipeline and probes each
cross-stage link with each candidate's actual transfer sizes (§5.2: "we
suspend the current schedule task and collect all the performance data in
each schedule plan"), (b) estimates every candidate's pipeline length with
the cost model, and (c) picks the argmin.  Compute profiles are *not*
re-measured (devices are exclusive).  All candidates stay alive — the next
interval may pick a different k, and switching carries no parameter-state
cost because (k, b) do not affect the model parameters (§5.4).

When the candidate set spans several schedule *kinds* (zero-bubble H1/H2,
interleaved, interleaved-ZB — see
:func:`repro_torch.core.candidates.enumerate_candidates`), the same argmin
switches the schedule kind too: under heavy preemption the grouped and
deep-warmup (ZB-H2) plans win, while on a quiet network the zero-bubble
plans' shorter fill/drain takes over.  ZB-H2 appears in the set only when
the memory-limit curve admits ``w[s] >= 1`` somewhere (the enumeration
refuses it otherwise), so picking it is always memory-safe — and its
warmup vector is per-stage, so the record carries the whole ``w[s]``.
Interleaved candidates additionally probe the virtual-stage wrap link
(``S-1 -> 0``) their ring actually uses.

With ``passive_staleness`` set, step (a) becomes conditional per link: the
runtime telemetry bus (:mod:`repro_torch.runtime.telemetry`) feeds the profiler
windows from observed iteration timings, and a link probed or fed within
the staleness horizon is read from its window instead of suspending the
pipeline — the paper's suspend-and-probe degrades into a fallback for
stale links only, and the coordinator charges ``tuning_overhead`` scaled
by the fraction of probes actually run.

Candidates are static, so each one's lowered
:class:`~repro_torch.core.schedule.TabularPlan` is computed at most once (cached
on the plan): re-evaluating every interval and dispatching the winner to
the engines never re-lowers.  With ``refine_weight_placement=True`` a
chosen zero-bubble winner is additionally post-processed by
:func:`repro_torch.core.placement.optimize_weight_placement` under the
just-measured bandwidths (heterogeneous costs make the unit-tick FIFO
``W`` filler suboptimal); the refined table is what gets dispatched, and
it is re-derived only when the choice or the measured network changes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.candidates import Candidate
from repro_torch.core.costmodel import CostModel, link_probe_specs
from repro_torch.core.kinds import ScheduleSpec, get_kind
from repro_torch.core.placement import optimize_weight_placement
from repro_torch.core.profiler import NetworkProfiler
from repro_torch.core.taskgraph import StageCosts

__all__ = ["TuningRecord", "AutoTuner"]


@dataclasses.dataclass
class TuningRecord:
    time: float
    estimates: dict[str, float]  # candidate name -> estimated pipeline length
    chosen: str
    chosen_k: int
    switched: bool
    chosen_kind: str = "kfkb"
    chosen_num_virtual: int = 1
    # the winner's per-stage warmup vector w[s]; all-zero unless a warmup
    # kind (zb_h2 / warmed interleaved_zb) won
    chosen_extra_warmup: tuple[int, ...] = ()
    # the winner's per-stage BWD_WEIGHT policy vector (split-backward kinds:
    # "saved_residual" on stages whose limit admitted the residuals,
    # "double_remat" elsewhere) — the tuner's policy trail
    chosen_zb_policy: tuple[str, ...] = ()
    # the winner's full schedule coordinates — the same ScheduleSpec the
    # candidate, the compile-cache key and the runtime consume (the legacy
    # chosen_* fields above are its projections, kept for callers)
    chosen_spec: ScheduleSpec | None = None
    # suspend-and-probe accounting for this round: with passive telemetry
    # keeping the profiler windows fresh, probes_run drops toward 0 and the
    # coordinator scales the charged tuning_overhead accordingly
    probes_run: int = 0
    probes_skipped: int = 0
    # every candidate that LOST this round: (name, estimated seconds, reason
    # it was rejected) sorted by estimate — the flight recorder and tests
    # assert *why* a spec won, not just that it did
    rejected_candidates: tuple[tuple[str, float, str], ...] = ()
    # with a custom objective (serving: SLO-weighted makespan under arrival
    # pressure) the argmin runs over these scores while `estimates` keeps the
    # raw makespans; None when the default makespan objective decided
    objective_scores: dict[str, float] | None = None

    @property
    def probe_fraction(self) -> float:
        """Fraction of this round's link probes that actually suspended the
        pipeline (1.0 when there were no links to probe — the degenerate
        case keeps the legacy full charge)."""
        total = self.probes_run + self.probes_skipped
        return self.probes_run / total if total else 1.0


class AutoTuner:
    def __init__(
        self,
        candidates: list[Candidate],
        stage_costs_for: Callable[[Candidate], StageCosts],
        network_profiler: NetworkProfiler,
        cost_model: CostModel | None = None,
        probes: int = 3,
        refine_weight_placement: bool = False,
        passive_staleness: float | None = None,
        flight=None,
        metrics=None,
        objective: Callable[[Candidate, float, float], float] | None = None,
    ) -> None:
        if not candidates:
            raise ValueError("no candidates to tune over")
        self.candidates = candidates
        self.stage_costs_for = stage_costs_for
        self.net_profiler = network_profiler
        self.cost_model = cost_model or CostModel()
        self.probes = probes
        self.refine_weight_placement = refine_weight_placement
        # §5.4 closing-the-loop mode: when a link's profiler window was fed
        # within the last `passive_staleness` seconds (by the runtime
        # telemetry bus observing real iterations), skip the suspend-probe
        # for it and read the window instead; None = always probe (paper
        # default).  Suspension is only paid for links that went stale.
        self.passive_staleness = passive_staleness
        # optional decision objective: score = objective(candidate,
        # makespan_estimate, now); the argmin runs over scores instead of raw
        # makespans.  The serving stack uses this for SLO-weighted selection
        # (latency-penalize deep grouping when the queue is slack, pure
        # throughput under arrival pressure); None keeps the paper's
        # makespan-argmin behaviour bit-for-bit.
        self.objective = objective
        # observability (optional): every tune() appends a tuner_decision
        # flight event carrying the full per-candidate score table, and the
        # registry counts decisions/switches
        self.flight = flight
        self.metrics = metrics
        if metrics is not None:
            self._m_decisions = metrics.counter("tuner_decisions_total")
            self._m_switches = metrics.counter("tuner_switches_total")
        self._probes_run = 0
        self._probes_skipped = 0
        self.current: Candidate = candidates[0]
        self.current_table = self.current.table  # dispatched to the engines
        self._refine_key: tuple | None = None  # (name, bw signature) of last refine
        self._last_bw: dict[str, dict[tuple[int, int], float]] = {}
        self.history: list[TuningRecord] = []

    # -- one tuning round -----------------------------------------------------

    def _profile_links(self, cand: Candidate, now: float) -> dict[tuple[int, int], float]:
        costs = self.stage_costs_for(cand)
        # shared with the runtime's passive feed — the freshness skip below
        # relies on both sides walking the same link list
        probes = link_probe_specs(cand.plan, costs)
        bw: dict[tuple[int, int], float] = {}
        for src, dst, nbytes in probes:
            if self.passive_staleness is not None and self.net_profiler.is_fresh(
                src, dst, now, self.passive_staleness
            ):
                # passive telemetry kept this link warm: no suspension,
                # extrapolate the candidate's transfer from the window's
                # effective bandwidth
                bw[(src, dst)] = self.net_profiler.link_bandwidth(src, dst)
                self._probes_skipped += 1
                continue
            self.net_profiler.measure(src, dst, nbytes, now, probes=self.probes)
            bw[(src, dst)] = self.net_profiler.effective_bandwidth(src, dst, nbytes)
            self._probes_run += 1
        return bw

    def evaluate(self, now: float) -> dict[str, float]:
        """Estimated pipeline length per candidate at simulated time ``now``.

        The per-candidate bandwidth measurements are kept on
        ``self._last_bw`` so the refinement path can reuse the winner's
        instead of re-probing (a second probe round would both double the
        modeled suspension cost and double-fill the winner's moving-average
        window relative to every other candidate's).
        """
        out: dict[str, float] = {}
        self._last_bw: dict[str, dict[tuple[int, int], float]] = {}
        self._probes_run = 0
        self._probes_skipped = 0
        for cand in self.candidates:
            costs = self.stage_costs_for(cand)
            bw = self._profile_links(cand, now)
            self._last_bw[cand.name] = bw
            out[cand.name] = self.cost_model.estimate(cand.plan, costs, bw)
        return out

    @staticmethod
    def _rejections(
        estimates: dict[str, float], best_name: str
    ) -> tuple[tuple[str, float, str], ...]:
        """The losers' score table: (name, estimate, why rejected), sorted
        best-first so the runner-up reads first in dumps."""
        best_est = estimates[best_name]
        out = []
        for name, est in sorted(estimates.items(), key=lambda kv: (kv[1], kv[0])):
            if name == best_name:
                continue
            if est == best_est:
                reason = f"tied at {est:.6g}s; {best_name!r} wins deterministic order"
            else:
                pct = 100.0 * (est - best_est) / best_est if best_est else float("inf")
                reason = f"estimated {est:.6g}s, {pct:.1f}% slower than {best_name!r}"
            out.append((name, est, reason))
        return tuple(out)

    def tune(self, now: float) -> TuningRecord:
        estimates = self.evaluate(now)
        if self.objective is not None:
            scores = {
                c.name: self.objective(c, estimates[c.name], now)
                for c in self.candidates
            }
        else:
            scores = estimates
        best_name = min(scores, key=scores.get)
        best = next(c for c in self.candidates if c.name == best_name)
        switched = best is not self.current
        self.current = best
        # dispatch artifact for the engines: lowered once per candidate ever
        # (Candidate.table caches on the static plan)
        self.current_table = best.table
        if self.refine_weight_placement and get_kind(best.plan.kind).weight_placement_refinable:
            costs = self.stage_costs_for(best)
            bw = self._last_bw[best.name]  # measured during evaluate()
            key = (best.name, tuple(sorted(bw.items())))
            if key != self._refine_key:
                refined = optimize_weight_placement(best.plan, costs, bw)
                self._refine_key = key
                self._refined_table = refined.lower()
            self.current_table = self._refined_table
        rec = TuningRecord(
            time=now,
            estimates=estimates,
            chosen=best.name,
            chosen_k=best.k,
            switched=switched,
            chosen_kind=best.plan.kind,
            chosen_num_virtual=best.plan.num_virtual,
            chosen_extra_warmup=best.plan.extra_warmup,
            chosen_zb_policy=tuple(best.plan.zb_policy),
            chosen_spec=best.spec,
            probes_run=self._probes_run,
            probes_skipped=self._probes_skipped,
            # losers ranked by the deciding scores (SLO-weighted when an
            # objective is set), so "why it lost" matches why it lost
            rejected_candidates=self._rejections(scores, best_name),
            objective_scores=dict(scores) if self.objective is not None else None,
        )
        self.history.append(rec)
        if self.metrics is not None:
            self._m_decisions.inc()
            if switched:
                self._m_switches.inc()
        if self.flight is not None:
            self.flight.record(
                "tuner_decision",
                time=now,
                chosen=best.name,
                chosen_estimate=estimates[best_name],
                switched=switched,
                estimates=dict(sorted(estimates.items())),
                rejected=[
                    {"name": n, "estimate": e, "reason": r}
                    for n, e, r in rec.rejected_candidates
                ],
                probes_run=rec.probes_run,
                probes_skipped=rec.probes_skipped,
            )
        return rec
