"""§4.3 cost model: estimate pipeline length for every candidate plan.

A copy of ``repro/core/costmodel.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

The paper's "simple cost model" consumes (a) the stable per-stage compute
profile and (b) the windowed end-to-end transfer-time measurements, and
estimates the pipeline length of each candidate — any schedule kind, since
the estimator is plan-agnostic.  The compute profile is a full per-stage
:class:`~repro_torch.core.taskgraph.StageCosts` (including the ``BWD_INPUT`` /
``BWD_WEIGHT`` split), so calibrated heterogeneous stages
(:mod:`repro_torch.core.calibrate`) price through the estimator unchanged — no
uniformity is assumed anywhere below this line.  We implement it as a deterministic run of
the discrete-event simulator with each link frozen at its *measured
effective bandwidth* (bytes / measured transfer time) — i.e.
the model assumes the recently-observed network state persists, which is
precisely the paper's assumption when it re-evaluates at tuning intervals.

A closed-form estimate for the contention-free case is also provided for
validation: for uniform stages with zero transfer cost the 1F1B length is
``(S-1) * (t_f + t_b) + M * (t_f + t_b)``; with per-hop transfer ``c`` the
fill/drain ramps pay ``2c`` per hop and the steady state lies between the
zero-comm form and the fully-exposed ``M * (t_f + t_b + 2c)`` (the F->F->
B->B dependency cycle between adjacent stages carries 2c that overlaps
only partially).  The simulator is the ground truth; the closed forms are
validation bounds.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.network import Network, StableTrace
from repro_torch.core.schedule import SchedulePlan
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.taskgraph import StageCosts

__all__ = ["CostModel", "closed_form_1f1b_length", "link_probe_specs"]


def link_probe_specs(
    plan: SchedulePlan, costs: StageCosts
) -> list[tuple[int, int, float]]:
    """The ``(src, dst, nbytes)`` set a plan's execution exercises: the
    chain links both ways with the plan's actual transfer sizes, plus the
    interleaved ring's wrap link.  The SINGLE source of truth shared by the
    tuner's suspend-probe round and the runtime's passive telemetry feed —
    the passive-skip contract (a fed link is never re-probed while fresh)
    only holds because both walk exactly this list.

    For plans whose kind overrides the looped placement (ZB-V's mirrored
    V), the directed link set is derived from the placement map instead:
    every cross-device virtual-stage hop in both roles, each probed once.
    """
    S = plan.num_stages
    pl = plan.placement
    if pl.is_looped:
        specs = [(s, s + 1, costs.fwd_bytes[s]) for s in range(S - 1)]
        specs += [(s + 1, s, costs.bwd_bytes[s + 1]) for s in range(S - 1)]
        if plan.num_virtual > 1 and S > 2:
            # the interleaved ring also crosses the wrap link in both
            # roles; wrap transfers carry the same hidden state as any
            # other hop, so probe with in-contract entries (bwd_bytes[0]
            # is a placeholder)
            specs += [
                (S - 1, 0, costs.fwd_bytes[S - 2]),
                (0, S - 1, costs.bwd_bytes[1]),
            ]
        return specs
    V = plan.total_virtual_stages
    seen: set[tuple[int, int]] = set()
    specs = []
    for u in range(V - 1):
        src, dst = int(pl.device_of[u]), int(pl.device_of[u + 1])
        if src == dst:
            continue  # intra-device hop (the V turn): nothing on the wire
        fwd_nbytes = costs.fwd_bytes[max(0, min(src, S - 2))]
        bwd_nbytes = costs.bwd_bytes[max(1, min(dst, S - 1))]
        if (src, dst) not in seen:
            seen.add((src, dst))
            specs.append((src, dst, fwd_nbytes))
        if (dst, src) not in seen:
            seen.add((dst, src))
            specs.append((dst, src, bwd_nbytes))
    return specs


def closed_form_1f1b_length(
    num_stages: int, num_microbatches: int, t_f: float, t_b: float, c: float = 0.0
) -> float:
    """Uniform-stage 1F1B length, exact at c == 0; a LOWER bound for c > 0.

    Fill+drain ramp crosses S-1 hops paying (t_f + c) down and (t_b + c)
    up; the steady state runs M repetitions of (t_f + t_b) on the last
    stage.  For c > 0 the steady state additionally exposes part of the 2c
    on the adjacent-stage dependency cycle, so the true length lies between
    this and the fully-exposed ``(S-1+M) * (t_f + t_b + 2c)``.
    """
    S, M = num_stages, num_microbatches
    return (S - 1) * (t_f + t_b + 2.0 * c) + M * (t_f + t_b)


@dataclasses.dataclass
class CostModel:
    """Pipeline-length estimator from profiles.

    ``stage_costs_for(candidate)`` and the measured effective bandwidths are
    supplied by the caller (tuner); the model itself is stateless.
    """

    def estimate(
        self,
        plan: SchedulePlan,
        costs: StageCosts,
        effective_bw: dict[tuple[int, int], float],
    ) -> float:
        """Estimated pipeline length under frozen effective bandwidths."""
        links = {k: StableTrace(bw) for k, bw in effective_bw.items()}
        net = Network(default=StableTrace(float("inf")), links=links)
        return simulate_plan(plan, costs, net).pipeline_length

    def throughput(
        self,
        plan: SchedulePlan,
        costs: StageCosts,
        effective_bw: dict[tuple[int, int], float],
        global_batch: int,
    ) -> float:
        """Samples/second implied by the estimated pipeline length."""
        return global_batch / self.estimate(plan, costs, effective_bw)
