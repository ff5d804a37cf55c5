"""Cost-aware ``BWD_WEIGHT`` placement: beat the FIFO filler on skewed costs.

A copy of ``repro/core/placement.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

The zero-bubble builders (``zb_orders`` / ``interleaved_zb_orders``)
schedule weight-gradient work with a unit-cost lock-step walk: ``W`` runs
whenever the device would otherwise bubble, in FIFO order.  That is optimal
when every task costs one tick, but with *calibrated* heterogeneous costs a
long ``W`` issued right before a critical ``BWD_INPUT`` was about to become
ready delays the whole upstream chain — the filler should have waited for a
real bubble.

:func:`optimize_weight_placement` fixes the placement per device with a
small greedy search over the per-device ILP's move neighbourhood: every
``BWD_WEIGHT`` may be re-inserted at any position in its legal window
(best-improvement steepest descent), where a move is legal iff it preserves

* intra-device semantics — ``W`` stays after its own ``BWD_INPUT`` and the
  per-chunk ``W`` stream stays FIFO (what the engine's slot ring requires),
* the memory contract — delaying ``W`` past a ``FWD`` raises liveness, so a
  move is admitted only while the device's peak live count stays within its
  original peak (the plan's published memory price),

and a move is *kept* iff the discrete-event simulation of the whole plan
under the given costs/network strictly shortens.  The device F/B sequences
are untouched, so every cross-device send/recv keeps its order and the
link-FIFO invariants survive by construction.

Candidate moves are priced by :class:`IncrementalMakespan` rather than a
full re-simulation: a ``W`` move on device ``s`` leaves every task before
the move point untouched, so only the *affected suffix* — device ``s``
from the move position onward, plus whatever the changed completion times
actually reach on other devices — is re-evaluated against the memoized
baseline timeline.  The evaluator exploits two structural facts that make
the simulator's event loop a closed recurrence: each device executes its
order **in order** (task start = max(previous task end, input arrival)),
and each directed link serializes transfers FIFO in its single source
device's send order (which ``W`` moves never change — ``W`` tasks do not
communicate).  The sparse fixed-point over that acyclic recurrence is
exactly the event simulation's timeline (equivalence is tested), at a
fraction of the cost: no plan rebuild, no slot re-assignment, no event
heap, and untouched prefixes are never revisited.

This is deliberately a refinement pass over a built plan (not a new
builder): any zero-bubble family member — scalar or vector warmup,
grouped, interleaved — can be post-optimized once per-stage costs are
known, e.g. from :mod:`repro_torch.core.calibrate`.
"""

from __future__ import annotations

import math

from repro_torch.core.kinds import get_kind
from repro_torch.core.network import Network, StableTrace
from repro_torch.core.schedule import Op, SchedulePlan, Task, assign_slots
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.taskgraph import StageCosts, build_task_graph

__all__ = ["optimize_weight_placement", "IncrementalMakespan"]


def _device_peak(order) -> int:
    live = peak = 0
    for t in order:
        if t.op == Op.FWD:
            live += 1
            peak = max(peak, live)
        elif t.op == Op.BWD_WEIGHT:
            live -= 1
    return peak


def _move_window(order, i: int) -> tuple[int, int]:
    """Legal insertion positions ``[lo, hi]`` for the W at position ``i``:
    bounded below by its own ``BWD_INPUT`` and the previous same-chunk ``W``
    (stream FIFO), above by the next same-chunk ``W``."""
    w = order[i]
    lo = 0
    for j in range(i - 1, -1, -1):
        t = order[j]
        own_b = t.op == Op.BWD_INPUT and (t.mb, t.chunk) == (w.mb, w.chunk)
        if own_b or (t.op == Op.BWD_WEIGHT and t.chunk == w.chunk):
            lo = j + 1
            break
    hi = len(order) - 1
    for j in range(i + 1, len(order)):
        t = order[j]
        if t.op == Op.BWD_WEIGHT and t.chunk == w.chunk:
            hi = j - 1
            break
    return lo, hi


def _with_move(order, i: int, j: int) -> list:
    trial = list(order)
    w = trial.pop(i)
    trial.insert(j, w)
    return trial


def _frozen_network(effective_bw) -> Network:
    if effective_bw is None:
        return Network(default=StableTrace(math.inf))
    return Network(
        default=StableTrace(math.inf),
        links={k: StableTrace(bw) for k, bw in effective_bw.items()},
    )


class IncrementalMakespan:
    """Exact pipeline-length evaluation with suffix-only re-simulation.

    Built once per (plan topology, costs, network); ``evaluate(orders, s,
    pos)`` prices a trial where ONLY device ``s``'s order changed from
    position ``pos`` onward (the contract of a ``BWD_WEIGHT`` move).  The
    timeline satisfies the closed recurrence of the event simulator:

    * ``end(s, i) = max(end(s, i-1), arrival(incoming xfer)) + dur``,
    * the ``n``-th transfer on a directed link starts at
      ``max(producer end, finish of transfer n-1)`` and finishes per the
      link's bandwidth trace (FIFO; each link has a single source device,
      and W moves never change the send subsequence),

    which is acyclic, so re-solving only the nodes whose inputs changed —
    seeded with the moved device's suffix, propagated across devices via a
    per-device dirty frontier until a sweep is a no-op — reproduces the
    full simulation's makespan exactly.  The baseline timeline is memoized
    and ``rebaseline`` re-anchors it after an accepted move.
    """

    def __init__(self, plan: SchedulePlan, costs: StageCosts, network: Network) -> None:
        self.graph = build_task_graph(plan, costs)
        self.network = network
        S = plan.num_stages
        self.opt_time = list(self.graph.costs.optimizer_time)
        self.dur: dict[tuple, float] = {}
        # previous sender on the same directed link, per producing task key
        # (link FIFO chains are a property of the F/B subsequences, which W
        # moves never touch)
        self.xfer_prev: dict[tuple, tuple | None] = {}
        last_on_link: dict[tuple[int, int], tuple] = {}
        for s in range(S):
            for t in plan.orders[s]:
                self.dur[t.key()] = self.graph.task_time(t)
                for xf in self.graph.outgoing[t.key()]:
                    link = (xf.src, xf.dst)
                    self.xfer_prev[t.key()] = last_on_link.get(link)
                    last_on_link[link] = t.key()
        self.rebaseline([list(o) for o in plan.orders])

    # -- timeline recurrences -------------------------------------------------

    def _task_end(self, key, prev_end: float, xfer) -> float:
        spec = self.graph.incoming[key]
        arrival = 0.0
        if spec is not None:
            arrival = xfer.get(spec.key, self._base_xfer.get(spec.key, 0.0))
        return max(prev_end, arrival) + self.dur[key]

    def _xfer_finish(self, key, task_end: float, xfer) -> float | None:
        """Finish time of the transfer PRODUCED by ``key`` (None if local)."""
        outs = self.graph.outgoing[key]
        if not outs:
            return None
        xf = outs[0]
        prev = self.xfer_prev[key]
        prev_fin = 0.0
        if prev is not None:
            prev_fin = xfer.get(prev, self._base_xfer.get(prev, 0.0))
        start = max(task_end, prev_fin)
        return self.network.trace(xf.src, xf.dst).finish_time(start, xf.nbytes)

    def _solve(self, orders, dirty: dict[int, int], end: dict, xfer: dict,
               pos_of: dict[tuple, int]) -> None:
        """Sparse fixed point: sweep only dirty suffixes until stable."""
        while True:
            changed = False
            for s in sorted(dirty):
                order = orders[s]
                i = dirty[s]
                prev_end = 0.0
                if i > 0:
                    pk = order[i - 1].key()
                    prev_end = end.get(pk, self._base_end.get(pk, 0.0))
                for i in range(dirty[s], len(order)):
                    key = order[i].key()
                    new_end = self._task_end(key, prev_end, xfer)
                    if new_end != end.get(key, self._base_end.get(key)):
                        end[key] = new_end
                        changed = True
                    cur_end = end.get(key, self._base_end[key])
                    new_fin = self._xfer_finish(key, cur_end, xfer)
                    if new_fin is not None and new_fin != xfer.get(
                        key, self._base_xfer.get(key)
                    ):
                        xfer[key] = new_fin
                        changed = True
                        consumer = self._consumer_of[key]
                        dpos = pos_of.get(consumer, self._base_pos[consumer])
                        ds = consumer[1]
                        if ds not in dirty or dpos < dirty[ds]:
                            dirty[ds] = dpos
                    prev_end = cur_end
            if not changed:
                return

    # -- public API -----------------------------------------------------------

    def rebaseline(self, orders: list[list[Task]]) -> float:
        """Adopt ``orders`` as the memoized baseline; return its makespan."""
        self._orders = [list(o) for o in orders]
        self._base_end: dict[tuple, float] = {}
        self._base_xfer: dict[tuple, float] = {}
        self._base_pos: dict[tuple, int] = {}
        self._consumer_of: dict[tuple, tuple] = {}
        for s, order in enumerate(self._orders):
            for i, t in enumerate(order):
                self._base_pos[t.key()] = i
                spec = self.graph.incoming[t.key()]
                if spec is not None:
                    self._consumer_of[spec.key] = t.key()
        dirty = {s: 0 for s in range(len(self._orders))}
        self._solve(self._orders, dirty, self._base_end, self._base_xfer, {})
        self.makespan = self._length(self._orders, {})
        return self.makespan

    def _length(self, orders, end) -> float:
        out = 0.0
        for s, order in enumerate(orders):
            if not order:
                continue
            last = order[-1].key()
            fin = end.get(last, self._base_end[last])
            out = max(out, fin + self.opt_time[s])
        return out

    def evaluate(self, trial_orders: list[list[Task]], moved_stage: int,
                 from_pos: int) -> float:
        """Makespan of a trial differing from the baseline only on device
        ``moved_stage`` at positions >= ``from_pos``.  The baseline is not
        mutated; only the affected suffix is re-solved."""
        end: dict[tuple, float] = {}
        xfer: dict[tuple, float] = {}
        # moved-device positions shift with the move; other devices keep the
        # baseline layout (cross-device consumers always live off-device)
        pos_of = {
            t.key(): i for i, t in enumerate(trial_orders[moved_stage])
        }
        self._solve(trial_orders, {moved_stage: from_pos}, end, xfer, pos_of)
        return self._length(trial_orders, end)


def _rebuild(plan: SchedulePlan, orders) -> SchedulePlan:
    new = SchedulePlan(
        num_stages=plan.num_stages,
        num_microbatches=plan.num_microbatches,
        k=plan.k,
        micro_batch_size=plan.micro_batch_size,
        orders=[list(o) for o in orders],
        name=plan.name,
        kind=plan.kind,
        num_virtual=plan.num_virtual,
        extra_warmup=plan.extra_warmup,
        zb_policy=plan.zb_policy,
    )
    new.validate()
    assign_slots(new)
    return new


def optimize_weight_placement(
    plan: SchedulePlan,
    costs: StageCosts,
    effective_bw: dict[tuple[int, int], float] | None = None,
    max_passes: int = 8,
    evaluator: str = "incremental",
) -> SchedulePlan:
    """Greedy swap search over per-device ``BWD_WEIGHT`` positions.

    Returns a new validated plan (named ``...+Wopt``) whose simulated
    pipeline length under ``costs`` and the frozen ``effective_bw`` network
    is <= the input plan's, with per-device peak liveness never above the
    input plan's.  Non-zero-bubble plans are returned unchanged (they have
    no ``W`` tasks to place).

    ``evaluator`` selects how candidate moves are priced: ``"incremental"``
    (default) re-solves only the affected device suffix against the
    memoized baseline timeline via :class:`IncrementalMakespan`;
    ``"full"`` rebuilds and re-simulates the whole plan per move (the
    reference the incremental path is equivalence-tested against).
    """
    if not get_kind(plan.kind).weight_placement_refinable:
        return plan
    if evaluator not in ("incremental", "full"):
        raise ValueError(f"unknown evaluator {evaluator!r}")
    net = _frozen_network(effective_bw)
    orders = [list(o) for o in plan.orders]
    caps = [_device_peak(o) for o in orders]
    ev = IncrementalMakespan(plan, costs, net) if evaluator == "incremental" else None
    if ev is not None:
        best_len = ev.makespan
    else:
        best_len = simulate_plan(_rebuild(plan, orders), costs, net).pipeline_length
    for _ in range(max_passes):
        improved = False
        for s in range(len(orders)):
            order = orders[s]
            i = 0
            while i < len(order):
                if order[i].op != Op.BWD_WEIGHT:
                    i += 1
                    continue
                lo, hi = _move_window(order, i)
                best_move: tuple[float, list] | None = None
                for j in range(lo, hi + 1):
                    if j == i:
                        continue
                    trial_order = _with_move(order, i, j)
                    if j > i and _device_peak(trial_order) > caps[s]:
                        break  # delaying further only raises liveness more
                    trial_orders = list(orders)
                    trial_orders[s] = trial_order
                    if ev is not None:
                        length = ev.evaluate(trial_orders, s, min(i, j))
                    else:
                        length = simulate_plan(
                            _rebuild(plan, trial_orders), costs, net
                        ).pipeline_length
                    if length < best_len - 1e-12 and (
                        best_move is None or length < best_move[0]
                    ):
                        best_move = (length, trial_order)
                if best_move is not None:
                    best_len, orders[s] = best_move
                    order = orders[s]
                    improved = True
                    if ev is not None:
                        ev.rebaseline(orders)
                i += 1
        if not improved:
            break
    out = _rebuild(plan, orders)
    out.name = plan.name + "+Wopt"
    return out
