"""Task graph: stage-computation instances + Send/Recv transfers + grad-accum.

A copy of ``repro/core/taskgraph.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

Mirrors the paper's §2.4: every stage computation fed by a micro-batch is a
*task node*; Send/Recv pairs are explicit nodes inserted on cross-stage
edges; gradient-accumulation nodes stitch the micro-batches of one stage.
The graph is built from a :class:`~repro_torch.core.schedule.SchedulePlan` (any
family member — the cross-device topology comes from the same virtual-stage
rules the tabular lowering uses) plus a :class:`StageCosts` profile, and is
what the discrete-event simulator and the cost model consume.

Zero-bubble plans (``zb_h1`` and the deeper-warmup ``zb_h2``) split the
backward: ``BWD_INPUT`` (``bwd_input_time``, emits the upstream gradient
transfer) and ``BWD_WEIGHT`` (``bwd_weight_time``, no communication at
all).  Interleaved plans divide per-stage compute by the number of chunks
and route transfers along the virtual-stage ring (including the ``S-1 ->
0`` wrap link); the joint ``interleaved_zb`` kind combines both rules —
everything here is op- and chunk-driven, so no kind-specific branches are
needed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.core.schedule import Op, SchedulePlan, Task

__all__ = ["StageCosts", "TransferSpec", "TaskGraph", "build_task_graph"]


@dataclasses.dataclass
class StageCosts:
    """Profiled (or modelled) costs of one pipeline configuration.

    * ``fwd_time[s]`` / ``bwd_time[s]`` — seconds per micro-batch at stage s.
    * ``fwd_bytes[s]`` — activation bytes sent ``s -> s+1`` after a forward
      (index ``s`` in ``[0, S-2]``).
    * ``bwd_bytes[s]`` — gradient bytes sent ``s -> s-1`` after a backward
      (index ``s`` in ``[1, S-1]``).
    * ``optimizer_time[s]`` — per-stage epilogue (grad-accum finalize + apply).
    * ``bwd_input_time[s]`` / ``bwd_weight_time[s]`` — the zero-bubble split
      of ``bwd_time``; defaults to an even split (the ZB paper's F = B = W
      working assumption when ``bwd = 2 * fwd``).  Real stages skew — the
      last stage's B carries the vocab-projection backward, attention-heavy
      stages skew toward W — so production profiles should come from
      :func:`repro_torch.core.calibrate.calibrate_stage_costs`, which fills the
      split from the engines' stage bodies instead of this default.
    * ``bwd_weight_saved_time[s]`` — the W body under
      ``zb_policy="saved_residual"``: a pure pullback reusing B's saved vjp
      residuals, no rematerialization.  Defaults to
      ``max(bwd_weight - fwd, 0.1 * bwd_weight)`` (double-remat W ≈ one
      forward rematerialization + the pullback); calibration measures the
      real no-remat body.
    """

    fwd_time: list[float]
    bwd_time: list[float]
    fwd_bytes: list[float]
    bwd_bytes: list[float]
    optimizer_time: list[float] | None = None
    bwd_input_time: list[float] | None = None
    bwd_weight_time: list[float] | None = None
    bwd_weight_saved_time: list[float] | None = None

    @property
    def num_stages(self) -> int:
        return len(self.fwd_time)

    def __post_init__(self) -> None:
        S = len(self.fwd_time)
        assert len(self.bwd_time) == S
        assert len(self.fwd_bytes) >= S - 1
        assert len(self.bwd_bytes) >= S
        if self.optimizer_time is None:
            self.optimizer_time = [0.0] * S
        if self.bwd_input_time is None:
            self.bwd_input_time = [0.5 * t for t in self.bwd_time]
        if self.bwd_weight_time is None:
            self.bwd_weight_time = [
                t - bi for t, bi in zip(self.bwd_time, self.bwd_input_time)
            ]
        if self.bwd_weight_saved_time is None:
            self.bwd_weight_saved_time = [
                max(w - f, 0.1 * w)
                for w, f in zip(self.bwd_weight_time, self.fwd_time)
            ]

    @classmethod
    def uniform(
        cls,
        num_stages: int,
        fwd_time: float,
        bwd_time: float | None = None,
        act_bytes: float = 0.0,
        optimizer_time: float = 0.0,
    ) -> "StageCosts":
        """Paper §4.1 assumptions by default: ``bwd = 2 * fwd``; grad bytes =
        activation bytes (same tensor shape travelling back)."""
        if bwd_time is None:
            bwd_time = 2.0 * fwd_time
        return cls(
            fwd_time=[fwd_time] * num_stages,
            bwd_time=[bwd_time] * num_stages,
            fwd_bytes=[act_bytes] * num_stages,
            bwd_bytes=[act_bytes] * num_stages,
            optimizer_time=[optimizer_time] * num_stages,
        )

    def scaled_to_microbatch(self, b_ref: int, b_new: int, efficiency=None) -> "StageCosts":
        """Rescale costs profiled at micro-batch size ``b_ref`` to ``b_new``.

        Compute scales by ``b_new/b_ref`` divided by a relative *efficiency*
        factor (smaller micro-batches under-utilize the device — the paper's
        computation-efficiency term); bytes scale linearly.
        """
        ratio = b_new / float(b_ref)
        eff = efficiency(b_new) / efficiency(b_ref) if efficiency else 1.0
        scale_t = ratio / max(eff, 1e-9)
        return StageCosts(
            fwd_time=[t * scale_t for t in self.fwd_time],
            bwd_time=[t * scale_t for t in self.bwd_time],
            fwd_bytes=[x * ratio for x in self.fwd_bytes],
            bwd_bytes=[x * ratio for x in self.bwd_bytes],
            optimizer_time=list(self.optimizer_time),
            bwd_input_time=[t * scale_t for t in self.bwd_input_time],
            bwd_weight_time=[t * scale_t for t in self.bwd_weight_time],
            bwd_weight_saved_time=[t * scale_t for t in self.bwd_weight_saved_time],
        )


@dataclasses.dataclass(frozen=True)
class TransferSpec:
    """A Send/Recv pair: produced by ``src_task``, consumed by stage ``dst``."""

    src: int
    dst: int
    op: Op  # the op of the *producing* task (FWD moves down, BWD moves up)
    mb: int
    nbytes: float
    chunk: int = 0  # producing task's chunk (virtual-stage plans)

    @property
    def key(self) -> tuple[int, int, int, int]:
        """The (op, stage, mb, chunk) the *consumer* waits for — producer's
        identity."""
        return (int(self.op), self.src, self.mb, self.chunk)


@dataclasses.dataclass
class TaskGraph:
    plan: SchedulePlan
    costs: StageCosts
    # transfers emitted by each completed task, keyed by task.key()
    outgoing: dict[tuple[int, int, int, int], list[TransferSpec]]
    # the cross-stage input each task waits for (None for boundary stages)
    incoming: dict[tuple[int, int, int, int], TransferSpec | None]

    @property
    def num_stages(self) -> int:
        return self.plan.num_stages

    def task_time(self, task: Task) -> float:
        v = self.plan.num_virtual
        if task.op == Op.FWD:
            return self.costs.fwd_time[task.stage] / v
        if task.op == Op.BWD:
            return self.costs.bwd_time[task.stage] / v
        if task.op == Op.BWD_INPUT:
            return self.costs.bwd_input_time[task.stage] / v
        if task.op == Op.BWD_WEIGHT:
            if self.plan.zb_policy[task.stage] == "saved_residual":
                return self.costs.bwd_weight_saved_time[task.stage] / v
            return self.costs.bwd_weight_time[task.stage] / v
        return 0.0

    def iter_tasks(self) -> Iterator[Task]:
        yield from self.plan.tasks()


def _link_bytes(costs: StageCosts, src: int, forward: bool) -> float:
    """Bytes crossing the ``src -> dst`` boundary.  Interleaved wrap-link
    transfers (forward ``S-1 -> 0``, backward ``0 -> S-1``) carry the same
    hidden-state tensor as any other hop, so they reuse the nearest entry
    that is inside the StageCosts contract (``fwd_bytes`` defined on
    ``[0, S-2]``, ``bwd_bytes`` on ``[1, S-1]``) instead of reading the
    contract's placeholder slots."""
    if forward:
        table = costs.fwd_bytes
        # in-contract entries are [0, S-2] even when a placeholder S-th
        # entry is present (StageCosts.uniform fills all S slots)
        return table[max(0, min(src, costs.num_stages - 2))]
    table = costs.bwd_bytes
    return table[src] if src >= 1 else table[min(1, len(table) - 1)]


def build_task_graph(plan: SchedulePlan, costs: StageCosts) -> TaskGraph:
    """Insert Send/Recv transfer specs for every cross-device dependency.

    The topology is the virtual-stage chain under the plan's placement
    map: the forward of virtual stage ``j`` feeds ``j + 1``, the critical
    backward of ``j`` feeds ``j - 1`` — on whatever device the placement
    puts them (Megatron's looped ring, ZB-V's mirrored V, ...).  A chain
    hop between two chunks of the SAME device (ZB-V's turn) is not a
    transfer at all — it is ordered by the device's own sequential
    execution.  ``BWD_WEIGHT`` tasks neither send nor receive.  For
    chunked plans it is *compute* that splits across chunks (see
    :meth:`TaskGraph.task_time`), NOT the wire size: every message still
    carries the full ``[b, T, d]`` hidden state, and there are ``v`` times
    more of them — interleaving trades bubble for messaging, raising total
    wire bytes by ``v``.
    """
    S = plan.num_stages
    V = plan.total_virtual_stages
    pl = plan.placement
    assert costs.num_stages == S
    outgoing: dict[tuple[int, int, int, int], list[TransferSpec]] = {}
    incoming: dict[tuple[int, int, int, int], TransferSpec | None] = {}
    for task in plan.tasks():
        key = task.key()
        outgoing.setdefault(key, [])
        incoming.setdefault(key, None)
        vs = plan.virtual_stage(task)
        if task.op == Op.FWD and vs < V - 1:
            dst_s, dst_c = int(pl.device_of[vs + 1]), int(pl.chunk_of[vs + 1])
            if dst_s == task.stage:
                continue  # intra-device chain hop: no wire
            xf = TransferSpec(
                task.stage, dst_s, Op.FWD, task.mb,
                _link_bytes(costs, task.stage, forward=True), chunk=task.chunk,
            )
            outgoing[key].append(xf)
            incoming[(int(Op.FWD), dst_s, task.mb, dst_c)] = xf
        elif task.op in (Op.BWD, Op.BWD_INPUT) and vs > 0:
            dst_s, dst_c = int(pl.device_of[vs - 1]), int(pl.chunk_of[vs - 1])
            if dst_s == task.stage:
                continue  # intra-device chain hop: no wire
            xb = TransferSpec(
                task.stage, dst_s, task.op, task.mb,
                _link_bytes(costs, task.stage, forward=False), chunk=task.chunk,
            )
            outgoing[key].append(xb)
            incoming[(int(task.op), dst_s, task.mb, dst_c)] = xb
    return TaskGraph(plan=plan, costs=costs, outgoing=outgoing, incoming=incoming)
