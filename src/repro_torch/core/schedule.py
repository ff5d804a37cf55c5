"""Pipeline schedule family: kFkB (1F1B, GPipe), ZB-H1/H2, interleaved, ZB-V.

A copy of ``repro/core/schedule.py`` for the port, which imports nothing of
``repro``: numpy only.  ``tests/test_torch_schedule.py`` holds it equal to
the original (plans, lowered grids, slots, peaks).

A *schedule plan* is, per pipeline device, an ordered list of :class:`Task`
records (forward / backward work of one micro-batch, optionally split into
the zero-bubble ``BWD_INPUT``/``BWD_WEIGHT`` pair, or interleaved over
virtual-stage chunks).  kFkB groups ``k`` micro-batches into one schedule
unit: the base order is built over ``G = M/k`` groups and every group op is
expanded into its ``k`` members in FIFO order (the paper's §5.4).

Everything about one schedule kind lives in its
:class:`repro_torch.core.kinds.KindSpec`; nothing outside ``kinds.py`` and
this module dispatches on the kind string (``tests/test_torch_schedule.py``
scans the port for it).  Every plan lowers to one :class:`TabularPlan`: a
lock-step ``[num_stages, ticks]`` grid (one task per device per tick, data
produced at tick ``t`` consumable at ``t+1``) plus the exact send/recv
edges.  The port's pipeline engine walks that grid.

Kept from the original: the order builders the registry uses, ``make_plan``
(with the ``DeprecationWarning`` for the legacy family kwargs),
``assign_slots``, ``peak_live_activations``, ``lower_to_table``,
``tick_table``, ``tick_table_stats`` (the engine dry run's tick count and
bubble) and the plan's ``spec`` view.  Left out, as nothing in the port
calls them: the legacy kind-set views (``PLAN_KINDS`` and its siblings; the
registry answers those questions), the ZB-H1 and 1F1B/GPipe order wrappers
and the other tables' statistics helpers.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, Sequence
import warnings

import numpy as np

__all__ = [
    "ZB_SLOT_POLICIES",
    "normalize_warmup",
    "normalize_zb_policy",
    "Op",
    "Task",
    "Placement",
    "SchedulePlan",
    "TabularPlan",
    "PlanEdge",
    "kfkb_order",
    "zb_orders",
    "interleaved_kfkb_order",
    "interleaved_zb_orders",
    "make_plan",
    "lower_to_table",
    "assign_slots",
    "peak_live_activations",
    "tick_table",
    "tick_table_stats",
]

#: per-stage BWD_WEIGHT policies of split-backward kinds (the original keeps
#: this tuple in ``repro/core/memory_model.py``; the port's copy of that
#: module re-exports this one, since it imports this module)
ZB_SLOT_POLICIES = ("double_remat", "saved_residual")


class Op(enum.IntEnum):
    IDLE = 0
    FWD = 1
    BWD = 2  # combined input+weight backward (1F1B / kFkB / GPipe)
    BWD_INPUT = 3  # zero-bubble "B": dL/dx only — stays on the critical path
    BWD_WEIGHT = 4  # zero-bubble "W": dL/dw only — fills bubbles, frees the slot


#: ops that consume a cross-stage input produced by the NEXT virtual stage
_BWD_CRITICAL = (Op.BWD, Op.BWD_INPUT)


def normalize_warmup(extra_warmup: int | Sequence[int], num_stages: int) -> tuple[int, ...]:
    """Normalize ``extra_warmup`` to the per-stage vector ``w[s]``.

    A scalar broadcasts to every stage (the uniform "scalar-w" H2 of Qi et
    al.); a sequence must have exactly ``num_stages`` entries, all >= 0.
    """
    if isinstance(extra_warmup, (int, np.integer)):
        w = (int(extra_warmup),) * num_stages
    else:
        w = tuple(int(x) for x in extra_warmup)
        if len(w) != num_stages:
            raise ValueError(
                f"extra_warmup vector needs one entry per stage "
                f"(got {len(w)}, num_stages={num_stages})"
            )
    if any(x < 0 for x in w):
        raise ValueError(f"extra_warmup must be >= 0, got {w}")
    return w


def normalize_zb_policy(
    zb_policy: str | Sequence[str], num_stages: int
) -> tuple[str, ...]:
    """Normalize ``zb_policy`` to the per-stage vector ``zb_policy[s]``.

    A scalar broadcasts to every stage; a sequence must have exactly
    ``num_stages`` entries.  Every entry must be a member of
    :data:`ZB_SLOT_POLICIES` (``"double_remat"`` —
    the default, BWD_WEIGHT re-runs the forward — or ``"saved_residual"``
    — BWD_INPUT's saved residuals (in the port: its autograd graph)
    stay in the live slot and BWD_WEIGHT reuses them).  Whether a *kind* may carry a non-default
    policy is ``ScheduleSpec.resolve``'s job (``supports_saved_residual``),
    not this function's.
    """
    if isinstance(zb_policy, str):
        pol = (zb_policy,) * num_stages
    else:
        pol = tuple(str(x) for x in zb_policy)
        if len(pol) != num_stages:
            raise ValueError(
                f"zb_policy vector needs one entry per stage "
                f"(got {len(pol)}, num_stages={num_stages})"
            )
    for p in pol:
        if p not in ZB_SLOT_POLICIES:
            raise ValueError(
                f"unknown zb_policy {p!r}; expected one of {ZB_SLOT_POLICIES}"
            )
    return pol


@dataclasses.dataclass(frozen=True)
class Task:
    """One unit of work on one pipeline device.

    ``chunk`` is the virtual-stage index on the device (always 0 for
    non-interleaved plans); the global virtual stage the chunk hosts comes
    from the kind's placement map — Megatron's looped ``chunk * S + stage``
    unless the kind overrides it (ZB-V's mirrored V).
    """

    op: Op
    stage: int
    mb: int  # micro-batch index in [0, M)
    chunk: int = 0  # virtual-stage chunk on this device
    slot: int = -1  # activation buffer slot (filled by assign_slots)

    def key(self) -> tuple[int, int, int, int]:
        return (int(self.op), self.stage, self.mb, self.chunk)


@dataclasses.dataclass(frozen=True)
class Placement:
    """The plan's device placement of virtual stages, as lookup arrays.

    ``vstage_of[s, c]`` is the global virtual stage device ``s``'s chunk
    ``c`` hosts; ``device_of[vs]`` / ``chunk_of[vs]`` invert it.  The map
    comes from the kind's registered ``virtual_stage`` function (looped
    ``chunk * S + stage`` by default) and must be a bijection onto
    ``[0, S * v)``.  ``is_looped`` marks the Megatron default, which some
    legacy helpers special-case.
    """

    vstage_of: np.ndarray  # [S, v] int
    device_of: np.ndarray  # [S * v] int
    chunk_of: np.ndarray  # [S * v] int
    is_looped: bool

    @classmethod
    def build(cls, kind: str, num_stages: int, num_virtual: int) -> "Placement":
        from repro_torch.core.kinds import get_kind

        S, v = num_stages, num_virtual
        fn = get_kind(kind).virtual_stage
        vstage_of = np.empty((S, v), dtype=np.int64)
        for s in range(S):
            for c in range(v):
                vstage_of[s, c] = fn(s, c, S, v) if fn is not None else c * S + s
        if sorted(int(x) for x in vstage_of.reshape(-1)) != list(range(S * v)):
            raise ValueError(
                f"kind {kind!r}: virtual_stage map is not a bijection onto "
                f"[0, {S * v}): {vstage_of.tolist()}"
            )
        device_of = np.empty(S * v, dtype=np.int64)
        chunk_of = np.empty(S * v, dtype=np.int64)
        for s in range(S):
            for c in range(v):
                device_of[vstage_of[s, c]] = s
                chunk_of[vstage_of[s, c]] = c
        looped = all(
            int(vstage_of[s, c]) == c * S + s for s in range(S) for c in range(v)
        )
        return cls(vstage_of, device_of, chunk_of, looped)


@dataclasses.dataclass
class SchedulePlan:
    """A complete plan: per-device ordered task lists plus its identity."""

    num_stages: int
    num_microbatches: int
    k: int
    micro_batch_size: int
    orders: list[list[Task]]  # orders[s] = ordered tasks of device s
    name: str = ""
    kind: str = "kfkb"
    num_virtual: int = 1  # chunks per device (1 = non-interleaved)
    # warmup kinds: forwards beyond the 1F1B cap, per stage.  Normalized in
    # __post_init__ to the per-stage vector w[s] (a scalar broadcasts).
    extra_warmup: int | tuple[int, ...] = 0
    # split-backward kinds: per-stage BWD_WEIGHT policy ("double_remat" or
    # "saved_residual").  Normalized in __post_init__ to the per-stage
    # vector zb_policy[s] (a scalar broadcasts).  Stages priced (and run)
    # as saved_residual keep B's vjp residuals in the live slot so W skips
    # the second rematerialization.
    zb_policy: str | tuple[str, ...] = "double_remat"
    # lazily-populated lowering cache: plans are static once built, so the
    # TabularPlan is computed at most once (the tuner re-evaluates candidates
    # every interval and must not re-lower them)
    _table: "TabularPlan | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )
    _placement: "Placement | None" = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    def __post_init__(self) -> None:
        self.extra_warmup = normalize_warmup(self.extra_warmup, self.num_stages)
        self.zb_policy = normalize_zb_policy(self.zb_policy, self.num_stages)
        if not self.name:
            from repro_torch.core.kinds import get_kind

            base = f"{self.k}F{self.k}B(b={self.micro_batch_size})"
            self.name = get_kind(self.kind).plan_label(
                base, self.num_virtual, self._warmup_tag(), self.max_extra_warmup
            )
            self.name += self._zb_policy_tag()

    def _zb_policy_tag(self) -> str:
        """``"+SR"`` (all stages saved_residual) / ``"+SR(i,j)"`` (mixed) /
        ``""`` (all double_remat) — part of the plan name so estimate keys
        and the compile-cache key distinguish policies."""
        sr = [s for s, p in enumerate(self.zb_policy) if p == "saved_residual"]
        if not sr:
            return ""
        if len(sr) == self.num_stages:
            return "+SR"
        return "+SR(" + ",".join(str(s) for s in sr) + ")"

    def _warmup_tag(self) -> str:
        w = self.extra_warmup
        if len(set(w)) == 1:  # uniform (scalar-w) vectors keep the legacy name
            return str(w[0])
        return "w(" + ",".join(str(x) for x in w) + ")"

    @property
    def max_extra_warmup(self) -> int:
        """Deepest per-stage warmup extension (0 for non-warmup kinds)."""
        return max(self.extra_warmup)

    @property
    def num_groups(self) -> int:
        return (self.num_microbatches + self.k - 1) // self.k

    @property
    def total_virtual_stages(self) -> int:
        return self.num_stages * self.num_virtual

    @property
    def spec(self):
        """The plan's normalized :class:`~repro_torch.core.kinds.ScheduleSpec`:
        the one coordinate currency candidates, tuning records, the
        compile-cache key and the runtime all share."""
        from repro_torch.core.kinds import ScheduleSpec

        return ScheduleSpec.from_plan(self)

    @property
    def placement(self) -> Placement:
        """The kind's virtual-stage placement map (cached — plans are
        static once built)."""
        if self._placement is None:
            self._placement = Placement.build(
                self.kind, self.num_stages, self.num_virtual
            )
        return self._placement

    def virtual_stage(self, task: Task) -> int:
        return int(self.placement.vstage_of[task.stage, task.chunk])

    def tasks(self) -> Iterator[Task]:
        for order in self.orders:
            yield from order

    def lower(self) -> "TabularPlan":
        """Lower to the :class:`TabularPlan`, caching the result.

        Plans are immutable once :func:`make_plan` returns (``assign_slots``
        runs before any lowering), so the table is computed at most once per
        plan — candidates re-evaluated across tuner intervals and handed to
        the engines share one lowering.
        """
        if self._table is None:
            self._table = lower_to_table(self)
        return self._table

    def validate(self) -> None:
        """Structural invariants every legal synchronous plan must satisfy."""
        from repro_torch.core.kinds import get_kind

        S, M, V = self.num_stages, self.num_microbatches, self.num_virtual
        zb = get_kind(self.kind).has_split_backward
        if not zb:
            assert all(p == "double_remat" for p in self.zb_policy), (
                f"zb_policy {self.zb_policy} on non-split-backward kind "
                f"{self.kind!r} (no BWD_WEIGHT task to apply it to)"
            )
        for s, order in enumerate(self.orders):
            fwd_seen: dict[int, set[int]] = {c: set() for c in range(V)}
            bwd_seen: dict[int, set[int]] = {c: set() for c in range(V)}
            w_seen: dict[int, set[int]] = {c: set() for c in range(V)}
            for t in order:
                assert t.stage == s, f"task {t} listed under device {s}"
                assert 0 <= t.chunk < V, f"chunk out of range: {t}"
                if t.op == Op.FWD:
                    assert t.mb not in fwd_seen[t.chunk], f"dup FWD {t}"
                    fwd_seen[t.chunk].add(t.mb)
                elif t.op in _BWD_CRITICAL:
                    assert (zb and t.op == Op.BWD_INPUT) or (not zb and t.op == Op.BWD), (
                        f"op {t.op!r} illegal in kind {self.kind!r}"
                    )
                    assert t.mb in fwd_seen[t.chunk], f"BWD before FWD: {t}"
                    assert t.mb not in bwd_seen[t.chunk], f"dup BWD {t}"
                    bwd_seen[t.chunk].add(t.mb)
                elif t.op == Op.BWD_WEIGHT:
                    assert zb, f"BWD_WEIGHT outside zb plan: {t}"
                    assert t.mb in bwd_seen[t.chunk], f"W before B: {t}"
                    assert t.mb not in w_seen[t.chunk], f"dup W {t}"
                    w_seen[t.chunk].add(t.mb)
            for c in range(V):
                assert fwd_seen[c] == set(range(M)), f"device {s} chunk {c}: missing FWDs"
                assert bwd_seen[c] == set(range(M)), f"device {s} chunk {c}: missing BWDs"
                if zb:
                    assert w_seen[c] == set(range(M)), f"device {s} chunk {c}: missing Ws"


# ---------------------------------------------------------------------------
# Order construction
# ---------------------------------------------------------------------------


def _virtual_1f1b(num_stages: int, num_groups: int, stage: int) -> list[tuple[Op, int]]:
    """Classic synchronous 1F1B order for one stage over *virtual* micro-batches.

    warmup: ``min(S - s, G)`` forwards, then steady 1F1B, then the cooldown
    backwards.  (DAPPLE-style early backward: the last stage runs strictly
    F0 B0 F1 B1 ...)
    """
    S, G, s = num_stages, num_groups, stage
    warmup = min(S - s, G)
    order: list[tuple[Op, int]] = [(Op.FWD, g) for g in range(warmup)]
    next_fwd = warmup
    next_bwd = 0
    # steady state: alternate B, F while forwards remain
    while next_fwd < G:
        order.append((Op.BWD, next_bwd))
        next_bwd += 1
        order.append((Op.FWD, next_fwd))
        next_fwd += 1
    # cooldown: remaining backwards
    while next_bwd < G:
        order.append((Op.BWD, next_bwd))
        next_bwd += 1
    return order


def _expand_groups(
    virt: list[tuple[Op, int]], k: int, num_microbatches: int
) -> list[tuple[Op, int]]:
    """Expand group-level (op, g) ops into their k FIFO members."""
    M = num_microbatches
    out: list[tuple[Op, int]] = []
    for op, g in virt:
        out.extend((op, g * k + i) for i in range(min(k, M - g * k)))
    return out


def kfkb_order(
    num_stages: int, num_microbatches: int, k: int, stage: int
) -> list[tuple[Op, int]]:
    """kFkB order for one stage: expand the virtual-1F1B over ceil(M/k) groups.

    Every virtual FWD of group ``g`` becomes the forwards of micro-batches
    ``g*k .. g*k + k - 1`` in FIFO order (and likewise for backwards), i.e.
    the "cross-merge of k copies of 1F1B" of the paper's §5.4.  When k does
    not divide M the final group is smaller (the paper's Fig-6 sweep uses
    k=5 with M=192).
    """
    M = num_microbatches
    G = (M + k - 1) // k
    return _expand_groups(_virtual_1f1b(num_stages, G, stage), k, M)


def zb_orders(
    num_stages: int,
    num_microbatches: int,
    k: int = 1,
    extra_warmup: int | Sequence[int] = 0,
) -> list[list[tuple[Op, int]]]:
    """Zero-bubble orders for ALL stages (they are built jointly): the
    handcrafted schedules of Qi et al. 2024, composed with kFkB grouping.
    ``extra_warmup == 0`` is ZB-H1; a positive scalar is the uniform ZB-H2;
    a per-stage vector ``w[s]`` is the heterogeneous H2 — each stage gets
    its own warmup extension, sized to ITS memory headroom.

    Backward is split into ``BWD_INPUT`` (``B``: input gradient, consumed by
    the upstream stage — critical path) and ``BWD_WEIGHT`` (``W``: weight
    gradient, no consumer — pure filler).  Per stage the order is built by a
    greedy lock-step walk with priority ``B > F > W`` where

    * ``F`` issuance is capped so that live activations (allocated at F,
      freed at the matching W) never exceed ``min(min(S - s, G) + w[s], G)``:
      at ``w == 0`` this is 1F1B's bound — the "H1" memory guarantee (same
      peak as 1F1B) — and every extra warmup forward of H2 buys one more
      live slot at that stage to fill the warmup bubble with real F work
      (the same memory-for-stall trade Ada-Grouper makes with ``k``), and
    * ``W`` runs exactly when the device would otherwise bubble, so weight
      gradient work fills the fill/drain and preemption stalls.

    Grouping expands every group-level F/B/W into its ``k`` FIFO members
    (the kFkB-ZB hybrid).  Returns one order per stage.
    """
    S, M = num_stages, num_microbatches
    w = normalize_warmup(extra_warmup, S)
    G = (M + k - 1) // k
    next_f = [0] * S
    next_b = [0] * S
    next_w = [0] * S
    done: dict[tuple[int, int, int], int] = {}  # (op, stage, g) -> tick
    orders: list[list[tuple[Op, int]]] = [[] for _ in range(S)]
    cap = [min(min(S - s, G) + w[s], G) for s in range(S)]
    total = 3 * G * S
    executed = 0
    t = 0
    max_ticks = 6 * G * S + 12 * S + 4 * max(w) * S + 16
    while executed < total:
        if t > max_ticks:  # pragma: no cover - defensive
            raise RuntimeError("zb_orders failed to converge")
        fired: list[tuple[int, Op, int]] = []
        for s in range(S):
            choice: tuple[Op, int] | None = None
            b = next_b[s]
            if b < G and b < next_f[s]:
                ready = done.get((int(Op.FWD), s, b)) is not None
                if ready and s < S - 1:
                    dep = done.get((int(Op.BWD_INPUT), s + 1, b))
                    ready = dep is not None and dep < t
                if ready:
                    choice = (Op.BWD_INPUT, b)
            if choice is None and next_f[s] < G and next_f[s] - next_w[s] < cap[s]:
                f = next_f[s]
                if s == 0:
                    choice = (Op.FWD, f)
                else:
                    dep = done.get((int(Op.FWD), s - 1, f))
                    if dep is not None and dep < t:
                        choice = (Op.FWD, f)
            if choice is None and next_w[s] < next_b[s]:
                choice = (Op.BWD_WEIGHT, next_w[s])
            if choice is not None:
                op, g = choice
                orders[s].append(choice)
                fired.append((s, op, g))
                if op == Op.FWD:
                    next_f[s] += 1
                elif op == Op.BWD_INPUT:
                    next_b[s] += 1
                else:
                    next_w[s] += 1
                executed += 1
        for s, op, g in fired:
            done[(int(op), s, g)] = t
        t += 1
    return [_expand_groups(o, k, M) for o in orders]


def _interleaved_groups(num_stages: int, num_microbatches: int, k: int, num_virtual: int) -> int:
    """Validate the interleaved divisibility constraints; return ``G = M/k``."""
    S, M, v = num_stages, num_microbatches, num_virtual
    if v < 1:
        raise ValueError(f"num_virtual must be >= 1, got {v}")
    if M % k != 0:
        raise ValueError(f"interleaved kFkB needs k | M (k={k}, M={M})")
    G = M // k
    if G % S != 0:
        raise ValueError(f"interleaved needs num_groups % num_stages == 0 (G={G}, S={S})")
    return G


def _interleaved_virtual_order(
    num_stages: int, num_groups: int, num_virtual: int, stage: int
) -> list[tuple[Op, int, int]]:
    """Megatron's interleaved 1F1B for one device over GROUP indices:
    ``(op, g, chunk)`` with warmup ``2*(S - s - 1) + (v - 1) * S`` forwards,
    steady 1F1B cycling chunks every ``S`` steps, cooldown backwards."""
    S, G, v, s = num_stages, num_groups, num_virtual, stage
    total = G * v
    warmup = min(2 * (S - s - 1) + (v - 1) * S, total)

    def chunk_of(step: int, forward: bool) -> int:
        c = (step % (S * v)) // S
        return c if forward else v - 1 - c

    fcount = [0] * v
    bcount = [0] * v
    seq: list[tuple[Op, int, int]] = []

    def emit_f(step: int) -> None:
        c = chunk_of(step, True)
        seq.append((Op.FWD, fcount[c], c))
        fcount[c] += 1

    def emit_b(step: int) -> None:
        c = chunk_of(step, False)
        seq.append((Op.BWD, bcount[c], c))
        bcount[c] += 1

    for i in range(warmup):
        emit_f(i)
    for i in range(warmup, total):
        emit_f(i)
        emit_b(i - warmup)
    for i in range(total - warmup, total):
        emit_b(i)
    return seq


def _expand_groups3(
    virt: list[tuple[Op, int, int]], k: int, num_microbatches: int
) -> list[tuple[Op, int, int]]:
    """Expand group-level (op, g, chunk) ops into their k FIFO members."""
    M = num_microbatches
    out: list[tuple[Op, int, int]] = []
    for op, g, c in virt:
        out.extend((op, g * k + i, c) for i in range(min(k, M - g * k)))
    return out


def interleaved_kfkb_order(
    num_stages: int,
    num_microbatches: int,
    k: int,
    num_virtual: int,
    stage: int,
) -> list[tuple[Op, int, int]]:
    """Interleaved (virtual-stage) kFkB order for one device: ``(op, mb, chunk)``.

    Megatron-style looped placement: device ``s`` hosts model chunks
    ``{c * S + s : c in [0, v)}``; the forward of global virtual stage ``j``
    depends on virtual stage ``j - 1`` (device ``(j-1) % S``).  The base
    order is Megatron's interleaved 1F1B over ``G = M/k`` groups (see
    :func:`_interleaved_virtual_order`), then every group op is expanded
    into its ``k`` FIFO members.

    Requires ``k | M`` and ``S | G`` (Megatron's divisibility constraint).
    """
    S, M, v, s = num_stages, num_microbatches, num_virtual, stage
    G = _interleaved_groups(S, M, k, v)
    return _expand_groups3(_interleaved_virtual_order(S, G, v, s), k, M)


def interleaved_zb_orders(
    num_stages: int,
    num_microbatches: int,
    k: int,
    num_virtual: int,
    extra_warmup: int | Sequence[int] = 0,
) -> list[list[tuple[Op, int, int]]]:
    """Joint interleaved x zero-bubble orders for ALL devices: ``(op, mb, chunk)``.

    The critical stream is exactly Megatron's interleaved 1F1B chunk walk
    (:func:`_interleaved_virtual_order`) with the combined backward narrowed
    to ``BWD_INPUT``; ``BWD_WEIGHT`` tasks are scheduled by a greedy
    lock-step walk that runs them whenever the device would otherwise bubble
    — the next critical task is blocked on a cross-device input that has not
    arrived, or its forward is blocked by the memory cap.  The cap per
    device is the PLAIN interleaved plan's peak live count (an activation is
    allocated at F and freed at its W) plus the per-stage warmup extension
    ``w[s]`` — the "interleaved H2" composition: at ``w == 0`` the plan
    inherits the H1 memory guarantee (peak live never exceeds the equal-
    (k, v) interleaved plan's), and each extra unit lets device ``s`` defer
    one more ``BWD_WEIGHT`` in favour of a forward while its critical chunk
    walk is blocked (the per-device F/B sequence is untouched, so link FIFO
    is preserved by construction).

    Returns one order per device.  Requires ``k | M`` and ``S | (M/k)``.
    """
    S, M, v = num_stages, num_microbatches, num_virtual
    w = normalize_warmup(extra_warmup, S)
    G = _interleaved_groups(S, M, k, v)
    V = S * v
    base = [_interleaved_virtual_order(S, G, v, s) for s in range(S)]
    # memory cap = the plain interleaved plan's peak live groups per device,
    # raised by w[s] (clamped at the device's total group count)
    cap = []
    for s, seq in enumerate(base):
        live = peak = 0
        for op, _, _ in seq:
            live += 1 if op == Op.FWD else -1
            peak = max(peak, live)
        cap.append(min(peak + w[s], G * v))
    ptr = [0] * S
    live = [0] * S
    wq: list[list[tuple[int, int]]] = [[] for _ in range(S)]  # FIFO of (g, c)
    done: dict[tuple[int, int, int, int], int] = {}  # (op, stage, g, chunk) -> tick
    orders: list[list[tuple[Op, int, int]]] = [[] for _ in range(S)]
    total = 3 * G * v * S
    executed = 0
    t = 0
    max_ticks = 8 * total + 16 * V + 32
    while executed < total:
        if t > max_ticks:  # pragma: no cover - defensive
            raise RuntimeError("interleaved_zb_orders failed to converge")
        fired: list[tuple[int, Op, int, int]] = []
        for s in range(S):
            choice: tuple[Op, int, int] | None = None
            if ptr[s] < len(base[s]):
                op, g, c = base[s][ptr[s]]
                vs = c * S + s
                if op == Op.FWD:
                    if live[s] < cap[s]:
                        if vs == 0:
                            choice = (Op.FWD, g, c)
                        else:
                            dep = done.get((int(Op.FWD), (vs - 1) % S, g, (vs - 1) // S))
                            if dep is not None and dep < t:
                                choice = (Op.FWD, g, c)
                else:  # critical backward; its own F precedes it in base order
                    if vs == V - 1:
                        choice = (Op.BWD_INPUT, g, c)
                    else:
                        dep = done.get((int(Op.BWD_INPUT), (vs + 1) % S, g, (vs + 1) // S))
                        if dep is not None and dep < t:
                            choice = (Op.BWD_INPUT, g, c)
            if choice is not None:
                ptr[s] += 1
            elif wq[s]:
                g, c = wq[s].pop(0)
                choice = (Op.BWD_WEIGHT, g, c)
            if choice is not None:
                op, g, c = choice
                orders[s].append(choice)
                if op == Op.FWD:
                    live[s] += 1
                elif op == Op.BWD_INPUT:
                    wq[s].append((g, c))
                else:
                    live[s] -= 1
                if op != Op.BWD_WEIGHT:
                    fired.append((s, op, g, c))
                executed += 1
        for s, op, g, c in fired:
            done[(int(op), s, g, c)] = t
        t += 1
    return [_expand_groups3(o, k, M) for o in orders]


def make_plan(
    num_stages: int,
    num_microbatches: int,
    k: int | None = None,
    micro_batch_size: int = 1,
    name: str = "",
    kind: str = "kfkb",
    num_virtual: int = 1,
    extra_warmup: int | Sequence[int] = 0,
    spec=None,
) -> SchedulePlan:
    """Build a validated :class:`SchedulePlan` of any registered family member.

    The schedule coordinates come from one
    :class:`~repro_torch.core.kinds.ScheduleSpec` via ``spec=`` (the system's one
    coordinate currency), or — for the paper's original two-coordinate
    search — the plain positional ``(k, micro_batch_size)`` form.  The
    family kwargs ``kind=`` / ``num_virtual=`` / ``extra_warmup=`` are
    **deprecated**: they still lower to identical plans but emit
    :class:`DeprecationWarning`, and a test keeps in-repo callers on
    ``spec=``.  ``kind`` must be registered
    in :mod:`repro_torch.core.kinds` (``"1f1b"`` and ``"gpipe"`` are aliases
    that force ``k``); coordinate validation — virtual-degree rules,
    warmup capability, H2's ``w >= 1`` floor — is
    ``ScheduleSpec.resolve``'s, driven by the kind's capability flags.
    """
    from repro_torch.core.kinds import ScheduleSpec, get_kind

    if spec is not None:
        if k is not None or kind != "kfkb" or num_virtual != 1 or extra_warmup:
            raise ValueError("pass either spec= or the legacy schedule kwargs, not both")
        if micro_batch_size != 1:
            raise ValueError("micro_batch_size travels inside spec= when given")
    else:
        w_max = (
            extra_warmup
            if isinstance(extra_warmup, int)
            else max(extra_warmup, default=0)
        )
        if kind != "kfkb" or num_virtual != 1 or w_max:
            warnings.warn(
                "make_plan(kind=..., num_virtual=..., extra_warmup=...) is "
                "deprecated; pass the coordinates as one "
                "spec=ScheduleSpec(kind=..., k=..., num_virtual=..., "
                "extra_warmup=..., micro_batch_size=...)",
                DeprecationWarning,
                stacklevel=2,
            )
        spec = ScheduleSpec(
            kind=kind,
            k=1 if k is None else k,
            num_virtual=num_virtual,
            extra_warmup=extra_warmup,
            micro_batch_size=micro_batch_size,
        )
    spec = spec.resolve(num_stages, num_microbatches)
    kspec = get_kind(spec.kind)
    orders = kspec.build_orders(
        num_stages, num_microbatches, spec.k, spec.num_virtual, spec.extra_warmup
    )
    plan = SchedulePlan(
        num_stages,
        num_microbatches,
        spec.k,
        spec.micro_batch_size,
        orders,
        name,
        kind=spec.kind,
        num_virtual=spec.num_virtual,
        extra_warmup=spec.extra_warmup,
        zb_policy=spec.zb_policy,
    )
    plan.validate()
    assign_slots(plan)
    return plan


# ---------------------------------------------------------------------------
# Slot assignment (exact per-device liveness)
# ---------------------------------------------------------------------------


def _frees_slot(plan: SchedulePlan, op: Op) -> bool:
    """The op that releases a live activation — delegated to the plan
    kind's registry record (W for split-backward kinds: the weight gradient
    still needs the stage input; the combined BWD otherwise)."""
    from repro_torch.core.kinds import get_kind

    return get_kind(plan.kind).frees_slot(op)


def assign_slots(plan: SchedulePlan) -> int:
    """Assign activation buffer slots per device; return the global peak count.

    A forward allocates a slot (the stage input must stay alive until the
    last backward piece that reads it); the freeing op (see
    :func:`_frees_slot`) releases it.  Because each device executes its own
    order sequentially, walking the order gives exact liveness.  For zb
    plans the intermediate ``BWD_INPUT`` is tagged with the live slot (it
    reads the activation without freeing it).
    """
    peak_global = 0
    for s, order in enumerate(plan.orders):
        free: list[int] = []
        next_slot = 0
        live: dict[tuple[int, int], int] = {}  # (mb, chunk) -> slot
        for i, t in enumerate(order):
            if t.op == Op.FWD:
                slot = free.pop() if free else next_slot
                if slot == next_slot:
                    next_slot += 1
                live[(t.mb, t.chunk)] = slot
            elif _frees_slot(plan, t.op):
                slot = live.pop((t.mb, t.chunk))
                free.append(slot)
            elif t.op == Op.BWD_INPUT:
                slot = live[(t.mb, t.chunk)]
            else:
                slot = -1
            order[i] = dataclasses.replace(t, slot=slot)
        assert not live, f"device {s}: activations leaked: {live}"
        peak_global = max(peak_global, next_slot)
    return peak_global


def peak_live_activations(plan: SchedulePlan) -> list[int]:
    """Per-device peak number of simultaneously-live forward activations.

    For interleaved plans this counts across all chunks hosted by the
    device; for zb plans an activation is live until its ``BWD_WEIGHT``
    (the weight gradient still reads the stage input).
    """
    peaks = []
    for order in plan.orders:
        live = 0
        peak = 0
        for t in order:
            if t.op == Op.FWD:
                live += 1
                peak = max(peak, live)
            elif _frees_slot(plan, t.op):
                live -= 1
        peaks.append(peak)
    return peaks


# ---------------------------------------------------------------------------
# TabularPlan: the lock-step table + exact send/recv edges
# ---------------------------------------------------------------------------

_GRID_IDLE = (int(Op.IDLE), -1, -1, -1)


@dataclasses.dataclass(frozen=True)
class PlanEdge:
    """One exact cross-device transfer: the output of ``(op, src_stage, mb,
    src_chunk)`` executed at ``send_tick`` is consumed by ``dst_stage`` at
    ``recv_tick`` (FWD activations move to the next virtual stage, BWD /
    BWD_INPUT gradients to the previous one)."""

    src_stage: int
    dst_stage: int
    op: Op
    mb: int
    src_chunk: int
    dst_chunk: int
    send_tick: int
    recv_tick: int

    @property
    def is_forward(self) -> bool:
        return self.op == Op.FWD


@dataclasses.dataclass
class TabularPlan:
    """The unified lowering target of every plan builder.

    ``grid[s, t] = (op, mb, chunk, slot)`` — device ``s`` executes at most
    one task per tick; ``edges`` lists every cross-device send/recv pair
    with exact ticks.  Semantics: data produced at tick ``t`` is consumable
    at tick ``t + 1`` or later (one ppermute pair per tick in the real
    engine).
    """

    plan: SchedulePlan
    grid: np.ndarray  # [S, T, 4] int32
    edges: list[PlanEdge]

    @property
    def num_stages(self) -> int:
        return self.plan.num_stages

    @property
    def num_ticks(self) -> int:
        return int(self.grid.shape[1])

    def validate(self) -> None:
        """Dependency validity and FIFO-per-link invariants.

        * every cross-device consumption is matched by exactly one edge
          whose send strictly precedes its recv,
        * per directed link, sends and recvs are FIFO-consistent (the i-th
          send is the i-th recv — what the engine's ring queues require),
        * intra-device streams execute in FIFO micro-batch order per
          (op, chunk).
        """
        plan = self.plan
        exec_tick: dict[tuple[int, int, int, int], int] = {}
        for s in range(self.num_stages):
            stream_last: dict[tuple[int, int], int] = {}
            for t in range(self.num_ticks):
                op, mb, chunk, _ = (int(v) for v in self.grid[s, t])
                if op == int(Op.IDLE):
                    continue
                key = (op, s, mb, chunk)
                assert key not in exec_tick, f"task executed twice: {key}"
                exec_tick[key] = t
                last = stream_last.get((op, chunk), -1)
                assert mb > last, f"stream not FIFO at device {s}: {key}"
                stream_last[(op, chunk)] = mb
        by_consumer = {
            (int(e.op), e.dst_stage, e.mb, e.dst_chunk, e.src_stage, e.src_chunk): e
            for e in self.edges
        }
        assert len(by_consumer) == len(self.edges), "duplicate edges"
        n_expected = 0
        for key, t in exec_tick.items():
            op, s, mb, chunk = key
            deps = _chain_deps(plan, Op(op), s, chunk)
            for dep_op, dep_s, dep_c in deps:
                dep_key = (int(dep_op), dep_s, mb, dep_c)
                assert dep_key in exec_tick, f"missing producer for {key}"
                assert exec_tick[dep_key] < t, f"recv at {t} not after send for {key}"
                if dep_s == s:
                    # same-device chain hop (ZB-V's turn): ordered by the
                    # device's own sequential execution, never a transfer
                    continue
                e = by_consumer.get((int(dep_op), s, mb, chunk, dep_s, dep_c))
                assert e is not None, f"missing edge for {key} <- {dep_key}"
                assert e.send_tick == exec_tick[dep_key] and e.recv_tick == t
                n_expected += 1
        assert n_expected == len(self.edges), "stray edges"
        # FIFO per directed link: sends ordered by tick must meet recvs in order
        links: dict[tuple[int, int, bool], list[PlanEdge]] = {}
        for e in self.edges:
            links.setdefault((e.src_stage, e.dst_stage, e.is_forward), []).append(e)
        for es in links.values():
            es = sorted(es, key=lambda e: e.send_tick)
            recvs = [e.recv_tick for e in es]
            assert recvs == sorted(recvs), "link not FIFO-consistent"


def _chain_deps(
    plan: SchedulePlan, op: Op, stage: int, chunk: int
) -> list[tuple[Op, int, int]]:
    """Virtual-stage-chain producers (op, stage, chunk) that ``(op, stage,
    mb, chunk)`` waits on, in the plan's placement: the forward of virtual
    stage ``j`` consumes ``j - 1``'s output, the critical backward
    ``j + 1``'s.  Includes SAME-device producers (e.g. ZB-V's intra-device
    turn) — callers that want transfers filter those out."""
    pl = plan.placement
    V = plan.total_virtual_stages
    vs = int(pl.vstage_of[stage, chunk])
    deps: list[tuple[Op, int, int]] = []
    if op == Op.FWD and vs > 0:
        deps.append((Op.FWD, int(pl.device_of[vs - 1]), int(pl.chunk_of[vs - 1])))
    elif op in _BWD_CRITICAL and vs < V - 1:
        deps.append((op, int(pl.device_of[vs + 1]), int(pl.chunk_of[vs + 1])))
    return deps


def _cross_deps(
    plan: SchedulePlan, op: Op, stage: int, chunk: int, mb: int = -1
) -> list[tuple[Op, int, int]]:
    """Cross-DEVICE producers only: :func:`_chain_deps` minus same-device
    pairs (those are enforced by the device's own sequential order and are
    not transfers — the kFkB chain never has any; ZB-V's turn does)."""
    return [d for d in _chain_deps(plan, op, stage, chunk) if d[1] != stage]


def lower_to_table(plan: SchedulePlan) -> TabularPlan:
    """Greedy lock-step lowering of ANY plan to its :class:`TabularPlan`.

    Each tick every device executes at most one task; a task is eligible at
    tick ``t`` iff it is the device's next unexecuted task in plan order
    (in-order, as the paper's runtime) and every cross-device input was
    produced at some tick ``< t`` (intra-device inputs are guaranteed by
    plan order).  Exact send/recv edges are recorded as tasks fire.
    """
    S = plan.num_stages
    ptr = [0] * S
    done_tick: dict[tuple[int, int, int, int], int] = {}
    rows: list[list[tuple[int, int, int, int]]] = [[] for _ in range(S)]
    edges: list[PlanEdge] = []
    t = 0
    total = sum(len(o) for o in plan.orders)
    executed = 0
    max_ticks = 4 * total + 8 * S * plan.num_virtual + 16
    while executed < total:
        if t > max_ticks:
            raise RuntimeError("lower_to_table failed to converge — malformed plan")
        fired_this_tick: list[Task] = []
        for s in range(S):
            if ptr[s] >= len(plan.orders[s]):
                rows[s].append(_GRID_IDLE)
                continue
            task = plan.orders[s][ptr[s]]
            deps = _cross_deps(plan, task.op, s, task.chunk, task.mb)
            ready = True
            for dep_op, dep_s, dep_c in deps:
                dep = done_tick.get((int(dep_op), dep_s, task.mb, dep_c))
                if dep is None or dep >= t:
                    ready = False
                    break
            if ready:
                rows[s].append((int(task.op), task.mb, task.chunk, task.slot))
                for dep_op, dep_s, dep_c in deps:
                    edges.append(
                        PlanEdge(
                            src_stage=dep_s,
                            dst_stage=s,
                            op=Op(dep_op),
                            mb=task.mb,
                            src_chunk=dep_c,
                            dst_chunk=task.chunk,
                            send_tick=done_tick[(int(dep_op), dep_s, task.mb, dep_c)],
                            recv_tick=t,
                        )
                    )
                fired_this_tick.append(task)
                ptr[s] += 1
                executed += 1
            else:
                rows[s].append(_GRID_IDLE)
        # completion times are committed only after the whole tick resolves
        for task in fired_this_tick:
            done_tick[task.key()] = t
        t += 1
    grid = np.asarray(rows, dtype=np.int32)
    return TabularPlan(plan=plan, grid=grid, edges=edges)


# ---------------------------------------------------------------------------
# Back-compat shims: the legacy [S, T, 3] tick table
# ---------------------------------------------------------------------------


def tick_table(plan: SchedulePlan) -> np.ndarray:
    """Legacy view of :func:`lower_to_table`: ``[S, T, 3]`` of (op, mb, slot).

    Kept for callers that predate :class:`TabularPlan` (chunk is dropped —
    only meaningful for non-interleaved plans)."""
    return plan.lower().grid[:, :, [0, 1, 3]]


def tick_table_stats(table: np.ndarray) -> dict[str, float]:
    """Bubble fraction & length of a tick table (unit-cost reference)."""
    S, T, _ = table.shape
    busy = int((table[:, :, 0] != int(Op.IDLE)).sum())
    return {
        "ticks": float(T),
        "busy": float(busy),
        "bubble_fraction": 1.0 - busy / float(S * T),
    }
