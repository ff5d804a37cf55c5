"""Pluggable schedule-kind registry: one :class:`KindSpec` per family member.

A copy of ``repro/core/kinds.py`` for the port (it imports nothing of
``repro``); ``tests/test_torch_schedule.py`` holds the registry and the
plans it builds equal to the original's.  A schedule kind is ONE registered
record that owns what the rest of the system needs to know about it:

* ``build_orders``     -- the order builder (per-device :class:`Task` lists),
* ``peak_live_groups`` -- the closed-form peak-live count per stage (group
  space), the builder's memory contract,
* ``frees_slot``       -- which op releases a live activation slot,
* capability flags     -- ``supports_virtual`` / ``fixed_virtual``,
  ``supports_extra_warmup`` / ``requires_warmup``, ``has_split_backward``,
  ``supports_saved_residual``, ``weight_placement_refinable``,
  ``peak_is_exact``, ...,
* ``virtual_stage``    -- the device placement map (``None`` = Megatron's
  looped ``chunk * S + stage``; ZB-V overrides it with the V shape),
* ``search_specs``     -- the search-axis enumerator ``enumerate_candidates``
  calls.

Everything outside this module and ``schedule.py`` dispatches through the
registry; ``tests/test_torch_schedule.py`` scans the port for kind-string
dispatch.  All six kinds of the original are registered (``kfkb``,
``zb_h1``, ``zb_h2``, ``interleaved``, ``interleaved_zb``, ``zbv``) with
the aliases ``1f1b`` and ``gpipe``: the port's reference engine executes
every kind.

The two declarative currencies of the API live here too:
:class:`ScheduleSpec`, the frozen coordinate tuple ``make_plan``,
``Candidate``, ``TuningRecord``, the compile-cache key and ``PlanRuntime``
pass between them, and :class:`SearchSpace`, the candidate-enumeration axes
``enumerate_candidates(space=...)`` consumes (each kind's ``search_specs``,
priced on the memory-limit curve by :func:`admissible_warmup` and
:func:`saved_residual_policy`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core import schedule as _sched
from repro_torch.core.schedule import Op, Task, normalize_warmup, normalize_zb_policy

__all__ = [
    "ScheduleSpec",
    "SearchSpace",
    "KindSpec",
    "register_kind",
    "register_alias",
    "get_kind",
    "registered_kinds",
    "known_kinds",
    "resolve_alias",
    "admissible_warmup",
    "saved_residual_kinds",
    "saved_residual_policy",
    "zbv_orders",
]


# ---------------------------------------------------------------------------
# The declarative currencies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """The one schedule-coordinate currency of the whole system.

    Hashable once normalized (``extra_warmup`` a tuple), so it can key the
    compiled-step cache directly.  ``resolve`` folds the ``"1f1b"`` /
    ``"gpipe"`` aliases, coerces a fixed virtual degree (ZB-V always runs
    2 chunks/device) and normalizes ``extra_warmup`` to the per-stage
    vector ``w[s]``.
    """

    kind: str = "kfkb"
    k: int = 1
    num_virtual: int = 1
    extra_warmup: int | tuple[int, ...] = 0
    micro_batch_size: int = 1
    # split-backward kinds only: per-stage BWD_WEIGHT policy
    # ("double_remat" | "saved_residual"); a scalar broadcasts on resolve.
    zb_policy: str | tuple[str, ...] = "double_remat"

    def resolve(self, num_stages: int, num_microbatches: int) -> "ScheduleSpec":
        kind, k = resolve_alias(self.kind, self.k, num_microbatches)
        spec = get_kind(kind)  # fail-closed on unknown kinds
        v = self.num_virtual
        if spec.fixed_virtual is not None:
            if v not in (1, spec.fixed_virtual):
                raise ValueError(
                    f"kind {kind!r} runs exactly {spec.fixed_virtual} chunks per "
                    f"device (got num_virtual={v})"
                )
            v = spec.fixed_virtual
        elif not spec.supports_virtual and v != 1:
            raise ValueError(f"num_virtual > 1 requires an interleaved kind, got {kind!r}")
        w = normalize_warmup(self.extra_warmup, num_stages)
        if max(w) > 0 and not spec.supports_extra_warmup:
            raise ValueError(
                f"extra_warmup > 0 requires a warmup-capable kind "
                f"(one of {warmup_kinds()}), got {kind!r}"
            )
        if spec.requires_warmup and max(w) < 1:
            raise ValueError(
                f"kind={kind!r} needs extra_warmup >= 1 at some stage "
                f"(got {self.extra_warmup}); extra_warmup == 0 is exactly zb_h1"
            )
        pol = normalize_zb_policy(self.zb_policy, num_stages)
        if any(p == "saved_residual" for p in pol) and not spec.supports_saved_residual:
            raise ValueError(
                f"zb_policy='saved_residual' requires a split-backward kind "
                f"with the saved-residual BWD_WEIGHT path "
                f"(one of {saved_residual_kinds()}), got {kind!r}"
            )
        return ScheduleSpec(kind, k, v, w, self.micro_batch_size, zb_policy=pol)

    @classmethod
    def from_plan(cls, plan) -> "ScheduleSpec":
        """The (already normalized) coordinates of a built plan."""
        return cls(
            kind=plan.kind,
            k=plan.k,
            num_virtual=plan.num_virtual,
            extra_warmup=tuple(plan.extra_warmup),
            micro_batch_size=plan.micro_batch_size,
            zb_policy=tuple(plan.zb_policy),
        )


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Declarative candidate-enumeration axes for ``enumerate_candidates``.

    ``kinds`` may name registered kinds or aliases; ``virtual_degrees``
    lists the chunk counts tried for kinds with a searchable virtual axis;
    warmup-capable kinds price their per-stage ``w[s]`` greedily under the
    memory-limit curve (``max_extra_warmup`` caps the depth, default
    ``S - 1``).
    """

    kinds: tuple[str, ...] = ("kfkb",)
    virtual_degrees: tuple[int, ...] = (2,)
    max_k: int | None = None
    min_microbatches: int | None = None
    max_extra_warmup: int | None = None
    # BWD_WEIGHT policies to explore on saved-residual-capable kinds.  With
    # "saved_residual" present, each such kind additionally emits (per
    # (k, b)) a per-stage greedy DR/SR vector: saved_residual wherever the
    # stage's memory-limit admits the residual surcharge, double_remat
    # elsewhere (see :func:`saved_residual_policy`).
    zb_policies: tuple[str, ...] = ("double_remat",)

    def __post_init__(self) -> None:
        object.__setattr__(self, "kinds", tuple(self.kinds))
        object.__setattr__(self, "virtual_degrees", tuple(self.virtual_degrees))
        object.__setattr__(self, "zb_policies", tuple(self.zb_policies))


# ---------------------------------------------------------------------------
# KindSpec + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KindSpec:
    """Everything the system knows about one schedule kind.

    ``build_orders(S, M, k, num_virtual, w_vec)`` returns the per-device
    ordered :class:`Task` lists; ``peak_live_groups(S, G, v, w_vec)`` the
    per-stage peak live count in GROUP space (the builder's memory
    contract — an upper bound always, an equality at uniform ``w`` when
    ``peak_is_exact``); ``virtual_stage(stage, chunk, S, v)`` the placement
    map (``None`` = looped ``chunk * S + stage``).
    """

    name: str
    build_orders: Callable[[int, int, int, int, tuple[int, ...]], list[list[Task]]]
    peak_live_groups: Callable[[int, int, int, tuple[int, ...]], list[int]]
    supports_virtual: bool = False
    fixed_virtual: int | None = None
    supports_extra_warmup: bool = False
    requires_warmup: bool = False
    has_split_backward: bool = False
    # the kind's BWD_WEIGHT accepts zb_policy="saved_residual" (both engines
    # thread B's vjp residuals through the live slot instead of
    # rematerializing).  Only meaningful with has_split_backward.
    supports_saved_residual: bool = False
    weight_placement_refinable: bool = False
    peak_is_exact: bool = False
    needs_group_multiple_of_stages: bool = False
    # the paper's original (k, b)-only search family: plans may be built
    # through legacy positional plan factories (no kind/virtual/warmup kwargs)
    legacy_factory: bool = False
    virtual_stage: Callable[[int, int, int, int], int] | None = None
    label: Callable[[str, int, str, int], str] | None = None
    search_specs_fn: Callable[..., list[ScheduleSpec]] | None = None

    def frees_slot(self, op: Op) -> bool:
        """The op that releases a live activation slot at a device: the
        weight gradient for split-backward (zero-bubble) kinds — it still
        reads the stage input — the combined backward otherwise."""
        return op == (Op.BWD_WEIGHT if self.has_split_backward else Op.BWD)

    def plan_label(self, base: str, v: int, wtag: str, max_w: int) -> str:
        if self.label is None:
            return base
        return self.label(base, v, wtag, max_w)

    def virtual_axis(self, virtual_degrees: Sequence[int]) -> tuple[int, ...]:
        """The kind's searchable virtual-degree axis: pinned for
        fixed-virtual kinds (ZB-V), the caller's degrees for interleaved
        kinds, the degenerate ``(1,)`` otherwise."""
        if self.fixed_virtual is not None:
            return (self.fixed_virtual,)
        if self.supports_virtual:
            return tuple(virtual_degrees)
        return (1,)

    def search_specs(
        self,
        *,
        num_stages: int,
        num_microbatches: int,
        k: int,
        micro_batch_size: int,
        virtual_degrees: Sequence[int],
        memory_model,
        limits: Sequence[float],
        max_extra_warmup: int,
        zb_policies: Sequence[str] = ("double_remat",),
    ) -> list[ScheduleSpec]:
        """The kind's search points at one ``(k, b)`` — the axis enumerator
        ``enumerate_candidates`` consumes.  Flags drive the default: the
        virtual axis comes from ``virtual_degrees`` (or is pinned), and
        warmup-capable kinds take the greedily-priced ``w[s]`` (a
        warmup-REQUIRING kind yields nothing when no stage admits
        ``w = 1`` — that is the tuner's H1 fallback).  When the caller's
        ``zb_policies`` include ``"saved_residual"`` and the kind supports
        it, each virtual degree also emits the per-stage greedy DR/SR
        variant (when at least one stage admits the residual surcharge) —
        its warmup is re-priced under the fattened slot curve."""
        if self.search_specs_fn is not None:
            return self.search_specs_fn(
                self,
                num_stages=num_stages,
                num_microbatches=num_microbatches,
                k=k,
                micro_batch_size=micro_batch_size,
                virtual_degrees=virtual_degrees,
                memory_model=memory_model,
                limits=limits,
                max_extra_warmup=max_extra_warmup,
            )
        want_sr = (
            "saved_residual" in tuple(zb_policies) and self.supports_saved_residual
        )
        out: list[ScheduleSpec] = []
        for v in self.virtual_axis(virtual_degrees):
            w: tuple[int, ...] = (0,) * num_stages
            if self.supports_extra_warmup:
                w = admissible_warmup(
                    self, num_stages, num_microbatches, k, micro_batch_size, v,
                    memory_model, limits, max_extra_warmup,
                )
                if self.requires_warmup and max(w) < 1:
                    continue
            out.append(
                ScheduleSpec(self.name, k, v, w, micro_batch_size)
            )
            if not want_sr:
                continue
            pol = saved_residual_policy(
                self, num_stages, num_microbatches, k, micro_batch_size, v,
                memory_model, limits,
            )
            if "saved_residual" not in pol:
                continue  # no stage affords the residuals at this (k, b)
            w_sr = w
            if self.supports_extra_warmup:
                w_sr = admissible_warmup(
                    self, num_stages, num_microbatches, k, micro_batch_size, v,
                    memory_model, limits, max_extra_warmup, zb_policy=pol,
                )
                if self.requires_warmup and max(w_sr) < 1:
                    continue
            out.append(
                ScheduleSpec(self.name, k, v, w_sr, micro_batch_size, zb_policy=pol)
            )
        return out


_REGISTRY: dict[str, KindSpec] = {}
#: alias -> (kind, forced_k(M)); e.g. "gpipe" pins k = M on the kfkb builder
_ALIASES: dict[str, Callable[[int], tuple[str, int]]] = {}


def register_kind(spec: KindSpec) -> KindSpec:
    if spec.name in _REGISTRY or spec.name in _ALIASES:
        raise ValueError(f"schedule kind {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def register_alias(name: str, resolve: Callable[[int], tuple[str, int]]) -> None:
    if name in _REGISTRY or name in _ALIASES:
        raise ValueError(f"schedule kind {name!r} already registered")
    _ALIASES[name] = resolve


def get_kind(kind: str) -> KindSpec:
    """Fail-closed lookup: an unregistered kind is a loud error naming the
    registered kinds, never a silent fall-through."""
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown schedule kind {kind!r}; registered kinds: "
            f"{registered_kinds()} (aliases: {tuple(_ALIASES)})"
        ) from None


def registered_kinds() -> tuple[str, ...]:
    """All registered kinds, in registration order (``PLAN_KINDS`` view)."""
    return tuple(_REGISTRY)


def known_kinds() -> tuple[str, ...]:
    """Registered kinds plus aliases — the full set ``enumerate_candidates``
    and ``make_plan`` accept."""
    return tuple(_REGISTRY) + tuple(_ALIASES)


def resolve_alias(kind: str, k: int, num_microbatches: int) -> tuple[str, int]:
    if kind in _ALIASES:
        return _ALIASES[kind](num_microbatches)
    return kind, k


def warmup_kinds() -> tuple[str, ...]:
    return tuple(n for n, s in _REGISTRY.items() if s.supports_extra_warmup)


def saved_residual_kinds() -> tuple[str, ...]:
    """Kinds whose BWD_WEIGHT accepts ``zb_policy="saved_residual"``."""
    return tuple(n for n, s in _REGISTRY.items() if s.supports_saved_residual)


def saved_residual_policy(
    spec: KindSpec,
    num_stages: int,
    num_microbatches: int,
    k: int,
    micro_batch_size: int,
    num_virtual: int,
    memory_model,
    limits: Sequence[float],
) -> tuple[str, ...]:
    """Greedy per-stage DR/SR vector on the memory-limit curve.

    A stage takes ``"saved_residual"`` iff its zero-extra-warmup peak live
    count still fits ``limits[s]`` under the residual-fattened slot price
    (:meth:`MemoryModel.bytes_at_live` with ``policy="saved_residual"``),
    ``"double_remat"`` otherwise — memory the limit curve already affords
    is spent on skipping W's rematerialization, mirroring how
    :func:`admissible_warmup` spends it on warmup depth."""
    S, M, b = num_stages, num_microbatches, micro_batch_size
    G = (M + k - 1) // k
    base = spec.peak_live_groups(S, G, num_virtual, (0,) * S)
    out = []
    for s in range(S):
        live = min(base[s] * k, M * num_virtual)
        try:
            fits = (
                memory_model.bytes_at_live(s, b, live, True, policy="saved_residual")
                <= limits[s]
            )
        except ValueError:
            # checkpoint_policy="full": residuals are already resident, the
            # model rejects the redundant policy -> never choose it
            fits = False
        out.append("saved_residual" if fits else "double_remat")
    return tuple(out)


def admissible_warmup(
    spec: KindSpec,
    num_stages: int,
    num_microbatches: int,
    k: int,
    micro_batch_size: int,
    num_virtual: int,
    memory_model,
    limits: Sequence[float],
    max_extra_warmup: int,
    zb_pricing: bool | None = None,
    zb_policy: Sequence[str] | None = None,
) -> tuple[int, ...]:
    """Greedy per-stage warmup vector on the memory-limit curve.

    Peak bytes at a stage are monotone in its own ``w[s]`` and independent
    of every other stage's (each builder caps issuance per stage), so each
    stage independently takes the largest ``w[s] <= max_extra_warmup``
    whose predicted peak live count still fits ``limits[s]``, closed-form
    via the kind's ``peak_live_groups`` — no plan is built per probe.
    ``zb_pricing`` overrides which slot byte curve is walked (default:
    the kind's own ``has_split_backward``); ``zb_policy`` prices each
    stage's slots under its per-stage BWD_WEIGHT policy (saved_residual
    stages pay the residual surcharge, so they admit shallower warmup)."""
    S, M, b = num_stages, num_microbatches, micro_batch_size
    zb = spec.has_split_backward if zb_pricing is None else zb_pricing
    pol = None if zb_policy is None else normalize_zb_policy(tuple(zb_policy), S)
    G = (M + k - 1) // k
    prev = spec.peak_live_groups(S, G, num_virtual, (0,) * S)
    out = []
    for s in range(S):
        w_s = 0
        prev_groups = prev[s]
        for w in range(1, max_extra_warmup + 1):
            groups = spec.peak_live_groups(S, G, num_virtual, (w,) * S)[s]
            if groups == prev_groups:
                break  # clamped at the group budget: deeper w buys nothing
            live = min(groups * k, M * num_virtual)
            bytes_s = memory_model.bytes_at_live(
                s, b, live, zb, policy=None if pol is None else pol[s]
            )
            if bytes_s > limits[s]:
                break
            w_s = w
            prev_groups = groups
        out.append(w_s)
    return tuple(out)


# ---------------------------------------------------------------------------
# The family registrations (builders live in repro_torch.core.schedule)
# ---------------------------------------------------------------------------


def _kfkb_build(S, M, k, v, w):
    return [
        [Task(op, s, mb) for op, mb in _sched.kfkb_order(S, M, k, s)]
        for s in range(S)
    ]


def _zb_build(S, M, k, v, w):
    raws = _sched.zb_orders(S, M, k, extra_warmup=w)
    return [[Task(op, s, mb) for op, mb in raw] for s, raw in enumerate(raws)]


def _interleaved_build(S, M, k, v, w):
    return [
        [
            Task(op, s, mb, chunk)
            for op, mb, chunk in _sched.interleaved_kfkb_order(S, M, k, v, s)
        ]
        for s in range(S)
    ]


def _interleaved_zb_build(S, M, k, v, w):
    raws = _sched.interleaved_zb_orders(S, M, k, v, extra_warmup=w)
    return [
        [Task(op, s, mb, chunk) for op, mb, chunk in raw]
        for s, raw in enumerate(raws)
    ]


def _peak_1f1b(S, G, v, w):
    return [min(S - s, G) for s in range(S)]


def _peak_zb_h2(S, G, v, w):
    return [min(min(S - s, G) + w[s], G) for s in range(S)]


def _peak_interleaved(S, G, v, w):
    return [min(2 * (S - s - 1) + (v - 1) * S + 1 + w[s], G * v) for s in range(S)]


register_kind(
    KindSpec(
        name="kfkb",
        build_orders=_kfkb_build,
        peak_live_groups=_peak_1f1b,
        peak_is_exact=True,
        legacy_factory=True,
    )
)
register_kind(
    KindSpec(
        name="zb_h1",
        build_orders=_zb_build,
        peak_live_groups=_peak_1f1b,
        has_split_backward=True,
        supports_saved_residual=True,
        weight_placement_refinable=True,
        peak_is_exact=True,
        label=lambda base, v, wtag, max_w: f"ZB-H1[{base}]",
    )
)
register_kind(
    KindSpec(
        name="zb_h2",
        build_orders=_zb_build,
        peak_live_groups=_peak_zb_h2,
        supports_extra_warmup=True,
        requires_warmup=True,
        has_split_backward=True,
        supports_saved_residual=True,
        weight_placement_refinable=True,
        peak_is_exact=True,
        label=lambda base, v, wtag, max_w: f"ZB-H2+{wtag}[{base}]",
    )
)
register_kind(
    KindSpec(
        name="interleaved",
        build_orders=_interleaved_build,
        peak_live_groups=_peak_interleaved,
        supports_virtual=True,
        needs_group_multiple_of_stages=True,
        peak_is_exact=True,
        label=lambda base, v, wtag, max_w: f"I{v}[{base}]",
    )
)
register_kind(
    KindSpec(
        name="interleaved_zb",
        build_orders=_interleaved_zb_build,
        peak_live_groups=_peak_interleaved,
        supports_virtual=True,
        supports_extra_warmup=True,
        needs_group_multiple_of_stages=True,
        has_split_backward=True,
        supports_saved_residual=True,
        weight_placement_refinable=True,
        label=lambda base, v, wtag, max_w: (
            f"I{v}ZB+{wtag}[{base}]" if max_w else f"I{v}ZB[{base}]"
        ),
    )
)
register_alias("1f1b", lambda M: ("kfkb", 1))
register_alias("gpipe", lambda M: ("kfkb", M))


# ---------------------------------------------------------------------------
# ZB-V: the first registry-only family member
# ---------------------------------------------------------------------------
#
# "Pipeline Parallelism with Controllable Memory" (Qi et al. 2024): each
# device owns exactly TWO model chunks in MIRRORED (V-shaped) order —
# device ``s`` hosts virtual stages ``s`` (descending leg) and
# ``2S - 1 - s`` (ascending leg), so the pipeline turn at virtual stage
# ``S - 1 -> S`` is INTRA-device and the backward chain reaches device
# ``S - 1`` only one virtual hop after its own forward.  That mirrored
# return is what makes the peak CONTROLLABLE: a uniform cap of ``2S``
# chunk-slots per device (``+ w[s]``) already runs the V at ~zero bubble —
# roughly HALF the plain-interleaved peak of ``3S - 2s - 1 + S`` at the
# worst device, where Megatron's looped placement forces the deep
# ``2(S - s - 1) + S + 1`` warmup — while the B/W split fills the
# remaining stalls with weight-gradient work.


def _zbv_vstage(stage: int, chunk: int, S: int, v: int) -> int:
    return stage if chunk == 0 else 2 * S - 1 - stage


def zbv_orders(
    num_stages: int,
    num_microbatches: int,
    k: int = 1,
    extra_warmup: int | Sequence[int] = 0,
) -> list[list[tuple[Op, int, int]]]:
    """V-shaped zero-bubble orders for ALL devices: ``(op, mb, chunk)``.

    Greedy lock-step walk per device with priority ``B > F(chunk 1) >
    F(chunk 0) > W``:

    * the single critical backward chain per group descends virtual stages
      ``2S-1 -> 0`` (down the ascending leg, then back up the descending
      one), and a ready ``BWD_INPUT`` always wins — it never needs a new
      slot;
    * forwards allocate slots under the hard per-device cap ``L[s] =
      min(2S + w[s], 2G)`` — ``2S`` chunk-slots is the V schedule's
      zero-bubble operating point (each device keeps both legs of ``~S``
      groups in flight; the chain returns to a device at most ``2S - 1``
      virtual hops after leaving it), and every ``w[s]`` unit buys one
      more — while the descending-leg chunk is additionally held to
      ``L[s] - 2`` in-flight so the turn's ascending-leg forward (which
      unblocks the whole backward chain) can never be starved of a slot —
      the deadlock-freedom reserve;
    * ``BWD_WEIGHT`` runs exactly when the device would otherwise bubble,
      freeing the oldest retired slot (per-chunk FIFO by construction).

    Grouping expands every group-level op into its ``k`` FIFO members, as
    for every other family member.  Peak live activations per device are
    bounded by ``L[s]`` by construction — the kind's registered
    ``peak_live_groups`` row.
    """
    S, M = num_stages, num_microbatches
    w = normalize_warmup(extra_warmup, S)
    G = (M + k - 1) // k
    V = 2 * S
    cap = [min(2 * S + w[s], 2 * G) for s in range(S)]
    c0_cap = [max(1, cap[s] - 2) for s in range(S)]
    dev_of = [u if u < S else 2 * S - 1 - u for u in range(V)]
    next_f = [[0, 0] for _ in range(S)]
    next_b = [[0, 0] for _ in range(S)]
    live = [0] * S
    live_c0 = [0] * S
    wq: list[list[tuple[int, int]]] = [[] for _ in range(S)]  # FIFO of (g, chunk)
    done: dict[tuple[int, int, int], int] = {}  # (op, vstage, g) -> tick
    orders: list[list[tuple[Op, int, int]]] = [[] for _ in range(S)]
    total = 6 * G * S
    executed = 0
    t = 0
    max_ticks = 8 * total + 32 * S + 64

    def vs_of(s: int, c: int) -> int:
        return _zbv_vstage(s, c, S, 2)

    def fwd_ready(s: int, c: int) -> bool:
        g = next_f[s][c]
        if g >= G or live[s] >= cap[s]:
            return False
        if c == 0 and live_c0[s] >= c0_cap[s]:
            return False
        vs = vs_of(s, c)
        if vs == 0:
            return True
        dep = done.get((int(Op.FWD), vs - 1, g))
        return dep is not None and dep < t

    def bwd_ready(s: int, c: int) -> bool:
        g = next_b[s][c]
        if g >= G or g >= next_f[s][c]:
            return False
        vs = vs_of(s, c)
        dep = done.get((int(Op.FWD), vs, g))
        if dep is None or dep >= t:
            return False
        if vs == V - 1:
            return True
        dep = done.get((int(Op.BWD_INPUT), vs + 1, g))
        return dep is not None and dep < t

    while executed < total:
        if t > max_ticks:  # pragma: no cover - defensive
            raise RuntimeError("zbv_orders failed to converge")
        fired: list[tuple[int, Op, int, int]] = []
        for s in range(S):
            choice: tuple[Op, int, int] | None = None
            ready_b = [c for c in (0, 1) if bwd_ready(s, c)]
            if ready_b:
                c = min(ready_b, key=lambda c: (next_b[s][c], -vs_of(s, c)))
                choice = (Op.BWD_INPUT, next_b[s][c], c)
            elif fwd_ready(s, 1):
                choice = (Op.FWD, next_f[s][1], 1)
            elif fwd_ready(s, 0):
                choice = (Op.FWD, next_f[s][0], 0)
            elif wq[s]:
                g, c = wq[s].pop(0)
                choice = (Op.BWD_WEIGHT, g, c)
            if choice is not None:
                op, g, c = choice
                orders[s].append(choice)
                if op == Op.FWD:
                    next_f[s][c] += 1
                    live[s] += 1
                    live_c0[s] += 1 if c == 0 else 0
                elif op == Op.BWD_INPUT:
                    next_b[s][c] += 1
                    wq[s].append((g, c))
                else:
                    live[s] -= 1
                    live_c0[s] -= 1 if c == 0 else 0
                if op != Op.BWD_WEIGHT:
                    fired.append((s, op, g, c))
                executed += 1
        for s, op, g, c in fired:
            done[(int(op), vs_of(s, c), g)] = t
        t += 1
    return [_sched._expand_groups3(o, k, M) for o in orders]


def _zbv_build(S, M, k, v, w):
    raws = zbv_orders(S, M, k, extra_warmup=w)
    return [
        [Task(op, s, mb, chunk) for op, mb, chunk in raw]
        for s, raw in enumerate(raws)
    ]


def _peak_zbv(S, G, v, w):
    return [min(2 * S + w[s], 2 * G) for s in range(S)]


register_kind(
    KindSpec(
        name="zbv",
        build_orders=_zbv_build,
        peak_live_groups=_peak_zbv,
        fixed_virtual=2,
        supports_extra_warmup=True,
        has_split_backward=True,
        supports_saved_residual=True,
        weight_placement_refinable=True,
        virtual_stage=_zbv_vstage,
        label=lambda base, v, wtag, max_w: (
            f"ZB-V+{wtag}[{base}]" if max_w else f"ZB-V[{base}]"
        ),
    )
)
