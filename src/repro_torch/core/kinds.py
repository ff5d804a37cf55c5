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
  ``supports_saved_residual``, ``peak_is_exact``,
* ``virtual_stage``    -- the device placement map (``None`` = Megatron's
  looped ``chunk * S + stage``; ZB-V overrides it with the V shape).

Everything outside this module and ``schedule.py`` dispatches through the
registry; ``tests/test_torch_schedule.py`` scans the port for kind-string
dispatch.  All six kinds of the original are registered (``kfkb``,
``zb_h1``, ``zb_h2``, ``interleaved``, ``interleaved_zb``, ``zbv``) with
the aliases ``1f1b`` and ``gpipe``: the port's reference engine executes
every kind.

:class:`ScheduleSpec` is the schedule-coordinate currency ``make_plan``
takes.  The tuner's parts of the original (``SearchSpace``, the search-axis
enumerator and the memory-curve pricers behind it) come with the tuner.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core import schedule as _sched
from repro_torch.core.schedule import Op, Task, normalize_warmup, normalize_zb_policy

__all__ = [
    "ScheduleSpec",
    "KindSpec",
    "register_kind",
    "register_alias",
    "get_kind",
    "registered_kinds",
    "known_kinds",
    "resolve_alias",
    "warmup_kinds",
    "saved_residual_kinds",
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
    peak_is_exact: bool = False
    virtual_stage: Callable[[int, int, int, int], int] | None = None
    label: Callable[[str, int, str, int], str] | None = None

    def frees_slot(self, op: Op) -> bool:
        """The op that releases a live activation slot at a device: the
        weight gradient for split-backward (zero-bubble) kinds — it still
        reads the stage input — the combined backward otherwise."""
        return op == (Op.BWD_WEIGHT if self.has_split_backward else Op.BWD)

    def plan_label(self, base: str, v: int, wtag: str, max_w: int) -> str:
        if self.label is None:
            return base
        return self.label(base, v, wtag, max_w)


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
    """All registered kinds, in registration order."""
    return tuple(_REGISTRY)


def known_kinds() -> tuple[str, ...]:
    """Registered kinds plus aliases — the full set ``make_plan`` accepts."""
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
    )
)
register_kind(
    KindSpec(
        name="zb_h1",
        build_orders=_zb_build,
        peak_live_groups=_peak_1f1b,
        has_split_backward=True,
        supports_saved_residual=True,
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
        has_split_backward=True,
        supports_saved_residual=True,
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
        virtual_stage=_zbv_vstage,
        label=lambda base, v, wtag, max_w: (
            f"ZB-V+{wtag}[{base}]" if max_w else f"ZB-V[{base}]"
        ),
    )
)
