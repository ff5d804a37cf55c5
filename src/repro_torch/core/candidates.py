"""§4.2 candidate enumeration: the memory-limit (Pareto) curve over (kind, k, b).

A copy of ``repro/core/candidates.py`` for the port: the standard library
and numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py``
holds it equal to the original on the same inputs.

With a fixed global batch ``B``, a plan is identified by its
:class:`~repro_torch.core.kinds.ScheduleSpec` — schedule ``kind``, group count
``k``, virtual degree, per-stage warmup vector and micro-batch size ``b``
(``M = B / b`` micro-batches, ``k | M``).  Feasible combinations lie under
the memory-limit curve; interior points under-utilize device memory (point
*A* of Fig 3) and points above it OOM (point *B*).  Only curve points
(like *C*) are kept: for each (kind, k) from 1 upwards, greedily take the
**largest** feasible ``b``.

The memory limit itself is a per-stage *curve* (``memory_limit_bytes``
accepts a scalar or one entry per stage): real pipelines are
heterogeneous — the first stage carries the embedding, the last the logits
head — so admissibility is judged stage by stage.

The per-kind search axes come from the registry, not from code here: each
registered :class:`~repro_torch.core.kinds.KindSpec` enumerates its own
:meth:`~repro_torch.core.kinds.KindSpec.search_specs` at a given ``(k, b)`` —
virtual degrees for interleaved-capable kinds (pinned for ZB-V), the
greedily-priced per-stage warmup vector ``w[s]`` for warmup-capable ones
(closed-form via the kind's ``peak_live_groups`` row; a warmup-REQUIRING
kind like ``zb_h2`` contributes no candidate when no stage admits
``w[s] = 1``, which is how the tuner "refuses" H2 and falls back to H1
under a tight limit).  Registering a kind is therefore sufficient for the
search to cover it — no edits here.

Duplicated (kind, k, b) never arise (b is a function of (kind, k) on the
curve), but two k values can map to the same b when memory is
activation-light; both are kept — they are genuinely different schedules
with different overlap behaviour.  Schedule kinds beyond kFkB are opt-in
via the :class:`~repro_torch.core.kinds.SearchSpace` (or the legacy ``kinds=``
kwarg, which builds one) so the paper's original (k, b)-only search stays
the default.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence
import warnings

from repro_torch.core.kinds import (
    ScheduleSpec,
    SearchSpace,
    admissible_warmup,
    get_kind,
    known_kinds,
    registered_kinds,
    resolve_alias,
)
from repro_torch.core.memory_model import MemoryModel, limit_curve
from repro_torch.core.schedule import SchedulePlan, TabularPlan, make_plan

__all__ = [
    "Candidate",
    "SearchSpace",
    "enumerate_candidates",
    "divisors",
    "largest_admissible_warmup",
]


@dataclasses.dataclass
class Candidate:
    k: int
    micro_batch_size: int
    num_microbatches: int
    plan: SchedulePlan
    est_peak_bytes: float

    @property
    def name(self) -> str:
        return self.plan.name

    @property
    def kind(self) -> str:
        return self.plan.kind

    @property
    def num_virtual(self) -> int:
        return self.plan.num_virtual

    @property
    def extra_warmup(self) -> tuple[int, ...]:
        return self.plan.extra_warmup

    @property
    def spec(self) -> ScheduleSpec:
        """The candidate's normalized schedule coordinates — shared with
        the tuning record, the compile-cache key and the runtime."""
        return self.plan.spec

    @property
    def table(self) -> TabularPlan:
        """The candidate's lowered :class:`TabularPlan` (cached on the plan —
        candidates are static, so the tuner and engines lower each at most
        once across all tuning intervals)."""
        return self.plan.lower()


def divisors(n: int) -> list[int]:
    out = [d for d in range(1, n + 1) if n % d == 0]
    return out


def _build(
    plan_factory: Callable[..., SchedulePlan],
    num_stages: int,
    M: int,
    spec: ScheduleSpec,
) -> SchedulePlan:
    if (
        spec.kind in registered_kinds()
        and get_kind(spec.kind).legacy_factory
        and spec.num_virtual == 1
        and not max(spec.extra_warmup)
    ):
        # the paper's original search path — keep legacy factories working
        return plan_factory(num_stages, M, spec.k, micro_batch_size=spec.micro_batch_size)
    return plan_factory(num_stages, M, spec=spec)


def largest_admissible_warmup(
    num_stages: int,
    M: int,
    k: int,
    b: int,
    num_virtual: int,
    zb: bool,
    memory_model: MemoryModel,
    limits: Sequence[float],
    max_extra_warmup: int,
    zb_policy: Sequence[str] | None = None,
) -> tuple[int, ...]:
    """Greedy per-stage warmup vector on the memory-limit curve.

    Back-compat wrapper over :func:`repro_torch.core.kinds.admissible_warmup`:
    the coordinates select the registered warmup-capable kind whose
    ``peak_live_groups`` row matches (``zb_h2`` for flat plans,
    ``interleaved_zb`` for virtual-stage ones), and each stage
    independently takes the largest ``w[s]`` its own limit admits via the
    closed-form stage byte curve — no plan is built per probe.
    ``zb_policy`` (a per-stage vector) prices saved-residual stages under
    the residual-fattened slot curve, so they admit shallower warmup.
    """
    kind = "interleaved_zb" if num_virtual > 1 else "zb_h2"
    return admissible_warmup(
        get_kind(kind), num_stages, M, k, b, num_virtual,
        memory_model, limits, max_extra_warmup, zb_pricing=zb,
        zb_policy=zb_policy,
    )


def enumerate_candidates(
    num_stages: int,
    global_batch: int,
    memory_model: MemoryModel,
    memory_limit_bytes: float | Sequence[float],
    max_k: int | None = None,
    min_microbatches: int | None = None,
    plan_factory: Callable[..., SchedulePlan] = make_plan,
    kinds: Sequence[str] | None = None,
    virtual_degrees: Sequence[int] | None = None,
    max_extra_warmup: int | None = None,
    space: SearchSpace | None = None,
) -> list[Candidate]:
    """Enumerate the memory-limit-curve candidates.

    The search axes come from one :class:`~repro_torch.core.kinds.SearchSpace`
    passed as ``space=``.  The legacy kwargs (``kinds=``,
    ``virtual_degrees=``, ``max_k=``, ``min_microbatches=``,
    ``max_extra_warmup=``) are **deprecated**: they remain accepted — they simply build a ``SearchSpace``,
    conformance-tested to produce identical candidates — but emit
    :class:`DeprecationWarning`, and a grep gate keeps in-repo callers on
    ``space=``.

    ``min_microbatches`` (default: ``num_stages``) rejects plans that
    cannot even fill the pipeline once — the paper always injects at least
    one micro-batch per stage.  Per ``(kind, k)`` (times the kind's own
    extra axes: virtual degree, memory-priced warmup vector — see
    :meth:`~repro_torch.core.kinds.KindSpec.search_specs`) the largest feasible
    ``b`` on the limit curve is kept; infeasible combinations (e.g.
    interleaved divisibility) are skipped silently, unknown kind NAMES
    fail loudly against the registry.  ``memory_limit_bytes`` may be a
    scalar or a per-stage curve.
    """
    legacy = {
        "kinds": kinds,
        "virtual_degrees": virtual_degrees,
        "max_k": max_k,
        "min_microbatches": min_microbatches,
        "max_extra_warmup": max_extra_warmup,
    }
    given = sorted(name for name, value in legacy.items() if value is not None)
    if given:
        warnings.warn(
            f"enumerate_candidates({', '.join(n + '=' for n in given)}...) is "
            "deprecated; declare the axes as one space=SearchSpace(...)",
            DeprecationWarning,
            stacklevel=2,
        )
        if space is not None:
            raise ValueError("pass space= or the legacy axis kwargs, not both")
    if space is None:
        space = SearchSpace(
            kinds=tuple(kinds) if kinds is not None else ("kfkb",),
            virtual_degrees=tuple(virtual_degrees) if virtual_degrees is not None else (2,),
            max_k=max_k,
            min_microbatches=min_microbatches,
            max_extra_warmup=max_extra_warmup,
        )
    min_mb = space.min_microbatches
    if min_mb is None:
        min_mb = num_stages
    max_w = space.max_extra_warmup
    if max_w is None:
        max_w = max(num_stages - 1, 1)
    known = known_kinds()  # registry members + aliases — never a literal
    for kind in space.kinds:
        if kind not in known:  # fail loudly — the except below is only for
            # per-(k, b) infeasibility, not misconfiguration
            raise ValueError(f"unknown schedule kind {kind!r}; expected one of {known}")
    limits = limit_curve(memory_limit_bytes, num_stages)
    out: list[Candidate] = []
    ks = range(1, (space.max_k or global_batch) + 1)
    for name in space.kinds:
        resolved, _ = resolve_alias(name, 1, global_batch)
        kspec = get_kind(resolved)
        for v in kspec.virtual_axis(space.virtual_degrees):
            for k in ks:
                # one curve point PER search point the kind enumerates at
                # (k, b) — the built-in kinds emit one per (kind, v), but a
                # custom ``search_specs_fn`` may emit several (e.g. multiple
                # warmup operating points); each takes its own largest
                # feasible b, keyed by its position in the enumerator's list
                found: dict[int, Candidate] = {}
                for b in sorted(divisors(global_batch), reverse=True):
                    M = global_batch // b
                    if M % k != 0 or M < min_mb:
                        continue
                    specs = kspec.search_specs(
                        num_stages=num_stages,
                        num_microbatches=M,
                        k=k,
                        micro_batch_size=b,
                        virtual_degrees=(v,),
                        memory_model=memory_model,
                        limits=limits,
                        max_extra_warmup=max_w,
                        zb_policies=space.zb_policies,
                    )
                    for i, spec in enumerate(specs):
                        if i in found:
                            continue  # this point already has its curve b
                        if name != spec.kind:  # alias: let make_plan force k
                            spec = dataclasses.replace(spec, kind=name)
                        try:
                            plan = _build(plan_factory, num_stages, M, spec)
                        except ValueError:
                            continue  # e.g. interleaved group-divisibility
                        peaks = memory_model.peak_bytes_per_stage(plan)
                        if all(p <= lim for p, lim in zip(peaks, limits)):
                            found[i] = Candidate(k, b, M, plan, max(peaks))
                out.extend(c for _, c in sorted(found.items()))
    return out
