"""Liveness-based peak-memory estimation for a (k, b) schedule plan.

A copy of ``repro/core/memory_model.py`` for the port: the standard library
and numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py``
holds it equal to the original on the same inputs.

The paper (§5.1) estimates memory with XLA's BufferAssignment on the slimmed
HLO; we model the same quantities explicitly, per stage:

    peak[s] = params[s] + optimizer_state[s] + grad_accum[s]
            + stage_input_bytes(b) * peak_live_activations(plan)[s]
            + transient_working_set(b)

``peak_live_activations`` comes from exact liveness over the plan order (see
:mod:`repro_torch.core.schedule`), which is where kFkB's k-fold activation cost
shows up.  The same walk covers the whole schedule family: zero-bubble
plans (``zb_h1`` / ``zb_h2`` / ``interleaved_zb``) keep a stage input live
until its ``BWD_WEIGHT`` (the weight gradient still reads it — the ZB-H1
builder caps issuance so the peak *slot count* equals the equal-k kFkB
plan's, while ZB-H2 buys exactly ``extra_warmup`` more slots per stage),
and interleaved plans count live micro-batches across every chunk the
device hosts.  Zero-bubble slots are priced at twice the stage-input
footprint: the engine stashes the incoming output gradient (``dy``,
hidden-sized) alongside the saved input between ``BWD_INPUT`` and
``BWD_WEIGHT`` (its ``wctx`` buffer mirrors the slot buffer), so zb memory
parity holds in slots, not bytes.  The model supports two checkpointing
policies matching the real engine: ``"stage_input"`` (store only the stage
input per live micro-batch, recompute inside the stage during backward —
the engine's default) and ``"full"`` (store all per-layer activations; no
recompute).

:func:`predicted_peak_live` is the closed-form companion of the exact walk:
the per-stage peak every builder is contractually bound to (exact for the
non-zb kinds when ``k | M`` and for zb kinds at uniform ``w``; an upper
bound for non-uniform warmup vectors — a stage's real depth is also limited
by what its upstream neighbours can feed it — and for ``interleaved_zb``,
whose greedy W placement may retire slots early).  The conformance suite
holds every builder to it.

Memory limits are a per-stage *curve*, not one number: real pipelines skew
(the first stage carries the embedding, the last the logits head, optimizer
sharding differs), which is exactly why a heterogeneous warmup vector
``w[s]`` can exist.  Every ``limit_bytes`` argument below accepts either a
scalar (uniform limit) or one entry per stage.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.kinds import get_kind
from repro_torch.core.schedule import ZB_SLOT_POLICIES, SchedulePlan, peak_live_activations

__all__ = [
    "StageMemorySpec",
    "MemoryModel",
    "predicted_peak_live",
    "limit_curve",
    "ZB_SLOT_POLICIES",
]

# ZB_SLOT_POLICIES (defined in the port's schedule.py, re-exported here as
# the original defines it here): how a zero-bubble slot bridges
# ``BWD_INPUT`` -> ``BWD_WEIGHT``.  Both policies are executable: each runs
# in the reference engine (``repro_torch.pipeline.engine``), is simulated with its
# own ``BWD_WEIGHT`` cost (``StageCosts.bwd_weight_saved_time`` vs
# ``bwd_weight_time``), and is chosen per stage by the tuner against the
# memory-limit curve (``SearchSpace.zb_policies``):
#
# * ``"double_remat"`` — the default: keep only the stage input + the
#   stashed ``dy``; ``W`` rematerializes the stage body a second time.
#   Cheapest memory, one extra recompute per micro-batch.
# * ``"saved_residual"`` — ``B`` keeps its autograd graph over
#   ``(params, x)``: its saved activations (the per-layer activations
#   the backward reads) stay in the live slot alongside ``dy`` until ``W``
#   consumes them — ``W`` is a pure pullback with no rematerialization,
#   at ``num_layers`` layer activations per live slot.  Redundant (and
#   rejected, see :class:`MemoryModel`) under ``checkpoint_policy="full"``,
#   whose slots already hold every layer activation.


def _reject_redundant_saved_residual(zb_policy: str, checkpoint_policy: str) -> None:
    """``saved_residual`` under ``checkpoint_policy="full"`` is a
    contradiction, not a discount: "full" slots already hold every per-layer
    activation, so there is nothing for the residual surcharge to buy (the
    model used to silently price it at zero).  Fail closed instead of
    letting a search believe it found a free lunch."""
    if zb_policy == "saved_residual" and checkpoint_policy == "full":
        raise ValueError(
            "zb_policy='saved_residual' is redundant under "
            "checkpoint_policy='full': the slot already stores every "
            "per-layer activation, so BWD_WEIGHT has no rematerialization "
            "to skip and the residual surcharge prices to zero.  Use "
            "checkpoint_policy='stage_input' (the engines' policy) or "
            "zb_policy='double_remat'."
        )


def limit_curve(limit_bytes: float | Sequence[float], num_stages: int) -> list[float]:
    """Normalize a memory limit to the per-stage curve (scalars broadcast)."""
    if isinstance(limit_bytes, (int, float)):
        return [float(limit_bytes)] * num_stages
    curve = [float(x) for x in limit_bytes]
    if len(curve) != num_stages:
        raise ValueError(
            f"memory limit curve needs one entry per stage "
            f"(got {len(curve)}, num_stages={num_stages})"
        )
    return curve


def predicted_peak_live(plan: SchedulePlan) -> list[int]:
    """Closed-form per-stage peak live activations for any family member.

    Delegated to the plan kind's registered ``peak_live_groups`` row (the
    builder's memory contract — every kind must ship one; an unregistered
    kind fails closed in the registry lookup).  Group-level peaks are exact
    when ``k | M`` and, for kinds whose ``peak_is_exact`` flag is set, at
    uniform ``w`` (non-uniform vectors are upstream-limited, so the
    prediction is an upper bound); expanded to micro-batches, each group
    holds ``k`` members.
    """
    S, M, k = plan.num_stages, plan.num_microbatches, plan.k
    v, w = plan.num_virtual, plan.extra_warmup
    G = (M + k - 1) // k
    groups = get_kind(plan.kind).peak_live_groups(S, G, v, tuple(w))
    return [min(g * k, M * v) for g in groups]


@dataclasses.dataclass
class StageMemorySpec:
    """Static memory description of one pipeline stage (bytes)."""

    param_bytes: float
    optimizer_bytes: float  # m/v (AdamW) or factored (Adafactor) state
    grad_bytes: float  # accumulated gradient buffer
    # per-token activation footprints; multiply by (b * seq)
    stage_input_bytes_per_token: float  # hidden stream entering the stage
    layer_act_bytes_per_token: float  # per-layer saved activations ("full" policy)
    num_layers: int
    workspace_bytes_per_token: float = 0.0  # attention scores etc. during compute


@dataclasses.dataclass
class MemoryModel:
    stages: list[StageMemorySpec]
    seq_len: int
    checkpoint_policy: str = "stage_input"  # or "full"
    # zero-bubble slot pricing policy (see ZB_SLOT_POLICIES): how much a
    # live slot costs between BWD_INPUT and BWD_WEIGHT
    zb_policy: str = "double_remat"

    def __post_init__(self) -> None:
        if self.zb_policy not in ZB_SLOT_POLICIES:
            raise ValueError(
                f"unknown zb_policy {self.zb_policy!r}; expected one of {ZB_SLOT_POLICIES}"
            )
        _reject_redundant_saved_residual(self.zb_policy, self.checkpoint_policy)

    def activation_bytes_per_mb(self, stage: int, micro_batch_size: int) -> float:
        """Resident activation bytes held for ONE live micro-batch at a stage."""
        spec = self.stages[stage]
        tokens = micro_batch_size * self.seq_len
        if self.checkpoint_policy == "stage_input":
            return spec.stage_input_bytes_per_token * tokens
        if self.checkpoint_policy == "full":
            return (
                spec.stage_input_bytes_per_token
                + spec.layer_act_bytes_per_token * spec.num_layers
            ) * tokens
        raise ValueError(f"unknown checkpoint policy {self.checkpoint_policy!r}")

    def transient_bytes(self, stage: int, micro_batch_size: int) -> float:
        """Working set while one micro-batch is being (re)computed."""
        spec = self.stages[stage]
        tokens = micro_batch_size * self.seq_len
        per_layer = spec.layer_act_bytes_per_token * tokens
        ws = spec.workspace_bytes_per_token * tokens
        if self.checkpoint_policy == "stage_input":
            # backward recompute materializes the stage's layer activations once
            return per_layer * spec.num_layers + ws
        return ws

    def static_bytes(self, stage: int) -> float:
        """Schedule-independent residents: params + optimizer state + grads."""
        spec = self.stages[stage]
        return spec.param_bytes + spec.optimizer_bytes + spec.grad_bytes

    def _effective_policy(self, policy: str | None) -> str:
        """Resolve a per-call (per-stage) policy against the model default.

        ``None`` and the default ``"double_remat"`` defer to the model's
        ``zb_policy`` (so a model constructed with
        ``zb_policy="saved_residual"`` keeps pricing plain plans that way —
        the pricing-only behaviour); an explicit ``"saved_residual"``
        wins, which is how a plan's per-stage vector prices mixed stages.
        """
        if policy is None or policy == "double_remat":
            eff = self.zb_policy
        else:
            if policy not in ZB_SLOT_POLICIES:
                raise ValueError(
                    f"unknown zb_policy {policy!r}; expected one of {ZB_SLOT_POLICIES}"
                )
            eff = policy
        # re-checked here (not just in __post_init__): checkpoint_policy is
        # a mutable field, and the redundant combination must fail at use
        _reject_redundant_saved_residual(eff, self.checkpoint_policy)
        return eff

    def slot_bytes(
        self, stage: int, micro_batch_size: int, zb: bool, policy: str | None = None
    ) -> float:
        """Bytes ONE live activation slot costs at a stage.

        Zero-bubble slots carry the engine's wctx surcharge: a hidden-sized
        ``dy`` is stashed alongside the saved stage input between
        ``BWD_INPUT`` and ``BWD_WEIGHT``.  Under the ``"saved_residual"``
        policy (the model default or the per-call ``policy`` override —
        a plan's per-stage vector) the slot additionally keeps ``B``'s vjp
        residuals — one layer-activation footprint per layer of the stage —
        which is what buys away the second rematerialization (the residuals
        only pay off where the limit curve still admits them; pricing them
        here lets the candidate enumeration refuse the variant per stage).
        """
        per_slot = self.activation_bytes_per_mb(stage, micro_batch_size)
        if zb:
            spec = self.stages[stage]
            tokens = micro_batch_size * self.seq_len
            per_slot += spec.stage_input_bytes_per_token * tokens
            if self._effective_policy(policy) == "saved_residual":
                per_slot += spec.layer_act_bytes_per_token * spec.num_layers * tokens
        return per_slot

    def bytes_at_live(
        self,
        stage: int,
        micro_batch_size: int,
        live: int,
        zb: bool,
        policy: str | None = None,
    ) -> float:
        """Predicted peak bytes at one stage holding ``live`` activation
        slots — the closed-form stage curve the warmup greedy walks."""
        return (
            self.static_bytes(stage)
            + self.slot_bytes(stage, micro_batch_size, zb, policy) * live
            + self.transient_bytes(stage, micro_batch_size)
        )

    def peak_bytes_per_stage(self, plan: SchedulePlan) -> list[float]:
        b = plan.micro_batch_size
        peaks_live = peak_live_activations(plan)
        zb = get_kind(plan.kind).has_split_backward
        pol = plan.zb_policy
        return [
            self.bytes_at_live(s, b, peaks_live[s], zb, pol[s] if zb else None)
            for s in range(len(self.stages))
        ]

    def peak_bytes(self, plan: SchedulePlan) -> float:
        return max(self.peak_bytes_per_stage(plan))

    def fits(self, plan: SchedulePlan, limit_bytes: float | Sequence[float]) -> bool:
        """Per-stage comparison against a (possibly per-stage) limit curve."""
        limits = limit_curve(limit_bytes, len(self.stages))
        return all(
            peak <= lim for peak, lim in zip(self.peak_bytes_per_stage(plan), limits)
        )

    @classmethod
    def uniform(
        cls,
        num_stages: int,
        seq_len: int,
        param_bytes: float,
        optimizer_bytes: float,
        grad_bytes: float,
        stage_input_bytes_per_token: float,
        layer_act_bytes_per_token: float,
        num_layers_per_stage: int,
        checkpoint_policy: str = "stage_input",
        workspace_bytes_per_token: float = 0.0,
        zb_policy: str = "double_remat",
    ) -> "MemoryModel":
        spec = StageMemorySpec(
            param_bytes=param_bytes,
            optimizer_bytes=optimizer_bytes,
            grad_bytes=grad_bytes,
            stage_input_bytes_per_token=stage_input_bytes_per_token,
            layer_act_bytes_per_token=layer_act_bytes_per_token,
            num_layers=num_layers_per_stage,
            workspace_bytes_per_token=workspace_bytes_per_token,
        )
        return cls(
            [dataclasses.replace(spec) for _ in range(num_stages)],
            seq_len,
            checkpoint_policy,
            zb_policy=zb_policy,
        )
