"""PlanRuntime: warm plan switches across schedule *kinds* on the reference engine.

Port of ``repro/runtime/executor.py``.  §5.4: "Switching between schedule
plans does not require variable buffers to be dumped out and restored ...
no effect on model parameters."  That holds verbatim for (k, b, w)
switches, but switching into (or out of) an *interleaved* member changes
the parameter **layout**: a flat ``S``-stage model keeps ``S`` per-stage
trees while a ``v``-way interleaved plan runs the ``S * v`` virtual-stage
sibling, whose trees are in global virtual-stage order.
:func:`restack_train_state` moves a state between the two, bitwise:

* layers: global virtual stage ``j`` owns flat stage ``j // v``'s layers
  ``[(j % v) * n / v, (j % v + 1) * n / v)`` (``n`` layers a flat stage),
  so a restack regroups the ``layers`` lists; no tensor is copied;
* replicated groups (``embed`` / ``final_norm``): every virtual stage
  carries a copy, but only virtual stage 0 (token embedding) and the last
  virtual stage (final norm + unembed head) receive gradients, so
  expansion gives each flat stage's copy to its ``v`` chunks (the chunks
  after the first get a clone of it: AdamW updates in place, and aliased
  copies would be updated twice) and collapse keeps each flat stage's
  canonical copy: virtual stage ``s * v``, EXCEPT for the last flat stage,
  whose authoritative copy is the final virtual stage's ``S * v - 1``
  (dropping it would discard the trained unembed head);
* everything else (step counters) passes through untouched.

AdamW's ``m``/``v`` mirror the parameters and restack with the same
function, so the optimizer moments carry over bit for bit.

The runtime's step is ``repro``'s: the engine's gradients go to the
optimizer as they are, each replicated copy with its own gradient (the
reference backend does not sum them; ``repro`` sums them only inside its
``shard_map`` engine).  So it is not ``training.make_pipeline_train_step``,
which sums them.

:class:`PlanRuntime` owns the :class:`~repro_torch.training.TrainState` and
a :class:`~repro_torch.runtime.compile_cache.CompiledStepCache`;
``switch_to`` is the warm path (fetch the step, restack if the layout
changed, swap a pointer) and ``run_iteration`` runs and times the current
step, publishing to the telemetry bus.  Both synchronise the card before
they read the clock.  Backend: ``"reference"`` (the single-device grid
walk of ``pipeline.engine.reference_pipeline_grads``).  The original's
``"spmd"`` backend, on the multi-rank engine
(``pipeline.engine.make_pipeline_step``), is not ported yet: a switch
that changes v moves layers and AdamW moments between the ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.core.interfaces import TelemetrySink
from repro_torch.core.schedule import TabularPlan
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.common import ModelConfig
from repro_torch.obs import Observability
from repro_torch.pipeline.engine import REPLICATED, reference_pipeline_grads
from repro_torch.pipeline.stage import StagedModel
from repro_torch.runtime.compile_cache import CompiledStepCache
from repro_torch.training.state import TrainState, create_train_state

__all__ = ["SwitchEvent", "IterationResult", "PlanRuntime", "restack_train_state"]


# ---------------------------------------------------------------------------
# Bitwise re-stacking between virtual-stage layouts
# ---------------------------------------------------------------------------


def _collapse_rows(num_stages: int, v: int) -> list[int]:
    """Virtual stage whose replicated copy flat stage ``s`` keeps,
    ``S*v -> S``: its first chunk's, except the last flat stage, which must
    keep the FINAL virtual stage's copy (the trained unembed head)."""
    idx = [s * v for s in range(num_stages)]
    idx[-1] = num_stages * v - 1
    return idx


def _restack_stages(stages: list, S: int, v_from: int, v_to: int) -> list:
    if len(stages) != S * v_from:
        raise ValueError(f"{len(stages)} stage trees, the layout has S*v={S * v_from}")
    flat = stages
    if v_from > 1:  # collapse to flat
        rows = _collapse_rows(S, v_from)
        flat = []
        for s in range(S):
            tree = {g: stages[rows[s]][g] for g in REPLICATED}
            tree["layers"] = [layer for c in range(v_from) for layer in stages[s * v_from + c]["layers"]]
            flat.append(tree)
    if v_to == 1:
        return flat
    out = []
    for tree in flat:  # expand to the target layout
        n = len(tree["layers"])
        if n % v_to:
            raise ValueError(f"cannot split {n} layers (reps) a stage over v={v_to} chunks (need v | reps)")
        per = n // v_to
        for c in range(v_to):
            copy = (lambda x: x) if c == 0 else torch.clone
            chunk = {g: _map(copy, tree[g]) for g in REPLICATED}
            chunk["layers"] = tree["layers"][c * per : (c + 1) * per]
            out.append(chunk)
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def restack_train_state(state, num_stages: int, v_from: int, v_to: int):
    """Restack a :class:`TrainState`, an AdamW state or a list of
    per-virtual-stage trees (parameters or gradients) between the ``v_from``-
    and ``v_to``-way virtual layouts.

    Bitwise: layers regroup, replicated groups expand (a clone for every
    chunk after the first) or collapse to the authoritative copies, other
    fields pass through.  The result shares its tensors with ``state``
    (the layers, and each kept or first copy of a replicated group): the
    caller hands the old state over.  ``v_from == v_to`` returns ``state``."""
    if v_from == v_to:
        return state
    if isinstance(state, list):
        return _restack_stages(state, num_stages, v_from, v_to)
    if dataclasses.is_dataclass(state):
        changes = {
            f.name: restack_train_state(getattr(state, f.name), num_stages, v_from, v_to)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), list) or dataclasses.is_dataclass(getattr(state, f.name))
        }
        return dataclasses.replace(state, **changes)
    return state


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SwitchEvent:
    iteration: int
    from_plan: str
    to_plan: str
    from_kind: str
    to_kind: str
    restacked: bool  # the parameter layout changed (interleaved boundary)
    warm: bool  # the step was ready before the switch was requested
    seconds: float  # dispatch latency: fetch + restack + pointer swap
    compile_seconds: float  # 0 for warm hits
    # full schedule coordinates of both sides: the same ScheduleSpec the
    # candidate set, the tuning record and the cache key carry
    from_spec: "object | None" = None
    to_spec: "object | None" = None


@dataclasses.dataclass
class IterationResult:
    index: int
    plan_name: str
    kind: str
    loss: float
    seconds: float


class PlanRuntime:
    """Owns the parameters and optimizer state; runs and hot-swaps steps."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_stages: int,
        optimizer,
        global_batch: int,
        seq_len: int,
        backend: str = "reference",
        telemetry: TelemetrySink | None = None,
        init_key: int = 0,
        obs: Observability | None = None,
        program_factory=None,
        device=None,
    ) -> None:
        if backend == "spmd":
            raise NotImplementedError(
                "the spmd backend (PlanRuntime on the multi-rank engine, with the state restacked "
                "across ranks when v changes) is not ported yet (ROADMAP.md, queue 1, item 2); "
                "use backend='reference'"
            )
        if backend != "reference":
            raise ValueError(f"unknown backend {backend!r}")
        self.cfg = cfg
        self.num_stages = num_stages
        self.optimizer = optimizer
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.backend = backend
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._staged: dict[int, StagedModel] = {}
        # program_factory overrides the training-step factory.  With
        # optimizer=None the runtime is *stateless*: it owns no TrainState
        # and run_iteration is unavailable; use run_program.
        self.program_factory = program_factory
        if optimizer is None:
            if program_factory is None:
                raise ValueError("optimizer=None (stateless serving mode) requires a program_factory")
            self.state = None
        else:
            staged0 = self.staged_for(1)
            params = staged0.init_all_stages(torch.Generator(device=self.device).manual_seed(init_key))
            self.state: TrainState = create_train_state(params, optimizer)
        self.current_v = 1
        self.cache = CompiledStepCache(
            program_factory or self._program_for, metrics=obs.metrics if obs is not None else None
        )
        self.current_table: TabularPlan | None = None
        self._compiled = None
        self.switch_events: list[SwitchEvent] = []
        self.iterations: list[IterationResult] = []
        self.last_grads = None
        self._grads_v = 1  # the layout last_grads are in
        # observability (optional): trace spans on "runtime/switches" and
        # "runtime/iterations", registry series, flight plan_switch events
        self.obs = obs
        if obs is not None:
            self._m_iters = obs.metrics.counter("runtime_iterations_total")
            self._m_iter_s = obs.metrics.histogram("runtime_iteration_seconds")
            self._m_switches = obs.metrics.counter("runtime_switches_total")
            self._m_switch_s = obs.metrics.histogram("runtime_switch_seconds")

    # -- model/program plumbing ----------------------------------------------

    def staged_for(self, v: int) -> StagedModel:
        if v not in self._staged:
            self._staged[v] = StagedModel.build(self.cfg, self.num_stages * v)
        return self._staged[v]

    def _program_for(self, table: TabularPlan):
        """Cache factory: the step of one lowered plan.  It builds the plan's
        staged model and derives the lowered grid and placement the engine
        walks, and launches no device work (it runs on the background
        worker).

        The step consumes and produces the plan's OWN layout; restacking at
        switch time is the runtime's job."""
        plan = table.plan
        M = plan.num_microbatches
        if self.global_batch % M:
            raise ValueError(f"plan {plan.name} needs M={M} | global_batch={self.global_batch}")
        staged = self.staged_for(plan.num_virtual)
        plan.lower(), plan.placement  # both cached on the plan: derived here, off the switch path
        optimizer = self.optimizer

        def step(state: TrainState, tokens, labels):
            loss, grads = reference_pipeline_grads(staged, state.params, tokens, labels, plan)
            params, opt_state, _ = optimizer.update(state.params, grads, state.opt_state)
            state.step, state.params, state.opt_state = state.step + 1, params, opt_state
            return state, loss, grads

        return step

    def precompile(self, tables) -> int:
        """Build the step programs of ``tables`` on the background worker.
        A restack has nothing to build."""
        return self.cache.precompile(list(tables))

    # -- the warm switch path -------------------------------------------------

    def switch_to(self, table: TabularPlan) -> SwitchEvent:
        """Dispatch a new plan at an iteration boundary.

        Warm path: the step is already built -> fetch + (if the layout
        changed) bitwise restack + pointer swap.  The cold path also pays
        the synchronous build, recorded apart so that it does not pollute
        the warm latency."""
        warm = self.cache.contains(table)
        sp = (
            self.obs.trace.span(
                "runtime/switches",
                f"switch {table.plan.name}",
                to_plan=table.plan.name,
                warm=warm,
            )
            if self.obs is not None
            else None
        )
        t0 = time.perf_counter()
        entry = self.cache.get(table)
        t1 = time.perf_counter()
        v_new = table.plan.num_virtual
        # stateless runtimes track the layout but have no owned state to restack
        restacked = v_new != self.current_v and self.state is not None
        if restacked:
            self.state = restack_train_state(self.state, self.num_stages, self.current_v, v_new)
            synchronize(self.device)
        self.current_v = v_new
        seconds = time.perf_counter() - t0
        event = SwitchEvent(
            iteration=len(self.iterations),
            from_plan=self.current_table.plan.name if self.current_table else "",
            to_plan=table.plan.name,
            from_kind=self.current_table.plan.kind if self.current_table else "",
            to_kind=table.plan.kind,
            restacked=restacked,
            warm=warm,
            seconds=seconds if warm else seconds - (t1 - t0),
            compile_seconds=0.0 if warm else (t1 - t0),
            from_spec=self.current_table.plan.spec if self.current_table else None,
            to_spec=table.plan.spec,
        )
        self.current_table = table
        self._compiled = entry.compiled
        self.switch_events.append(event)
        if self.obs is not None:
            self.obs.trace.end_span(sp, from_plan=event.from_plan, restacked=restacked, iteration=event.iteration)
            self._m_switches.inc(warm=str(warm).lower())
            self._m_switch_s.observe(event.seconds, warm=str(warm).lower())
            self.obs.flight.record(
                "plan_switch",
                iteration=event.iteration,
                from_plan=event.from_plan,
                to_plan=event.to_plan,
                warm=warm,
                restacked=restacked,
            )
        return event

    # -- execution ------------------------------------------------------------

    def run_iteration(self, tokens, labels) -> IterationResult:
        """One training step of the current plan on ``[global_batch, T]``
        data (reshaped to the plan's ``[M, b, T]`` micro-batch grid).  The
        previous step's gradients are released first, so that no two
        gradient sets are live at once."""
        if self.state is None:
            raise RuntimeError("stateless serving runtime owns no TrainState; use run_program")
        if self.current_table is None:
            raise RuntimeError("no plan dispatched; call switch_to first")
        plan = self.current_table.plan
        M = plan.num_microbatches
        b = self.global_batch // M
        tokens = torch.as_tensor(tokens, device=self.device).reshape(M, b, self.seq_len)
        labels = torch.as_tensor(labels, device=self.device).reshape(M, b, self.seq_len)
        self.last_grads = None
        sp = (
            self.obs.trace.span(
                "runtime/iterations",
                f"iter {len(self.iterations)} {plan.name}",
                plan=plan.name,
                index=len(self.iterations),
            )
            if self.obs is not None
            else None
        )
        synchronize(self.device)
        t0 = time.perf_counter()
        state, loss, grads = self._compiled(self.state, tokens, labels)
        synchronize(self.device)
        loss = float(loss)
        seconds = time.perf_counter() - t0
        self.state = state
        self.last_grads, self._grads_v = grads, self.current_v
        result = IterationResult(
            index=len(self.iterations),
            plan_name=plan.name,
            kind=plan.kind,
            loss=loss,
            seconds=seconds,
        )
        self.iterations.append(result)
        if self.obs is not None:
            self.obs.trace.end_span(sp, loss=result.loss)
            self._m_iters.inc(plan=plan.name)
            self._m_iter_s.observe(seconds, plan=plan.name)
        if self.telemetry is not None:
            self.telemetry.publish_iteration(
                index=result.index,
                plan=plan,
                seconds=seconds,
                end_time=time.perf_counter(),
                source="engine",
            )
        return result

    def run_program(self, *args):
        """Run the current program on explicit operands (the stateless
        mode: programs built by ``program_factory`` carry their own state in
        their operands).  The runtime times them and records the same span
        per run on ``runtime/iterations``.  Returns ``(outputs, seconds)``."""
        if self._compiled is None:
            raise RuntimeError("no plan dispatched; call switch_to first")
        plan = self.current_table.plan
        sp = (
            self.obs.trace.span(
                "runtime/iterations",
                f"serve {plan.name}",
                plan=plan.name,
            )
            if self.obs is not None
            else None
        )
        synchronize(self.device)
        t0 = time.perf_counter()
        out = self._compiled(*args)
        synchronize(self.device)
        seconds = time.perf_counter() - t0
        if self.obs is not None:
            self.obs.trace.end_span(sp)
            self._m_iters.inc(plan=plan.name)
            self._m_iter_s.observe(seconds, plan=plan.name)
        return out, seconds

    # -- inspection -----------------------------------------------------------

    def state_in_flat_layout(self) -> TrainState:
        """The owned state restacked to the canonical flat (v=1) layout: what
        cross-kind comparisons consume.  It shares tensors with the owned
        state; do not train on both."""
        return restack_train_state(self.state, self.num_stages, self.current_v, 1)

    def grads_in_flat_layout(self) -> Any:
        """The last step's gradients in the flat layout (None after a new
        step has started or before the first)."""
        if self.last_grads is None:
            return None
        return restack_train_state(self.last_grads, self.num_stages, self._grads_v, 1)

    @property
    def mean_iteration_seconds(self) -> float:
        if not self.iterations:
            return 0.0
        return sum(r.seconds for r in self.iterations) / len(self.iterations)
