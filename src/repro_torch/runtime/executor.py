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
optimizer as they are.  The reference backend's engine leaves each
replicated copy its own gradient (``repro`` sums them only inside its
``shard_map`` engine), so its step is not
``training.make_pipeline_train_step``, which sums them; the multi-rank
engine sums them over the ranks, as ``repro``'s ``shard_map`` engine does.

:class:`PlanRuntime` owns the :class:`~repro_torch.training.TrainState` and
a :class:`~repro_torch.runtime.compile_cache.CompiledStepCache`;
``switch_to`` is the warm path (fetch the step, restack if the layout
changed, swap a pointer) and ``run_iteration`` runs and times the current
step, publishing to the telemetry bus.  Both synchronise the card before
they read the clock.  Backends:

* ``"reference"``: one process, the single-device grid walk of
  ``pipeline.engine.reference_pipeline_grads``, the state a list of all
  ``S * v`` virtual stages' trees;
* ``"spmd"``: one process per stage (and data replica) on the multi-rank
  engine (``pipeline.engine.make_pipeline_step``), given the rank's
  :class:`~repro_torch.pipeline.ranks.RankGroup` in place of ``repro``'s
  mesh.  Each rank's runtime owns its own chunks' state (a list of its
  ``v`` chunk trees, in chunk order); a switch moves it to the new
  plan's placement with :func:`restack_across_ranks`.  Global rank 0 leads:
  its ``precompile``, ``switch_to``, ``run_iteration`` and inspection calls
  are broadcast as small commands (the table, the batch index) to the
  other ranks, which run :meth:`PlanRuntime.follow` until rank 0 calls
  :meth:`PlanRuntime.stop`.  No tokens travel: a follower draws batch ``i``
  itself.

**Restacking across ranks keys on the placement, not on v.**
``repro``'s ``restack_train_state`` regroups the global virtual-stage list
when v changes and returns the state unchanged otherwise; across ranks a
layer moves whenever the device that holds it changes, and
``interleaved_zb`` (looped: devices ``[0, 1, 2, 3, 0, 1, 2, 3]`` at S = 4)
and ``zbv`` (V-shaped: ``[0, 1, 2, 3, 3, 2, 1, 0]``) differ at the same
v = 2.  ``SwitchEvent.restacked`` keeps ``repro``'s meaning (v changed);
the layers and bytes each rank moved are in ``SwitchEvent.ranks``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core.interfaces import TelemetrySink
from repro_torch.core.schedule import Placement, TabularPlan
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.common import ModelConfig
from repro_torch.obs import Observability
from repro_torch.pipeline.engine import REPLICATED, make_pipeline_step, reference_pipeline_grads
from repro_torch.pipeline.stage import StagedModel
from repro_torch.runtime.compile_cache import CompiledStepCache
from repro_torch.training.state import TrainState, create_train_state
from repro_torch.tree import flatten, tree_map

__all__ = ["SwitchEvent", "IterationResult", "PlanRuntime", "restack_train_state", "restack_across_ranks"]


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
            chunk = {g: tree_map(copy, tree[g]) for g in REPLICATED}
            chunk["layers"] = tree["layers"][c * per : (c + 1) * per]
            out.append(chunk)
    return out


def _stage_lists(state) -> list:
    """The per-chunk lists of a state (the parameters, then each optimizer
    tree), in field order."""
    if isinstance(state, list):
        return [state]
    if dataclasses.is_dataclass(state):
        return [x for f in dataclasses.fields(state) for x in _stage_lists(getattr(state, f.name))]
    return []


def _with_lists(state, lists):
    """``state`` with its per-chunk lists replaced, in :func:`_stage_lists` order."""
    if isinstance(state, list):
        return next(lists)
    if dataclasses.is_dataclass(state):
        changes = {
            f.name: _with_lists(getattr(state, f.name), lists)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), list) or dataclasses.is_dataclass(getattr(state, f.name))
        }
        return dataclasses.replace(state, **changes)
    return state


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
    lists = [_restack_stages(lst, num_stages, v_from, v_to) for lst in _stage_lists(state)]
    return _with_lists(state, iter(lists))


# ---------------------------------------------------------------------------
# Restacking across ranks (the spmd backend)
# ---------------------------------------------------------------------------

#: tag of a restack transfer's buffer ``i`` (one a dtype): ``_RESTACK_TAG + i``
#: (the engine's channels use tags 0-5, ``bridge.gather_to_rank0`` 6)
_RESTACK_TAG = 8


def _dtype_sizes(shapes) -> dict:
    """The elements of each dtype over the ``(shape, dtype)`` list of a
    layer's leaves, in first-seen order: the flat buffers a layer travels in."""
    sizes: dict = {}
    for shape, dtype in shapes:
        sizes[dtype] = sizes.get(dtype, 0) + math.prod(shape)
    return sizes


def _pack(leaves: list) -> list:
    """A layer's leaves as one flat buffer a dtype (see :func:`_dtype_sizes`)."""
    by_dtype: dict = {}
    for t in leaves:
        by_dtype.setdefault(t.dtype, []).append(t.reshape(-1))
    return [torch.cat(ts) for ts in by_dtype.values()]


def _unpack(bufs: list, shapes) -> list:
    """The leaves, views of ``bufs`` (from :func:`_pack`), of the
    ``(shape, dtype)`` list ``shapes``."""
    parts = {dtype: iter(buf.split([math.prod(shape) for shape, dt in shapes if dt == dtype]))
             for buf, dtype in zip(bufs, _dtype_sizes(shapes))}
    return [next(parts[dtype]).view(shape) for shape, dtype in shapes]


def _layer_homes(placement: Placement, num_layers: int) -> list[tuple[int, int, int]]:
    """``(stage, chunk, position)`` of every global layer under ``placement``:
    virtual stage ``j`` holds layers ``[j * n, (j + 1) * n)``, ``n`` layers a
    virtual stage (``repro``'s rule: flat stage ``j // v``'s layers
    ``[(j % v) * n, (j % v + 1) * n)``)."""
    V = placement.device_of.size
    if num_layers % V:
        raise ValueError(f"cannot split {num_layers} layers over {V} virtual stages (need S*v | layers, v | reps)")
    n = num_layers // V
    return [(int(placement.device_of[g // n]), int(placement.chunk_of[g // n]), g % n) for g in range(num_layers)]


def _rounds(moves: list[tuple[int, int, int]]) -> list[list[tuple[int, int, int]]]:
    """The layer moves ``(layer, src, dst)`` in rounds, in which a stage
    sends at most one layer and receives at most one: first come, first
    placed, in layer order (every rank computes the same rounds)."""
    rounds, pending = [], list(moves)
    while pending:
        senders, receivers, now, later = set(), set(), [], []
        for mv in pending:
            if mv[1] in senders or mv[2] in receivers:
                later.append(mv)
            else:
                senders.add(mv[1])
                receivers.add(mv[2])
                now.append(mv)
        rounds.append(now)
        pending = later
    return rounds


def restack_across_ranks(state, group, place_from: Placement, place_to: Placement, period: int = 1):
    """Move this rank's share of a pipeline state from the placement
    ``place_from`` to ``place_to``, over the rank's stage group, bitwise.

    ``state`` is a :class:`~repro_torch.training.TrainState` (or a list of
    chunk trees) whose lists hold the rank's chunks in chunk order.  Every
    rank of the stage group calls it with the same placements.  Layer ``g``
    lives in virtual stage ``g // n`` (``n`` layers a virtual stage; see
    :func:`_layer_homes`), on the device and in the chunk the placement
    gives that virtual stage.  A layer that stays on this rank changes list
    position only; a layer that changes rank goes point to point, its
    parameters and moments together in one flat buffer a dtype
    (:func:`_pack`), one layer a round (:func:`_rounds`), and the sender
    drops it from ``state`` once its send has completed: beyond the state,
    a rank holds at most two layers' buffers at a time, the one it sends
    and the one it receives.  ``period`` is the layer pattern's length (layers ``g`` and
    ``g + period`` have one structure).

    The replicated groups (``embed``, ``final_norm``) do not travel: under
    this backend every copy receives the same summed gradient and starts
    from the same draw, so every copy on every rank is the same tensor
    value (``tests/test_torch_spmd_runtime.py`` asserts it after a walk).
    The rank's first chunk keeps its copy; every further chunk gets a clone
    (AdamW updates in place).

    ``state`` is consumed.  Returns ``(new state, stats)``: the layers and
    bytes this rank sent and received, the rounds, and the seconds of the
    rank's transfer spans (staging, blocked in receives and sends)."""
    lists = _stage_lists(state)
    S, me = group.S, group.s
    v_from, v_to = place_from.vstage_of.shape[1], place_to.vstage_of.shape[1]
    if len(lists[0]) != v_from:
        raise ValueError(f"rank {group.rank} holds {len(lists[0])} chunks; the placement has v={v_from}")
    stats = {"layers_sent": 0, "layers_received": 0, "bytes_sent": 0, "bytes_received": 0, "rounds": 0}
    if np.array_equal(place_from.vstage_of, place_to.vstage_of):
        return state, stats
    num_layers = len(lists[0][0]["layers"]) * S * v_from
    homes_from, homes_to = _layer_homes(place_from, num_layers), _layer_homes(place_to, num_layers)
    if (num_layers // (S * v_to)) % period:
        raise ValueError(f"{num_layers // (S * v_to)} layers a virtual stage do not tile the layer pattern of {period}")
    held: dict[int, list] = {}  # layer -> its tree in each list
    for g, (s, c, i) in enumerate(homes_from):
        if s == me:
            held[g] = [lst[c]["layers"][i] for lst in lists]
    # one layer of each pattern position: the shapes and dtypes of what arrives
    templates = {g % period: [tree_map(lambda t: (t.shape, t.dtype), t) for t in trees] for g, trees in held.items()}
    new = [  # the old chunk trees' keys, in their order
        [{grp: [None] * (num_layers // (S * v_to)) if grp == "layers" else
          tree_map(torch.clone, lst[0][grp]) if c else lst[0][grp] for grp in lst[0]} for c in range(v_to)]
        for lst in lists
    ]
    for g, (s, c, i) in enumerate(homes_to):
        if s == me and homes_from[g][0] == me:
            for lst, tree in zip(new, held[g]):
                lst[c]["layers"][i] = tree
    moves = [(g, homes_from[g][0], homes_to[g][0]) for g in range(num_layers) if homes_from[g][0] != homes_to[g][0]]
    for rnd in _rounds(moves):
        out = next(((g, dst) for g, src, dst in rnd if src == me), None)
        into = next(((g, src) for g, src, dst in rnd if dst == me), None)
        if out is None and into is None:
            continue
        sends, recvs = [], []
        if out is not None:
            bufs = _pack([t for tree in held[out[0]] for t in flatten(tree).values()])
            sends = [(b, out[1], _RESTACK_TAG + j) for j, b in enumerate(bufs)]
            stats["layers_sent"] += 1
            stats["bytes_sent"] += sum(b.numel() * b.element_size() for b in bufs)
            del bufs
        if into is not None:
            shapes = [sd for tree in templates[into[0] % period] for sd in flatten(tree).values()]
            recvs = [((n,), dtype, into[1], _RESTACK_TAG + j)
                     for j, (dtype, n) in enumerate(_dtype_sizes(shapes).items())]
        stats["rounds"] += 1
        handles = group.exchange(sends, recvs)
        if into is not None:
            # a block a leaf, as the sent layers' were, so the allocator reuses
            # their freed blocks: leaves left as views of one buffer held 7-12
            # GiB more reserved a card over a v-changing switch at GPT-2.7B
            got = iter([t.clone() for t in _unpack([h.wait() for h in handles], shapes)])
            _, c, i = homes_to[into[0]]
            for lst, tmpl in zip(new, templates[into[0] % period]):
                lst[c]["layers"][i] = tree_map(lambda _: next(got), tmpl)
            stats["layers_received"] += 1
            stats["bytes_received"] += sum(math.prod(shape) * dtype.itemsize for shape, dtype in shapes)
        group.wait_sends()
        del sends
        if out is not None:  # the send is done: drop the layer from the old state
            _, c, i = homes_from[out[0]]
            for lst in lists:
                lst[c]["layers"][i] = None
            del held[out[0]]
    synchronize(group.device)
    stats.update(group.take_seconds())
    return _with_lists(state, iter(new)), stats


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
    #: spmd backend, on global rank 0: each rank's restack record (its
    #: seconds, and the layers and bytes it sent and received)
    ranks: "list[dict] | None" = None


@dataclasses.dataclass
class IterationResult:
    index: int
    plan_name: str
    kind: str
    loss: float
    seconds: float
    #: spmd backend, on global rank 0: each rank's record of the step (its
    #: breakdown in seconds, and what the runtime's ``rank_probe`` read)
    ranks: "list[dict] | None" = None


class PlanRuntime:
    """Owns the parameters and optimizer state; runs and hot-swaps steps.

    ``backend="spmd"`` needs ``group``, the calling rank's
    :class:`~repro_torch.pipeline.ranks.RankGroup`; every rank builds its
    runtime with the same arguments.  With ``optimizer=None`` (stateless,
    ``program_factory`` required) every rank calls ``switch_to`` and
    ``run_program`` itself, as ``repro``'s stateless runtime is called: a
    switch tracks the layout and restacks nothing, and ``run_iteration``
    raises.  ``rank_probe`` (spmd) is called on
    every rank after each step; its dict joins the rank's record in
    :attr:`IterationResult.ranks`.

    ``cache`` may be a :class:`CompiledStepCache` borrowed from another
    runtime of the same config, as ``repro``'s fleets share one across
    hosts: a reference-backend step closes over the plan, its frozen
    ``StagedModel`` and the stateless optimizer only, so it is a pure
    function of (state, batch) that any such runtime can run.  A borrowed
    cache keeps its owner's factory and registry."""

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
        obs_track: str = "runtime",
        program_factory=None,
        device=None,
        group=None,
        rank_probe: Callable[[], dict] | None = None,
        cache: CompiledStepCache | None = None,
    ) -> None:
        if backend not in ("reference", "spmd"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "spmd":
            if group is None:
                raise ValueError(
                    "the spmd backend needs a rank group (the RankGroup that "
                    "repro_torch.pipeline.ranks.spawn gives each rank), as repro's needs a mesh"
                )
            if group.S != num_stages:
                raise ValueError(f"{num_stages} stages, the rank group has {group.S}")
        self.cfg = cfg
        self.num_stages = num_stages
        self.optimizer = optimizer
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.backend = backend
        self.telemetry = telemetry
        self.group = group if backend == "spmd" else None
        self.device = group.device if self.group is not None else resolve_device(device)
        self.rank_probe = rank_probe
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
            # the flat layout: every stage (reference) or this rank's stage
            owned = range(num_stages) if self.group is None else [self.group.s]
            params = self.staged_for(1).init_stages(torch.Generator(device=self.device).manual_seed(init_key), owned)
            self.state: TrainState = create_train_state(params, optimizer)
        self.current_v = 1
        #: the placement the owned state is laid out in (the flat layout's at first)
        self.placement = Placement.build("kfkb", num_stages, 1)
        # a fresh cache joins the shared registry, its series labelled by
        # track; a borrowed cache keeps whatever registry its owner gave it
        self.cache = cache or CompiledStepCache(
            program_factory or self._program_for,
            metrics=obs.metrics if obs is not None else None,
            labels={"track": obs_track} if obs is not None else None,
        )
        self.current_table: TabularPlan | None = None
        self._compiled = None
        self.switch_events: list[SwitchEvent] = []
        self.iterations: list[IterationResult] = []
        self.last_grads = None
        self._grads_placement = self.placement  # the layout last_grads are in
        # observability (optional): trace spans on "{obs_track}/switches" and
        # "{obs_track}/iterations", registry series, flight plan_switch events
        self.obs = obs
        self.obs_track = obs_track
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
        walks (under spmd, the rank's channel tables), and launches no device
        work (it runs on the background worker).

        The step consumes and produces the plan's OWN layout; restacking at
        switch time is the runtime's job.  Under spmd it is
        ``training.pipeline_train_step``'s body (the engine, then the
        optimizer on the rank's chunks) that also returns the gradients."""
        plan = table.plan
        M = plan.num_microbatches
        if self.global_batch % M:
            raise ValueError(f"plan {plan.name} needs M={M} | global_batch={self.global_batch}")
        staged = self.staged_for(plan.num_virtual)
        plan.lower(), plan.placement  # both cached on the plan: derived here, off the switch path
        optimizer = self.optimizer
        if self.group is None:
            def grads_fn(params, tokens, labels):
                return reference_pipeline_grads(staged, params, tokens, labels, plan)
        else:
            grads_fn = make_pipeline_step(staged, plan, self.group)

        def step(state: TrainState, tokens, labels):
            loss, grads = grads_fn(state.params, tokens, labels)
            params, opt_state, _ = optimizer.update(state.params, grads, state.opt_state)
            state.step, state.params, state.opt_state = state.step + 1, params, opt_state
            return state, loss, grads

        step.grads_fn = grads_fn
        return step

    # -- the ranks (spmd) ------------------------------------------------------

    @property
    def leads(self) -> bool:
        """This runtime drives the others: the reference backend's, and
        global rank 0's under spmd."""
        return self.group is None or self.group.rank == 0

    def _lead(self, method: str, *args) -> None:
        """On global rank 0 under spmd: tell the followers to call ``method``
        with ``args`` (what :meth:`follow` executes).  A stateless runtime
        leads nobody: every rank calls each method itself, with its own
        operands."""
        if self.group is not None and self.group.rank == 0 and self.state is not None:
            self.group.broadcast_object((method, args))

    def follow(self, batch_fn: Callable[[int], tuple]) -> None:
        """A follower's loop (spmd, global ranks > 0): call each method global
        rank 0 calls, in its order, until :meth:`stop`.  ``batch_fn(i)``
        returns this rank's ``(tokens, labels)`` of batch ``i``, the batch
        rank 0 draws for that index (no tokens travel)."""
        if self.leads:
            raise RuntimeError("global rank 0 leads; only the other ranks follow")
        while True:
            method, args = self.group.broadcast_object()
            if method == "stop":
                return
            if method in ("run_iteration", "grads_at"):
                (i,) = args
                getattr(self, method)(*batch_fn(i), batch_index=i)
            else:
                getattr(self, method)(*args)

    def stop(self) -> None:
        """Global rank 0 (spmd): end the followers' :meth:`follow` loops."""
        self._lead("stop")

    # -- the warm switch path -------------------------------------------------

    def precompile(self, tables) -> int:
        """Build the step programs of ``tables`` on the background worker (on
        every rank).  A restack has nothing to build."""
        tables = list(tables)
        self._lead("precompile", tables)
        return self.cache.precompile(tables)

    def switch_to(self, table: TabularPlan) -> SwitchEvent:
        """Dispatch a new plan at an iteration boundary.

        Warm path: the step is already built -> fetch + (if the layout
        changed) bitwise restack + pointer swap.  The cold path also pays
        the synchronous build, recorded apart so that it does not pollute
        the warm latency.  Under spmd every rank switches, between two
        barriers, and rank 0's clock times the whole switch."""
        self._lead("switch_to", table)
        warm = self.cache.contains(table)
        sp = (
            self.obs.trace.span(
                f"{self.obs_track}/switches",
                f"switch {table.plan.name}",
                to_plan=table.plan.name,
                warm=warm,
            )
            if self.obs is not None
            else None
        )
        if self.group is not None:
            self.group.barrier()
        t0 = time.perf_counter()
        entry = self.cache.get(table)
        t1 = time.perf_counter()
        v_new = table.plan.num_virtual
        # stateless runtimes track the layout but have no owned state to restack
        restacked = v_new != self.current_v and self.state is not None
        record = None
        if self.group is not None and self.state is None:
            record = {"rank": self.group.rank}
            self.group.barrier()
        elif self.group is not None:
            t = time.perf_counter()
            self.state, record = restack_across_ranks(
                self.state, self.group, self.placement, table.plan.placement, len(self.staged_for(v_new).pattern)
            )
            record = {"rank": self.group.rank, "seconds": time.perf_counter() - t, **record}
            self.group.barrier()
        elif restacked:
            self.state = restack_train_state(self.state, self.num_stages, self.current_v, v_new)
            synchronize(self.device)
        self.current_v = v_new
        self.placement = table.plan.placement
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
            ranks=self.group.gather_object(record) if self.group is not None else None,
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

    def _microbatches(self, tokens, labels):
        """``[global_batch, T]`` data as the current plan's ``[M, b, T]`` grid."""
        if self.current_table is None:
            raise RuntimeError("no plan dispatched; call switch_to first")
        M = self.current_table.plan.num_microbatches
        shape = (M, self.global_batch // M, self.seq_len)
        return (torch.as_tensor(x, device=self.device).reshape(shape) for x in (tokens, labels))

    def _batch_index(self, batch_index):
        if self.group is not None and self.leads and batch_index is None:
            raise ValueError("under spmd, rank 0 names the batch (batch_index) that every rank draws")
        return batch_index

    def run_iteration(self, tokens, labels, batch_index: int | None = None) -> IterationResult:
        """One training step of the current plan on ``[global_batch, T]``
        data (reshaped to the plan's ``[M, b, T]`` micro-batch grid).  The
        previous step's gradients are released first, so that no two
        gradient sets are live at once.  Under spmd, ``batch_index`` names
        the batch every rank draws, and the step is timed barrier to
        barrier."""
        if self.state is None:
            raise RuntimeError("stateless serving runtime owns no TrainState; use run_program")
        tokens, labels = self._microbatches(tokens, labels)
        self._lead("run_iteration", self._batch_index(batch_index))
        plan = self.current_table.plan
        self.last_grads = None
        sp = (
            self.obs.trace.span(
                f"{self.obs_track}/iterations",
                f"iter {len(self.iterations)} {plan.name}",
                plan=plan.name,
                index=len(self.iterations),
            )
            if self.obs is not None
            else None
        )
        g = self.group
        if g is not None:
            g.barrier()
        synchronize(self.device)
        t0 = time.perf_counter()
        state, loss, grads = self._compiled(self.state, tokens, labels)
        synchronize(self.device)
        record = None
        if g is not None:  # the rank's breakdown; "other" is the optimizer and the host
            items = dict(g.take_seconds())
            items["other"] = (time.perf_counter() - t0) - sum(items.values())
            g.barrier()
            record = {"rank": g.rank, "stage": g.s, "seconds": items}
        loss = float(loss)
        seconds = time.perf_counter() - t0
        self.state = state
        self.last_grads, self._grads_placement = grads, self.placement
        if record is not None:
            record.update(self.rank_probe() if self.rank_probe is not None else {})
        result = IterationResult(
            index=len(self.iterations),
            plan_name=plan.name,
            kind=plan.kind,
            loss=loss,
            seconds=seconds,
            ranks=g.gather_object(record) if g is not None else None,
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
        per run on ``{obs_track}/iterations``.  Returns ``(outputs, seconds)``."""
        if self._compiled is None:
            raise RuntimeError("no plan dispatched; call switch_to first")
        plan = self.current_table.plan
        sp = (
            self.obs.trace.span(
                f"{self.obs_track}/iterations",
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
    #
    # Under spmd each of these is called on every rank (rank 0 leads) and
    # gathers to global rank 0; the other ranks get None.

    def _gather(self, what: str):
        """The owned ``"state"`` or the last step's ``"grads"`` in the layout
        they were made in: under spmd gathered to rank 0 in global
        virtual-stage order (None elsewhere)."""
        if what == "state":
            if self.group is None:
                return self.state
            return bridge.gather_train_state_to_rank0(self.state, self.placement, self.group)
        if self.group is None or self.last_grads is None:
            return self.last_grads
        return bridge.gather_to_rank0(self.last_grads, self._grads_placement, self.group)

    def state_in_flat_layout(self) -> TrainState | None:
        """The owned state restacked to the canonical flat (v=1) layout: what
        cross-kind comparisons consume.  The reference backend's shares
        tensors with the owned state; do not train on both."""
        self._lead("state_in_flat_layout")
        state = self._gather("state")
        return None if state is None else restack_train_state(state, self.num_stages, self.current_v, 1)

    def grads_in_flat_layout(self) -> Any:
        """The last step's gradients in the flat layout (None after a new
        step has started or before the first)."""
        self._lead("grads_in_flat_layout")
        grads = self._gather("grads")
        if grads is None:
            return None
        return restack_train_state(grads, self.num_stages, self._grads_placement.vstage_of.shape[1], 1)

    def grads_at(self, tokens, labels, batch_index: int | None = None):
        """The current plan's engine on the owned parameters and ``[global_batch,
        T]`` data, with no update: ``(loss, gradients in the flat layout)``,
        under spmd on rank 0 (``None`` elsewhere; ``batch_index`` as in
        :meth:`run_iteration`).  The last step's gradients stay
        (:meth:`free_optimizer_state` releases them)."""
        tokens, labels = self._microbatches(tokens, labels)
        self._lead("grads_at", self._batch_index(batch_index))
        loss, grads = self._compiled.grads_fn(self.state.params, tokens, labels)
        loss = float(loss)
        if self.group is not None:
            grads = bridge.gather_to_rank0(grads, self.placement, self.group)
        if grads is None:
            return None
        return loss, restack_train_state(grads, self.num_stages, self.current_v, 1)

    def free_optimizer_state(self) -> None:
        """Drop the optimizer state and the last gradients (on every rank),
        to make room for a check; the runtime cannot train after it."""
        self._lead("free_optimizer_state")
        self.state.opt_state = self.last_grads = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    @property
    def mean_iteration_seconds(self) -> float:
        if not self.iterations:
            return 0.0
        return sum(r.seconds for r in self.iterations) / len(self.iterations)
