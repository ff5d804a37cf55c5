"""Coordinator: drives training iterations under the currently-chosen plan.

A copy of ``repro/core/coordinator.py`` for the port: the standard library
and numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py``
holds it equal to the original on the same inputs.

The paper's coordinator dispatches the decided plan to all workers and swaps
plans with minimal overhead.  Here the coordinator advances a *simulated
cluster* iteration by iteration: every iteration executes the current plan's
task graph against the ground-truth network traces (whose state depends on
wall-clock simulated time — phase matters under periodic preemption), and at
the configured interval it invokes the auto-tuner, applying plan switches
immediately.

Its two extension points are the typed control-plane protocols of
:mod:`repro_torch.core.interfaces` (previously a
duck-typed ``telemetry=`` object and a bare ``on_iteration`` callable):

* ``telemetry_sink`` — a :class:`~repro_torch.core.interfaces.TelemetrySink`
  (e.g. :class:`repro_torch.runtime.telemetry.TelemetryBus`); every simulated
  iteration's observed length is published so passive subscribers can keep
  the :class:`~repro_torch.core.profiler.NetworkProfiler` windows fresh.
* ``hooks`` — :class:`~repro_torch.core.interfaces.IterationHook` participants
  whose ``on_iteration(rec)`` runs after every iteration.  That is where
  :class:`repro_torch.runtime.harness.RealEngineHarness` attaches the live
  plan-switch runtime (compiled-step cache + warm kind switches), closing
  the adaptive loop on real gradients.

The legacy kwargs (``telemetry=`` object, ``on_iteration=`` bare callable)
still work through shims that emit :class:`DeprecationWarning` and adapt to
the typed forms; new call sites must use the protocols (a grep gate keeps
in-repo callers migrated).

One more refinement (default-off, preserving the paper's behaviour): the
charged ``tuning_overhead`` is scaled by each round's
``TuningRecord.probe_fraction`` — with a passive tuner
(``passive_staleness``) and fresh windows, no link is actually probed and
the suspension cost goes to ~0 (§5.4's "minimal overhead", measured).

This is also the harness the Fig-10 experiment uses.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

from repro_torch.core.candidates import Candidate
from repro_torch.core.interfaces import IterationHook, TelemetrySink
from repro_torch.core.network import Network
from repro_torch.core.simulator import simulate_plan
from repro_torch.core.tuner import AutoTuner, TuningRecord

__all__ = ["IterationRecord", "RunSummary", "Coordinator", "shifted_network"]


@dataclasses.dataclass
class IterationRecord:
    index: int
    start: float
    length: float
    plan_name: str
    k: int
    samples_per_s: float


@dataclasses.dataclass
class RunSummary:
    iterations: list[IterationRecord]
    tuning: list[TuningRecord]
    total_time: float
    total_samples: int
    # wall-clock actually spent suspended in probe rounds (already included
    # in total_time); ~0 when passive telemetry keeps the windows fresh
    total_tuning_overhead: float = 0.0

    @property
    def throughput(self) -> float:
        return self.total_samples / self.total_time if self.total_time else 0.0


class _ShiftedTrace:
    """View of a trace starting at absolute time ``t0`` (simulator runs at 0)."""

    def __init__(self, base, t0: float) -> None:
        self.base = base
        self.t0 = t0

    def bw_at(self, t: float):
        bw, until = self.base.bw_at(self.t0 + t)
        return bw, until - self.t0

    def finish_time(self, start: float, nbytes: float) -> float:
        return self.base.finish_time(self.t0 + start, nbytes) - self.t0

    def mean_bw(self, a: float, b: float) -> float:
        return self.base.mean_bw(self.t0 + a, self.t0 + b)


def shifted_network(net: Network, t0: float) -> Network:
    """The network as seen from absolute simulated time ``t0`` — what lets a
    caller evaluate ``simulate_plan`` (which runs at t=0) mid-regime.  Shared
    by the training coordinator's iteration loop and the serve runtime's tick
    loop."""
    return Network(
        default=_ShiftedTrace(net.default, t0),
        links={k: _ShiftedTrace(v, t0) for k, v in net.links.items()},
    )


_shifted_network = shifted_network  # internal callers predate the public name


class _CallableHook:
    """Adapter giving a bare ``Callable[[IterationRecord], None]`` the
    :class:`IterationHook` shape (the legacy ``on_iteration=`` shim)."""

    def __init__(self, fn: Callable[[IterationRecord], object]) -> None:
        self._fn = fn

    def on_iteration(self, rec: IterationRecord) -> object:
        return self._fn(rec)


class Coordinator:
    def __init__(
        self,
        tuner: AutoTuner,
        network: Network,
        global_batch: int,
        tuning_interval: float,
        tuning_overhead: float = 0.0,
        hooks: Sequence[IterationHook] = (),
        telemetry_sink: TelemetrySink | None = None,
        **legacy,
    ) -> None:
        self.tuner = tuner
        self.network = network
        self.global_batch = global_batch
        self.tuning_interval = tuning_interval
        self.tuning_overhead = tuning_overhead
        self.hooks: list[IterationHook] = list(hooks)
        self.telemetry_sink = telemetry_sink
        # -- legacy shims (before the typed protocols) -----------------------
        # telemetry=<duck-typed bus> and on_iteration=<bare callable> predate
        # the typed protocols; both still work, warn, and adapt.
        if "telemetry" in legacy:
            warnings.warn(
                "Coordinator(telemetry=...) is deprecated; pass the typed "
                "telemetry_sink= (any repro_torch.core.interfaces.TelemetrySink)",
                DeprecationWarning,
                stacklevel=2,
            )
            shimmed = legacy.pop("telemetry")
            if shimmed is not None:
                if self.telemetry_sink is not None:
                    raise ValueError("pass telemetry_sink= or telemetry=, not both")
                self.telemetry_sink = shimmed
        if "on_iteration" in legacy:
            warnings.warn(
                "Coordinator(on_iteration=<callable>) is deprecated; pass "
                "hooks=[...] of repro_torch.core.interfaces.IterationHook "
                "participants (objects with an on_iteration method)",
                DeprecationWarning,
                stacklevel=2,
            )
            fn = legacy.pop("on_iteration")
            if fn is not None:
                self.hooks.append(
                    fn if isinstance(fn, IterationHook) else _CallableHook(fn)
                )
        if legacy:
            raise TypeError(f"unknown Coordinator kwargs: {sorted(legacy)}")

    def run(self, num_iterations: int, tune_first: bool = True) -> RunSummary:
        now = 0.0
        iters: list[IterationRecord] = []
        overhead_total = 0.0
        next_tune = 0.0 if tune_first else self.tuning_interval
        for i in range(num_iterations):
            if now >= next_tune:
                rec_t = self.tuner.tune(now)
                # suspension is only paid for the probes actually run: a
                # passive tuner with fresh windows charges ~0 (§5.4)
                frac = getattr(rec_t, "probe_fraction", 1.0)
                charged = self.tuning_overhead * frac
                now += charged
                overhead_total += charged
                next_tune = now + self.tuning_interval
            cand: Candidate = self.tuner.current
            costs = self.tuner.stage_costs_for(cand)
            result = simulate_plan(cand.plan, costs, _shifted_network(self.network, now))
            rec = IterationRecord(
                index=i,
                start=now,
                length=result.pipeline_length,
                plan_name=cand.name,
                k=cand.k,
                samples_per_s=self.global_batch / result.pipeline_length,
            )
            iters.append(rec)
            if self.telemetry_sink is not None:
                self.telemetry_sink.publish_iteration(
                    index=i,
                    plan=cand.plan,
                    costs=costs,
                    seconds=result.pipeline_length,
                    end_time=now + result.pipeline_length,
                    source="sim",
                )
            for hook in self.hooks:
                hook.on_iteration(rec)
            now += result.pipeline_length
        return RunSummary(
            iterations=iters,
            tuning=list(self.tuner.history),
            total_time=now,
            total_samples=self.global_batch * num_iterations,
            total_tuning_overhead=overhead_total,
        )
