"""RealEngineHarness: the Fig-10 loop with real gradients.

Port of ``repro/runtime/harness.py`` (unchanged but for the imports).

The :class:`~repro_torch.core.coordinator.Coordinator` remains the clock of the
adaptive experiment — it advances simulated network time, invokes the
tuner, and applies plan switches.  This harness rides its ``on_iteration``
hook and mirrors every decision onto the live engine:

* after each tuning round it ranks the candidates by the round's estimates
  and submits the top-N lowered tables for **background precompilation**
  (so the next switch dispatches an already-built step — the hit rate
  the benchmark trajectory gates on);
* when the tuner's dispatched table changes, it performs the runtime's
  warm switch (:meth:`PlanRuntime.switch_to` — re-stacking layouts across
  kind boundaries, optimizer state carried bitwise);
* it then executes ONE real training step of the current plan on the next
  data batch, so the regime experiment trains with real gradients
  end-to-end while the network world stays simulated (one card has no
  cross-stage network to preempt).

Construction precompiles the tuner's initial dispatch so even the first
iteration's step is being built while the coordinator runs its first
simulation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.coordinator import IterationRecord
from repro_torch.core.tuner import AutoTuner
from repro_torch.runtime.executor import IterationResult, PlanRuntime

__all__ = ["HarnessRecord", "RealEngineHarness"]


@dataclasses.dataclass
class HarnessRecord:
    index: int
    plan_name: str
    kind: str
    switched: bool
    loss: float
    engine_seconds: float
    sim_seconds: float


class RealEngineHarness:
    def __init__(
        self,
        runtime: PlanRuntime,
        tuner: AutoTuner,
        batch_fn: Callable[[int], tuple],
        precompile_top_n: int = 3,
    ) -> None:
        self.runtime = runtime
        self.tuner = tuner
        self.batch_fn = batch_fn
        self.precompile_top_n = precompile_top_n
        self.records: list[HarnessRecord] = []
        self._seen_tunes = 0
        # the initial dispatch target starts compiling immediately, in the
        # background, before the coordinator's first call lands
        runtime.precompile([tuner.current_table])

    def _react_to_tuning(self) -> None:
        while self._seen_tunes < len(self.tuner.history):
            rec = self.tuner.history[self._seen_tunes]
            self._seen_tunes += 1
            ranked = sorted(rec.estimates, key=rec.estimates.get)
            top = set(ranked[: self.precompile_top_n])
            tables = [c.table for c in self.tuner.candidates if c.name in top]
            # the actually-dispatched table may be a refined lowering that
            # differs from the winner candidate's own — precompile it too
            tables.append(self.tuner.current_table)
            self.runtime.precompile(tables)

    def on_iteration(self, rec: IterationRecord) -> HarnessRecord:
        """Coordinator hook: mirror decisions onto the engine, run one real
        step."""
        self._react_to_tuning()
        table = self.tuner.current_table
        switched = table is not self.runtime.current_table
        if switched:
            self.runtime.switch_to(table)
        tokens, labels = self.batch_fn(rec.index)
        result: IterationResult = self.runtime.run_iteration(tokens, labels)
        out = HarnessRecord(
            index=rec.index,
            plan_name=result.plan_name,
            kind=result.kind,
            switched=switched,
            loss=result.loss,
            engine_seconds=result.seconds,
            sim_seconds=rec.length,
        )
        self.records.append(out)
        return out

    # -- summary --------------------------------------------------------------

    @property
    def kind_switches(self) -> int:
        return sum(
            1
            for e in self.runtime.switch_events
            if e.from_kind and e.from_kind != e.to_kind
        )

    @property
    def losses(self) -> list[float]:
        return [r.loss for r in self.records]
