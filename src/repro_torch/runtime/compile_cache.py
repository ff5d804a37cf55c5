"""Step-program cache: a plan switch never waits on building the step.

Port of ``repro/runtime/compile_cache.py``.  In the original a pipeline
step is traced and compiled by XLA, which easily dwarfs an iteration, so
the cache compiles ahead of time off the switch path.  The port's step is
eager PyTorch: there is nothing to lower or compile, and the factory's own
work is the "compile": it builds the plan's ``StagedModel``, lowers the
table and derives its placement, and returns the step callable.  The
cache keeps everything else of the original:

* entries are keyed by the **lowered plan identity**
  (:meth:`CompiledStepCache.plan_key`: the schedule coordinates plus a
  digest of the tabular grid, so a ``+Wopt``-refined lowering and its base
  plan are distinct entries while re-lowering the same plan is a hit);
* :meth:`precompile` runs the factory on a background worker thread, so
  the tuner's top-N candidates are ready while training continues under
  the current plan (the factory launches no device work, so the worker
  never touches the card);
* :meth:`get` (the switch path) returns a ready entry (warm hit), waits
  for an in-flight background build (precompile hit), or builds
  synchronously as the last resort (cold miss, counted against the hit
  rate).

The cache is engine-agnostic: it is constructed with a ``program_factory``
returning the step callable for a given
:class:`~repro_torch.core.schedule.TabularPlan`.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Iterable

from repro_torch.core.schedule import TabularPlan
from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["CompiledEntry", "CacheStats", "CompiledStepCache"]


@dataclasses.dataclass
class CompiledEntry:
    key: tuple
    compiled: Any  # the step callable the factory returned
    compile_seconds: float
    source: str  # "precompile" | "demand"


@dataclasses.dataclass
class CacheStats:
    """Back-compat aggregate view; the live counters are registry series
    (``cache_*_total`` on :attr:`CompiledStepCache.metrics`) and
    :attr:`CompiledStepCache.stats` materializes this dataclass from them."""

    gets: int = 0
    warm_hits: int = 0  # entry ready at get() time
    inflight_hits: int = 0  # background compile already running; get() joined it
    cold_misses: int = 0  # nothing in flight: compiled synchronously
    precompile_requests: int = 0
    precompiled: int = 0  # background compiles completed

    @property
    def hit_rate(self) -> float:
        """Fraction of dispatches served by the precompile pipeline (ready
        or in flight) rather than a synchronous cold compile."""
        return (self.warm_hits + self.inflight_hits) / self.gets if self.gets else 0.0


class CompiledStepCache:
    def __init__(
        self,
        program_factory: Callable[[TabularPlan], Callable],
        metrics: MetricsRegistry | None = None,
        labels: dict[str, str] | None = None,
    ) -> None:
        self._factory = program_factory
        self._lock = threading.Lock()
        self._entries: dict[tuple, CompiledEntry] = {}
        self._inflight: dict[tuple, Future] = {}
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="plan-precompile")
        self.metrics = metrics or MetricsRegistry()
        # ``labels`` scope this cache's series on a SHARED registry (a serve
        # engine's runtime beside a training one) so per-cache stats stay
        # per-cache while every number lives in one place
        self._labels = dict(labels or {})
        self._gets = self.metrics.counter("cache_gets_total")
        self._warm = self.metrics.counter("cache_warm_hits_total")
        self._joined = self.metrics.counter("cache_inflight_hits_total")
        self._cold = self.metrics.counter("cache_cold_misses_total")
        self._requests = self.metrics.counter("cache_precompile_requests_total")
        self._done = self.metrics.counter("cache_precompiled_total")
        self._compile_s = self.metrics.histogram("cache_compile_seconds")

    @property
    def stats(self) -> CacheStats:
        """Aggregate view assembled from the registry counters; the dataclass
        shape (and ``dataclasses.asdict``-ability) is unchanged from when it
        was mutable state."""
        return CacheStats(
            gets=int(self._gets.value(**self._labels)),
            warm_hits=int(self._warm.value(**self._labels)),
            inflight_hits=int(self._joined.value(**self._labels)),
            cold_misses=int(self._cold.value(**self._labels)),
            precompile_requests=int(self._requests.value(**self._labels)),
            precompiled=int(self._done.value(**self._labels)),
        )

    # -- identity -------------------------------------------------------------

    @staticmethod
    def plan_key(table: TabularPlan) -> tuple:
        """Lowered-plan identity: the plan's :class:`ScheduleSpec` (the
        same frozen coordinate currency candidates and tuning records
        carry) + shape + grid digest.

        Two plans with the same coordinates but different lowerings (e.g. a
        ``+Wopt`` refinement) must not share an executable — the engine's
        unrolled tick program IS the grid."""
        p = table.plan
        digest = hashlib.sha1(table.grid.tobytes()).hexdigest()[:16]
        return (
            p.name,
            p.spec,
            p.num_stages,
            p.num_microbatches,
            digest,
        )

    # -- compilation ----------------------------------------------------------

    def _compile(self, table: TabularPlan, source: str) -> CompiledEntry:
        key = self.plan_key(table)
        t0 = time.perf_counter()
        compiled = self._factory(table)
        entry = CompiledEntry(
            key=key,
            compiled=compiled,
            compile_seconds=time.perf_counter() - t0,
            source=source,
        )
        with self._lock:
            self._entries[key] = entry
            self._inflight.pop(key, None)
        self._compile_s.observe(entry.compile_seconds, source=source, **self._labels)
        if source == "precompile":
            self._done.inc(**self._labels)
        return entry

    def precompile(self, tables: Iterable[TabularPlan]) -> int:
        """Submit background builds for every not-yet-known table; returns
        how many were actually submitted."""
        submitted = 0
        for table in tables:
            key = self.plan_key(table)
            with self._lock:
                if key in self._entries or key in self._inflight:
                    continue
                fut = self._pool.submit(self._compile, table, "precompile")
                self._inflight[key] = fut
                submitted += 1
            self._requests.inc(**self._labels)
        return submitted

    def get(self, table: TabularPlan) -> CompiledEntry:
        """The switch path: ready entry, else join the in-flight background
        build, else build synchronously (cold)."""
        key = self.plan_key(table)
        self._gets.inc(**self._labels)
        with self._lock:
            entry = self._entries.get(key)
            fut = None if entry is not None else self._inflight.get(key)
        if entry is not None:
            self._warm.inc(**self._labels)
            return entry
        if fut is not None:
            self._joined.inc(**self._labels)
            return fut.result()
        entry = self._compile(table, "demand")
        self._cold.inc(**self._labels)
        return entry

    def contains(self, table: TabularPlan) -> bool:
        """True iff a dispatch right now would be a warm hit."""
        with self._lock:
            return self.plan_key(table) in self._entries

    def wait_idle(self) -> None:
        """Block until every background build has finished (to measure
        genuinely warm switch latency)."""
        while True:
            with self._lock:
                futs = list(self._inflight.values())
            if not futs:
                return
            for f in futs:
                f.result()

    def shutdown(self) -> None:
        self._pool.shutdown(wait=True)
