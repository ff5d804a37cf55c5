"""Bounded ring of structured events, auto-dumped on failure.

A copy of ``repro/obs/flight_recorder.py`` for the port: the standard
library and numpy only, nothing of ``repro``.
``tests/test_torch_adaptive.py`` holds it equal to the original on the same
inputs.

When a two-phase switch aborts or a fabric worker dies, the interesting
question is always "what led up to it" — which candidates the tuner scored
and why it rejected the rest, how each barrier epoch's PREPARE/vote/verdict
sequence unfolded, which telemetry windows merged into the incumbent view.
The :class:`FlightRecorder` keeps the last N such events in a ring (bounded,
so it is safe to leave on in production) and writes them to disk the moment
a registered trigger fires (barrier ABORT, worker exception), before the
process state unwinds.

Events are plain dicts with a ``seq`` (monotonic, assigned by the ring — the
total order survives into the dump even if clocks are coarse), a ``ts`` from
the injected clock, a ``kind`` (``tuner_decision``, ``barrier_begin``,
``barrier_vote``, ``barrier_verdict``, ``plan_switch``,
``telemetry_merge``, ...), and kind-specific payload fields.  Dumps are
deterministic JSON (sorted keys) so distributed-CI artifacts diff cleanly.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Ring buffer of structured events with failure-triggered dumps.

    ``dump_path`` (optional) is where :meth:`auto_dump` writes; callers can
    also :meth:`dump` anywhere explicitly.  ``clock`` is injected for
    deterministic tests (defaults to ``time.monotonic``).
    """

    def __init__(
        self,
        capacity: int = 256,
        dump_path: str | None = None,
        clock: Callable[[], float] | None = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.dump_path = dump_path
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._ring: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0
        self._dumps = 0

    # -- recording ------------------------------------------------------------

    def record(self, kind: str, **payload) -> dict:
        """Append one event; returns the stored dict (with seq/ts/kind)."""
        event = {"seq": 0, "ts": self.clock(), "kind": kind, **payload}
        with self._lock:
            event["seq"] = self._seq
            self._seq += 1
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(event)
        return event

    def events(self, kind: str | None = None) -> list[dict]:
        """Events currently in the ring, oldest first."""
        with self._lock:
            evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        """Events evicted by the ring bound (total over the recorder's life)."""
        with self._lock:
            return self._dropped

    # -- dumping --------------------------------------------------------------

    def to_payload(self, reason: str | None = None) -> dict:
        with self._lock:
            events = list(self._ring)
            payload = {
                "schema": "repro.flight_recorder/1",
                "reason": reason,
                "capacity": self.capacity,
                "recorded_total": self._seq,
                "dropped": self._dropped,
                "events": events,
            }
        return payload

    def dump(self, path: str, reason: str | None = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_payload(reason), f, sort_keys=True, indent=1,
                      default=str)
            f.write("\n")

    def auto_dump(self, reason: str) -> str | None:
        """Failure hook: write to ``dump_path`` if configured.  Called by the
        coordinator on barrier ABORT and by workers on step failure; never
        raises (a broken disk must not mask the original failure).  Returns
        the path written, or None."""
        if not self.dump_path:
            return None
        try:
            self.dump(self.dump_path, reason=reason)
        except OSError:
            return None
        with self._lock:
            self._dumps += 1
        return self.dump_path

    @property
    def dumps_written(self) -> int:
        with self._lock:
            return self._dumps
