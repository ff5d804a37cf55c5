"""FIFO request queue + continuous batcher over fixed decode slots.

A copy of ``repro/serve/batching.py``; only the import of ``Request``
points at this package.

Continuous batching at iteration boundaries: the in-flight batch keeps
stepping the KV cache through the pipeline every tick, and only *between*
ticks does membership change — finished requests retire first, then queued
requests are admitted FIFO into the freed slots.  Invariants the tests hold:

* **retire-before-admit** — a boundary never admits into a slot that still
  holds a finished request (:meth:`ContinuousBatcher.admit` refuses to run
  while a finished request occupies a slot);
* **bounded occupancy** — never more than ``max_slots`` in flight;
* **no starvation** — admission is strictly FIFO off the queue, so any
  queued request is admitted after at most the requests ahead of it.

Slots are the unit of trace visualization too: request lifecycle spans land
on per-slot tracks (``hostN/requests/slotJ``), which makes them pairwise
disjoint by construction — one slot holds one request at a time — so the
existing no-overlap trace gate validates serving timelines unchanged.
"""

from __future__ import annotations

import collections
import dataclasses

from repro_torch.serve.arrival import Request

__all__ = ["InFlight", "RequestQueue", "ContinuousBatcher"]


@dataclasses.dataclass
class InFlight:
    """A request occupying a decode slot, plus its emission bookkeeping."""

    request: Request
    slot: int
    admit_time: float
    first_token_time: float | None = None  # set when prefill emits token 0
    last_token_time: float | None = None
    tokens_emitted: int = 0

    @property
    def done(self) -> bool:
        return self.tokens_emitted >= self.request.max_new_tokens


class RequestQueue:
    """Strict FIFO admission queue."""

    def __init__(self) -> None:
        self._q: collections.deque[Request] = collections.deque()
        self.total_enqueued = 0

    def push(self, req: Request) -> None:
        self._q.append(req)
        self.total_enqueued += 1

    def pop(self) -> Request:
        return self._q.popleft()

    def peek(self) -> Request | None:
        return self._q[0] if self._q else None

    def __len__(self) -> int:
        return len(self._q)


class ContinuousBatcher:
    """Fixed ``max_slots`` decode slots; membership changes only at
    boundaries via ``retire_finished`` then ``admit``."""

    def __init__(self, max_slots: int) -> None:
        if max_slots <= 0:
            raise ValueError(f"max_slots must be positive, got {max_slots}")
        self.max_slots = max_slots
        self._slots: list[InFlight | None] = [None] * max_slots
        self.total_admitted = 0
        self.total_retired = 0

    @property
    def occupancy(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def in_flight(self) -> list[InFlight]:
        return [s for s in self._slots if s is not None]

    def retire_finished(self, now: float) -> list[InFlight]:
        """Free every slot whose request has emitted its full budget."""
        done = []
        for i, inf in enumerate(self._slots):
            if inf is not None and inf.done:
                done.append(inf)
                self._slots[i] = None
        self.total_retired += len(done)
        return done

    def admit(self, queue: RequestQueue, now: float) -> list[InFlight]:
        """FIFO-admit queued requests into free slots.  Must follow
        ``retire_finished`` at the same boundary: admitting past a finished
        request would let it squat a slot another request needs."""
        if any(inf is not None and inf.done for inf in self._slots):
            raise RuntimeError(
                "admit() before retire_finished(): a finished request still "
                "occupies a slot at this boundary"
            )
        admitted = []
        for i in range(self.max_slots):
            if self._slots[i] is None and len(queue):
                inf = InFlight(request=queue.pop(), slot=i, admit_time=now)
                self._slots[i] = inf
                admitted.append(inf)
        self.total_admitted += len(admitted)
        return admitted
