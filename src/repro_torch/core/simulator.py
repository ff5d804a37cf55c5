"""Discrete-event simulator of a pipeline iteration under a network trace.

A copy of ``repro/core/simulator.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

Execution model (faithful to the paper's runtime, §3/§4.4/§5.3):

* each stage (device) executes its plan order **in order** — the schedule is
  decided ahead of time; kFkB's benefit is that the *static* order keeps
  locally-ready work available, not that the runtime reorders;
* a task launches when the device is free AND its cross-stage input has
  arrived (stage-0 forwards and last-stage backward inputs are always local;
  zero-bubble ``BWD_WEIGHT`` tasks are always local — their whole point is
  to absorb stalls);
* Send is issued immediately when the producing task completes ("cross stage
  communications triggered immediately after each stage computation delivers
  its outputs"), is asynchronous, and never blocks the device (§5.3);
* each *directed* link serializes its transfers FIFO under a time-varying
  bandwidth trace (two directions are independent, mirroring the separate
  send/recv NCCL streams of Fig 5);
* arrived-but-unconsumed inputs sit in the §4.4 buffer queue; we record its
  depth timeline to reproduce the Fig 4c analysis.

Any member of the schedule family runs here unchanged: the per-device
orders and transfer specs come from the task graph, which encodes the
virtual-stage topology (interleaved plans — including ``interleaved_zb`` —
route over the ``S-1 -> 0`` wrap link; links are created for whatever
directed pairs the plan actually uses).  ZB-H2's deeper warmup shows up
purely as more locally-ready forwards early on, which is exactly how it
buys preemption tolerance.

The simulator returns the pipeline length (makespan incl. optimizer
epilogue), per-device busy/stall accounting, and the queue timelines.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

from repro_torch.core.network import Network
from repro_torch.core.schedule import SchedulePlan
from repro_torch.core.taskgraph import StageCosts, TaskGraph, TransferSpec, build_task_graph

__all__ = ["SimResult", "PipelineSimulator", "simulate", "simulate_plan"]


@dataclasses.dataclass
class SimResult:
    pipeline_length: float  # makespan of one training iteration, seconds
    busy_time: list[float]  # per stage
    stall_time: list[float]  # per stage: device idle while tasks remained
    task_finish: dict[tuple[int, int, int, int], float]
    queue_timeline: dict[int, list[tuple[float, int]]]  # stage -> (t, depth)
    link_busy: dict[tuple[int, int], float]
    # per-transfer (start, finish, nbytes) in service order — what
    # repro_torch.obs.trace.render_simulated_trace turns into link tracks
    link_events: dict[tuple[int, int], list[tuple[float, float, float]]] = (
        dataclasses.field(default_factory=dict)
    )

    @property
    def bubble_fraction(self) -> float:
        total = self.pipeline_length * len(self.busy_time)
        return 1.0 - sum(self.busy_time) / total if total > 0 else 0.0


class _Link:
    """A directed link: FIFO transfer queue under a bandwidth trace."""

    def __init__(self, trace) -> None:
        self.trace = trace
        self.queue: list[TransferSpec] = []
        self.busy_until = 0.0
        self.active: TransferSpec | None = None
        self.total_busy = 0.0
        self.events: list[tuple[float, float, float]] = []  # (start, finish, nbytes)


class PipelineSimulator:
    def __init__(self, graph: TaskGraph, network: Network) -> None:
        self.graph = graph
        self.network = network
        S = graph.num_stages
        self.S = S
        self.orders = graph.plan.orders
        self.ptr = [0] * S
        self.device_busy_until = [0.0] * S
        self.device_ready_since = [0.0] * S  # when the device last became free
        self.busy_time = [0.0] * S
        self.stall_time = [0.0] * S
        self.arrived: set[tuple[int, int, int, int]] = set()
        self.task_finish: dict[tuple[int, int, int, int], float] = {}
        self.links: dict[tuple[int, int], _Link] = {}
        pairs = {
            (x.src, x.dst) for specs in graph.outgoing.values() for x in specs
        }
        for s in range(S - 1):  # the base chain always exists
            pairs.add((s, s + 1))
            pairs.add((s + 1, s))
        for src, dst in sorted(pairs):
            self.links[(src, dst)] = _Link(network.trace(src, dst))
        self.queue_timeline: dict[int, list[tuple[float, int]]] = {s: [] for s in range(S)}
        self.queue_depth = [0] * S
        self._events: list[tuple[float, int, str, object]] = []
        self._seq = itertools.count()

    # -- event plumbing ------------------------------------------------------

    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _record_queue(self, stage: int, t: float, delta: int) -> None:
        self.queue_depth[stage] += delta
        self.queue_timeline[stage].append((t, self.queue_depth[stage]))

    # -- core logic ----------------------------------------------------------

    def _input_ready(self, s: int) -> bool:
        task = self.orders[s][self.ptr[s]]
        spec = self.graph.incoming[task.key()]
        return spec is None or spec.key in self.arrived

    def _try_dispatch(self, s: int, now: float) -> None:
        if self.ptr[s] >= len(self.orders[s]):
            return
        if self.device_busy_until[s] > now:
            return
        if not self._input_ready(s):
            return
        task = self.orders[s][self.ptr[s]]
        self.ptr[s] += 1
        spec = self.graph.incoming[task.key()]
        if spec is not None:
            self._record_queue(s, now, -1)  # consume the queued input
        stall = now - self.device_ready_since[s]
        if stall > 0:
            self.stall_time[s] += stall
        dur = self.graph.task_time(task)
        finish = now + dur
        self.busy_time[s] += dur
        self.device_busy_until[s] = finish
        self._push(finish, "task_done", task)

    def _start_link(self, link_key: tuple[int, int], now: float) -> None:
        link = self.links[link_key]
        if link.active is not None or not link.queue:
            return
        xfer = link.queue.pop(0)
        link.active = xfer
        start = max(now, link.busy_until)
        finish = link.trace.finish_time(start, xfer.nbytes)
        link.busy_until = finish
        link.total_busy += finish - start
        link.events.append((start, finish, xfer.nbytes))
        self._push(finish, "xfer_done", (link_key, xfer))

    def run(self) -> SimResult:
        g = self.graph
        now = 0.0
        for s in range(self.S):
            self._try_dispatch(s, 0.0)
        while self._events:
            now, _, kind, payload = heapq.heappop(self._events)
            if kind == "task_done":
                task = payload
                s = task.stage
                self.task_finish[task.key()] = now
                self.device_ready_since[s] = now
                for xfer in g.outgoing[task.key()]:
                    self.links[(xfer.src, xfer.dst)].queue.append(xfer)
                    self._start_link((xfer.src, xfer.dst), now)
                self._try_dispatch(s, now)
            elif kind == "xfer_done":
                link_key, xfer = payload
                self.links[link_key].active = None
                self.arrived.add(xfer.key)
                self._record_queue(xfer.dst, now, +1)
                self._start_link(link_key, now)
                self._try_dispatch(xfer.dst, now)
        # every task must have executed
        for s in range(self.S):
            assert self.ptr[s] == len(self.orders[s]), (
                f"deadlock: stage {s} stuck at task {self.ptr[s]}/{len(self.orders[s])}"
            )
        # optimizer epilogue per stage (grad-accum finalize + apply)
        length = 0.0
        for s in range(self.S):
            last = max(
                self.task_finish[t.key()] for t in self.orders[s]
            )
            length = max(length, last + g.costs.optimizer_time[s])
        return SimResult(
            pipeline_length=length,
            busy_time=self.busy_time,
            stall_time=self.stall_time,
            task_finish=self.task_finish,
            queue_timeline=self.queue_timeline,
            link_busy={k: l.total_busy for k, l in self.links.items()},
            link_events={k: l.events for k, l in self.links.items() if l.events},
        )


def simulate(graph: TaskGraph, network: Network) -> SimResult:
    return PipelineSimulator(graph, network).run()


def simulate_plan(plan: SchedulePlan, costs: StageCosts, network: Network) -> SimResult:
    return simulate(build_task_graph(plan, costs), network)
