"""Ranks: one process per pipeline stage (times the data-parallel width).

The counterpart of ``repro``'s device mesh (``jax.make_mesh((S,), ("stage",))``
or ``((S, D), ("stage", "data"))``) and of the collectives ``shard_map``
gives its body.  :func:`spawn` starts ``S * D`` processes, each of which
joins one ``torch.distributed`` world and receives a :class:`RankGroup`:
its stage index ``s``, its data index ``d`` (global rank ``d * S + s``), the
process group over the ``S`` stages of its replica and the one over the
``D`` replicas of its stage, its device, and the transport.

**The transport rule** (:func:`choose_transport`, printed in every summary,
never changed after a failure): ``nccl`` with device tensors when the ranks
run on CUDA and every rank has a card of its own; otherwise ``gloo``, with
CUDA payloads staged through pinned host buffers (gloo's send and receive
take CPU tensors).  An NCCL initialisation that fails raises; nothing falls
back to gloo.  On one card the ranks share it by time-slicing (no MPS).

Point-to-point traffic goes through :meth:`RankGroup.exchange`: one batch
of non-blocking sends and receives per call, posted in the caller's order
(the engine posts one batch a tick, in a fixed channel order, so gloo's
(peer, tag) matching and NCCL's posting-order matching agree).  A receive
handle's :meth:`Recv.wait` returns the payload on the rank's device.
:meth:`RankGroup.all_reduce_sum` sums over the stage or the data group;
:meth:`RankGroup.broadcast_object` and :meth:`RankGroup.gather_object`
carry small pickled commands and records over the world.
Every transfer, and every task the engine runs, is a span on the rank's
clock (:meth:`RankGroup.span`): blocked in receives and in sends, staging
copies, reduces, compute.  On the card a span is a pair of CUDA events on
the compute stream, so the clock never makes the host wait for the card;
the spans are read once, by :meth:`RankGroup.take_seconds`, after the
step.  A span is the time the compute stream spent on it, waits included:
under NCCL a receive's span is the stream's stall on the transfer, under
gloo the host's block in it.

**A mesh of ranks.** :func:`spawn` with ``axes`` (``{"data": 2, "model":
2}``, whose product is the world) lays the ranks out row-major over named
axes, the last fastest, as ``jax.make_mesh`` lays out its devices.  Each
rank gets its coordinate (:attr:`RankGroup.coords`) and a process group
for every set of axes (the ranks that differ only along them), and
:meth:`RankGroup.all_reduce_over`, :meth:`RankGroup.all_gather_over` and
:meth:`RankGroup.reduce_scatter_over` run over such a set, a group rank's
chunk in mesh-axis order.  Under gloo on the card they stage through pinned
host buffers, as the transfers do: gloo's collectives take CPU tensors.

Rendezvous goes through a file in a fresh temporary directory, not a
fixed port, so several worlds can start at once on one machine.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import importlib
import itertools
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["RankGroup", "Recv", "choose_transport", "spawn"]

#: how long a collective or transfer may block before the process group
#: gives up (a hung peer then fails the run instead of stalling it)
_PG_TIMEOUT = datetime.timedelta(minutes=10)
#: the largest piece a mesh collective moves at once
_PIECE_BYTES = 256 * 2**20


def choose_transport(device: torch.device, world_size: int) -> str:
    """``nccl`` when the ranks run on CUDA with a card each, else ``gloo``."""
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


class _Works:
    """Transfer works waited on once (a second wait on a finished gloo work
    blocks for ever)."""

    def __init__(self, works: list):
        self._works = works

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works = []


class Recv:
    """A posted receive: :meth:`wait` blocks until the payload is here and
    returns it on the rank's device."""

    def __init__(self, group: "RankGroup", works: _Works, buf: torch.Tensor):
        self._group, self._works, self._buf = group, works, buf

    def wait(self) -> torch.Tensor:
        g = self._group
        with g.span("recv_wait"):
            self._works.wait()
        if self._buf.device == g.device:
            return self._buf
        with g.span("staging"):
            return self._buf.to(g.device)


@dataclasses.dataclass(eq=False)
class RankGroup:
    rank: int  # global rank, d * S + s
    s: int
    d: int
    S: int
    D: int
    device: torch.device
    transport: str  # "nccl" or "gloo"
    stage_group: Any  # the S stages of replica d
    data_group: Any  # the D replicas of stage s; None when D == 1
    #: the named mesh axes ((name, size), ...) and this rank's index on
    #: each; empty when spawned without ``axes``
    axes: tuple = ()
    coords: dict = dataclasses.field(default_factory=dict)
    #: {axis names in mesh order: the group of the ranks differing only along them}
    axis_groups: dict = dataclasses.field(default_factory=dict)
    _sends: list = dataclasses.field(default_factory=list)
    #: (item, start, end) of every span since :meth:`take_seconds`: CUDA
    #: events on the card, host clock readings on the CPU
    _spans: list = dataclasses.field(default_factory=list)

    @property
    def staged(self) -> bool:
        """CUDA payloads ride pinned host buffers (gloo on the card)."""
        return self.transport == "gloo" and self.device.type == "cuda"

    @contextlib.contextmanager
    def span(self, item: str):
        """Count the work queued (or, on the CPU, done) inside the block
        towards ``item``: compute, recv_wait, send_wait, staging, reduce."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            yield
            self._spans.append((item, t0, time.perf_counter()))
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._spans.append((item, start, end))

    def take_seconds(self) -> collections.Counter:
        """Seconds per item over the spans since the last call, which it
        forgets; on the card it waits for the last span to end."""
        out = collections.Counter()
        if self._spans and self.device.type == "cuda":
            self._spans[-1][2].synchronize()
        for item, start, end in self._spans:
            out[item] += end - start if self.device.type != "cuda" else start.elapsed_time(end) / 1e3
        self._spans.clear()
        return out

    def peer(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's replica."""
        return self.d * self.S + stage

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport takes it: a pinned host copy when staged."""
        if not self.staged:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with self.span("staging"):
            host.copy_(t)
        return host

    def exchange(self, sends, recvs) -> list[Recv]:
        """Post one batch of point-to-point transfers in the given order.

        ``sends``: ``(payload, dst_stage, tag)``; ``recvs``: ``(shape, dtype,
        src_stage, tag)``.  Returns a :class:`Recv` per receive.  The sends
        complete in the background; :meth:`wait_sends` waits for them."""
        ops, keep = [], []
        for payload, dst, tag in sends:
            buf = self._host(payload)
            keep.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, self.peer(dst), self.stage_group, tag))
        bufs = []
        for shape, dtype, src, tag in recvs:
            if self.staged:
                buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.device)
            bufs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf, self.peer(src), self.stage_group, tag))
        if not ops:
            return []
        works = dist.batch_isend_irecv(ops)
        if len(works) == len(ops):  # one work per transfer (gloo)
            handles = [_Works([w]) for w in works]
        else:  # NCCL coalesces the batch into one work
            handles = [_Works(works)] * len(ops)
        self._sends += [(h, buf) for h, buf in zip(handles, keep)]
        return [Recv(self, h, buf) for h, buf in zip(handles[len(keep):], bufs)]

    def wait_sends(self) -> None:
        """Block until every posted send has completed."""
        with self.span("send_wait"):
            for works, _ in self._sends:
                works.wait()
        self._sends.clear()

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "stage") -> torch.Tensor:
        """Sum ``t`` in place over the ``"stage"`` or ``"data"`` group and
        return it."""
        return self._all_reduce(t, self.stage_group if axis == "stage" else self.data_group)

    def _all_reduce(self, t: torch.Tensor, pg) -> torch.Tensor:
        if pg is None:  # a group of one
            return t
        buf = self._host(t)
        with self.span("reduce"):
            dist.all_reduce(buf, group=pg)
        if buf is not t:
            with self.span("staging"):
                t.copy_(buf)
        return t

    def _axis_group(self, axes) -> tuple[Any, int]:
        """(process group, size) of the ranks differing only along ``axes``."""
        key = tuple(a for a, _ in self.axes if a in axes)
        if len(key) != len(set(axes)):
            raise ValueError(f"unknown mesh axes {axes}; the mesh has {self.axes}")
        n = math.prod(dict(self.axes)[a] for a in key)
        return (self.axis_groups[key] if n > 1 else None), n

    def all_reduce_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        """Sum ``t`` in place over the ranks differing only along ``axes``
        (mesh axis names) and return it."""
        return self._all_reduce(t, self._axis_group(axes)[0])

    def _pieces(self, x: torch.Tensor, dtype) -> list[torch.Tensor]:
        """``x`` (the collective's dim first) in pieces along its second dim,
        each at most :data:`_PIECE_BYTES` in ``dtype``: the copies a
        collective makes (the cast, the contiguous layout, the host buffer)
        then stay small beside the leaf."""
        if x.ndim < 2:
            return [x]
        k = min(x.shape[1], math.ceil(x.numel() * dtype.itemsize / _PIECE_BYTES))
        return list(x.tensor_split(max(k, 1), dim=1))

    def all_gather_over(self, t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` (over ``axes``) concatenated along ``dim`` in
        mesh-axis order, on the rank's device, contiguous (a product with a
        strided operand may take another kernel and round otherwise)."""
        pg, n = self._axis_group(axes)
        if n == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= n
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        if dim == 0 and not self.staged:  # straight into place
            with self.span("gather"):
                dist.all_gather_into_tensor(out, t.contiguous(), group=pg)
            return out
        moved, col = out.movedim(dim, 0), 0
        for piece in self._pieces(t.movedim(dim, 0), t.dtype):
            x = self._host(piece.contiguous())
            buf = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device, pin_memory=self.staged)
            with self.span("gather"):
                dist.all_gather_into_tensor(buf, x, group=pg)
            dst = moved if piece.ndim < 2 else moved.narrow(1, col, piece.shape[1])
            with self.span("staging" if self.staged else "gather"):
                dst.copy_(buf)
            col += piece.shape[1] if piece.ndim > 1 else 0
        return out

    def reduce_scatter_over(self, t: torch.Tensor, axes, dim: int = 0, dtype=None) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum of the ranks' ``t``
        over ``axes``, chunked in mesh-axis order, summed in ``dtype`` (by
        default ``t``'s), a piece at a time."""
        pg, n = self._axis_group(axes)
        dtype = dtype or t.dtype
        if n == 1:
            return t.to(dtype)
        outs = []
        for piece in self._pieces(t.movedim(dim, 0), dtype):
            x = self._host(piece.to(dtype, memory_format=torch.contiguous_format))
            out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=dtype, device=x.device,
                              pin_memory=self.staged)
            with self.span("reduce_scatter"):
                dist.reduce_scatter_tensor(out, x, group=pg)
            del x
            if self.staged:
                with self.span("staging"):
                    out = out.to(self.device)
            outs.append(out)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return out.movedim(0, dim)

    def barrier(self) -> None:
        if self.transport == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def broadcast_object(self, obj: Any = None) -> Any:
        """Global rank 0's ``obj`` (pickled; a small command) on every rank of
        the world.  Every rank must call it."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_object(self, obj: Any) -> list | None:
        """Every rank's ``obj`` (pickled; small records) on global rank 0, in
        rank order; ``None`` elsewhere.  Every rank must call it."""
        out: list = [None] * (self.S * self.D)
        dist.all_gather_object(out, obj)
        return out if self.rank == 0 else None


def _axis_groups(axes: tuple, rank: int) -> tuple[dict, dict]:
    """This rank's coordinates over ``axes`` and its group for every
    non-empty set of them (every rank creates every group, in one order)."""
    names, sizes = [a for a, _ in axes], [n for _, n in axes]
    coords, r = {}, rank
    for a, n in reversed(axes):
        coords[a], r = r % n, r // n
    groups = {}
    for k in range(1, len(names) + 1):
        for key in itertools.combinations(names, k):
            if math.prod(n for a, n in axes if a in key) == 1:
                continue
            others = [a for a in names if a not in key]
            for fixed in itertools.product(*(range(sizes[names.index(a)]) for a in others)):
                members = []
                for c in itertools.product(*(range(n) for n in sizes)):
                    if all(c[names.index(a)] == v for a, v in zip(others, fixed)):
                        members.append(sum(ci * math.prod(sizes[i + 1:]) for i, ci in enumerate(c)))
                g = dist.new_group(sorted(members))
                if all(coords[a] == v for a, v in zip(others, fixed)):
                    groups[key] = g
    return {a: coords[a] for a in names}, groups


def _join(S: int, D: int, rank: int, init_file: str, device_type: str, axes: tuple = ()) -> RankGroup:
    """Join the world as global ``rank`` and build the rank's groups; every
    rank creates every group, in the same order."""
    world = S * D
    device = resolve_device(device_type)
    transport = choose_transport(device, world)
    if device.type == "cuda":
        device = torch.device("cuda", rank if transport == "nccl" else 0)
        torch.cuda.set_device(device)
    kw = {"device_id": device} if transport == "nccl" else {}
    dist.init_process_group(
        transport, init_method=f"file://{init_file}", rank=rank, world_size=world, timeout=_PG_TIMEOUT, **kw
    )
    s, d = rank % S, rank // S
    stage_group = data_group = None
    for dd in range(D):
        g = dist.new_group([dd * S + ss for ss in range(S)])
        if dd == d:
            stage_group = g
    if D > 1:
        for ss in range(S):
            g = dist.new_group([dd * S + ss for dd in range(D)])
            if ss == s:
                data_group = g
    coords, axis_groups = _axis_groups(axes, rank) if axes else ({}, {})
    group = RankGroup(rank, s, d, S, D, device, transport, stage_group, data_group, axes, coords, axis_groups)
    # every rank of a group takes part in its first collective (NCCL then
    # allows batches of point-to-point transfers among some of them)
    group.all_reduce_sum(torch.zeros(1, device=device), "stage")
    group.all_reduce_sum(torch.zeros(1, device=device), "data")
    for key in axis_groups:
        group.all_reduce_over(torch.zeros(1, device=device), key)
    group.barrier()
    group.take_seconds()
    return group


def _child(fn, S, D, rank, init_file, device_type, args, results, axes) -> None:
    torch.set_num_threads(1)
    if device_type == "cuda":
        # the first call of a torch.library custom operator (K1's training
        # forward) imports torch._dynamo, seconds of host time; inside a
        # pipeline step each rank would pay it only once its first input
        # arrived, one rank after another, so every rank pays it here, at once
        importlib.import_module("torch._dynamo")
    try:
        group = _join(S, D, rank, init_file, device_type, axes)
        try:
            out = fn(group, *args)
            results.put((rank, True, out))
        finally:
            dist.destroy_process_group()
    except BaseException:  # report it to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(
    fn: Callable,
    S: int,
    D: int = 1,
    args: tuple = (),
    device=None,
    timeout: float | None = 600.0,
    axes: dict | None = None,
) -> list:
    """Run ``fn(group, *args)`` on ``S * D`` ranks, one process each (start
    method ``spawn``), and return each rank's result in rank order.

    ``axes`` (``{name: size}``, in mesh order, sizes multiplying to ``S *
    D``) lays the ranks out as a mesh: each group then has its coordinates
    and the collectives over any set of the axes.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable; plain Python and numpy objects are the
    safe choice for results.  ``device`` is where every rank computes:
    ``"cuda"`` (the default; raises without a card) or ``"cpu"``.  If any rank raises, or a process dies, or
    the ranks are not done within ``timeout`` seconds, the other ranks are
    killed and this raises with the failing rank's traceback.  With
    ``timeout=None`` there is no deadline: a rank blocked on a dead peer
    still fails, when its process group's timeout expires."""
    device_type = resolve_device(device).type
    world = S * D
    axes = tuple((axes or {}).items())
    if axes and math.prod(n for _, n in axes) != world:
        raise ValueError(f"mesh axes {dict(axes)} do not make {world} ranks")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = [
        ctx.Process(
            target=_child,
            args=(fn, S, D, r, os.path.join(tmp, "rendezvous"), device_type, args, results, axes),
            daemon=True,
        )
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
        out: dict[int, Any] = {}
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=min(1.0, max(deadline - time.monotonic(), 0.01)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
