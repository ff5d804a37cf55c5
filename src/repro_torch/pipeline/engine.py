"""The pipeline engines: a lowered plan walked tick by tick.

Port of ``repro/pipeline/engine.py``: its static schedule tables (copied
unchanged; they are numpy over the lowered grid) and its two executors,
with ``torch.autograd`` in place of ``jax.vjp``:

* :func:`reference_pipeline_grads`, the single-device executor of any
  family plan (a send is a dict entry); :func:`reduce_replicated` is the
  gradient sum the multi-device engine applies at the end of a step;
* :func:`make_pipeline_step`, the multi-device engine: one process per
  stage (``pipeline/ranks.py``), each walking its own row of the grid and
  sending its payloads point to point on the plan's channel tables, then
  reducing the replicated gradients and the loss over the ranks.

Both run the same task bodies (FWD, BWD, BWD_INPUT, BWD_WEIGHT).

Backward uses the stage-input checkpoint policy, as the reference's: a
stage keeps only its input per in-flight micro-batch (FWD runs under
``torch.no_grad()``) and recomputes the stage body under autograd in the
backward task.  Zero-bubble plans split that backward by the plan's
per-stage ``zb_policy[s]``:

* ``"double_remat"``: ``BWD_INPUT`` recomputes and takes the gradient with
  respect to the stage input only, stashing the incoming output gradient;
  ``BWD_WEIGHT`` recomputes again and takes the gradient with respect to
  the stage's parameters.
* ``"saved_residual"``: ``BWD_INPUT`` keeps its autograd graph
  (``retain_graph=True``), and ``BWD_WEIGHT`` takes the parameter gradient
  from that same graph, with no second recompute.

Parameters are a list of per-virtual-stage trees in global virtual-stage
order (:class:`~repro_torch.pipeline.stage.StagedModel`); the plan's
placement map says which device runs which of them.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core.schedule import Op, SchedulePlan
from repro_torch.pipeline.stage import StagedModel
from repro_torch.tree import flatten, tree_map

__all__ = [
    "make_pipeline_step",
    "reference_pipeline_grads",
    "stage_body_runs",
    "reduce_replicated",
    "queue_capacities",
    "arrival_tables",
    "REPLICATED",
]

#: parameter groups every stage holds a copy of (used by the first and last)
REPLICATED = ("embed", "final_norm")


# ---------------------------------------------------------------------------
# Static schedule-derived tables (copied from the reference)
# ---------------------------------------------------------------------------


_BWD_SENDERS = (int(Op.BWD), int(Op.BWD_INPUT))


def _grid_chunks(table: np.ndarray) -> np.ndarray:
    """Chunk column of a grid; legacy [S, T, 3] tick tables are chunkless."""
    if table.shape[-1] >= 4:
        return table[:, :, 2]
    return np.zeros(table.shape[:2], dtype=np.int32)


def arrival_tables(
    table: np.ndarray, num_virtual: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """``fwd_arrive[s, t]`` — device ``s`` receives a forward activation at
    the END of tick ``t`` (its upstream neighbour executed a sending FWD at
    ``t``); ``bwd_arrive[s, t]`` likewise for gradients from downstream.
    Accepts both the legacy ``[S, T, 3]`` tick table and the ``[S, T, 4]``
    tabular grid; for interleaved plans the neighbours wrap around the ring
    and a task only sends if it is not the boundary virtual stage."""
    S, T = table.shape[:2]
    ops = table[:, :, 0]
    vstage = _grid_chunks(table) * S + np.arange(S)[:, None]
    V = S * num_virtual
    sends_f = (ops == int(Op.FWD)) & (vstage != V - 1)
    sends_b = np.isin(ops, _BWD_SENDERS) & (vstage != 0)
    fwd = np.zeros((S, T), bool)
    bwd = np.zeros((S, T), bool)
    for s in range(S):
        up = (s - 1) % S if num_virtual > 1 else s - 1
        if up >= 0:
            fwd[s] = sends_f[up]
        down = (s + 1) % S if num_virtual > 1 else s + 1
        if down < S:
            bwd[s] = sends_b[down]
    return fwd, bwd


def queue_capacities(table: np.ndarray, num_virtual: int = 1) -> tuple[int, int]:
    """Exact max in-flight depth of the fwd / bwd arrival queues."""
    S, T = table.shape[:2]
    ops = table[:, :, 0]
    vstage = _grid_chunks(table) * S + np.arange(S)[:, None]
    V = S * num_virtual
    fwd_arr, bwd_arr = arrival_tables(table, num_virtual)
    cap_f = cap_b = 1
    for s in range(S):
        depth_f = depth_b = 0
        for t in range(T):
            # consumption happens during tick t, arrivals at its end
            if ops[s, t] == int(Op.FWD) and vstage[s, t] != 0:
                depth_f -= 1
            if ops[s, t] in _BWD_SENDERS and vstage[s, t] != V - 1:
                depth_b -= 1
            if fwd_arr[s, t]:
                depth_f += 1
            if bwd_arr[s, t]:
                depth_b += 1
            cap_f = max(cap_f, depth_f)
            cap_b = max(cap_b, depth_b)
    return cap_f, cap_b


def _placement_perm(plan: SchedulePlan) -> np.ndarray:
    """Permutation mapping device-major position ``s * v + c`` to the global
    virtual stage device ``s``'s chunk ``c`` hosts, under the plan kind's
    placement map (looped ``c * S + s`` by default; ZB-V's mirrored V).
    Identity when ``v == 1``."""
    S, v = plan.num_stages, plan.num_virtual
    pl = plan.placement
    return np.array(
        [int(pl.vstage_of[s, c]) for s in range(S) for c in range(v)], dtype=np.int64
    )


#: transfer channels of the lock-step engine: a payload leaving device ``s``
#: at the end of a tick either shifts DOWN the ring (to ``s + 1``), UP (to
#: ``s - 1``), or stays LOCAL (ZB-V's intra-device turn).
_CH_DOWN, _CH_UP, _CH_LOOP = 0, 1, 2
_NUM_CH = 3


def _channel_of(src: int, dst: int, S: int) -> int:
    if src == dst:
        return _CH_LOOP
    if (dst - src) % S == 1:
        return _CH_DOWN
    if (src - dst) % S == 1:
        return _CH_UP
    raise ValueError(
        f"placement requires a non-neighbour transfer {src} -> {dst}; the "
        "lock-step engine only implements ring shifts of +-1"
    )


def _channel_tables(plan: SchedulePlan, grid: np.ndarray):
    """Static per-channel send / arrival / input-source tables of a plan.

    Derived from the lowered grid plus the kind's placement map:

    * ``send_f[ch][s, t]`` / ``send_b[ch][s, t]`` — the task device ``s``
      executes at tick ``t`` emits its forward / backward payload into
      channel ``ch``;
    * ``arr_f`` / ``arr_b`` — the matching arrival masks at the receiving
      device (end of the send tick, consumable from ``t + 1``);
    * ``in_f[s, c]`` / ``in_b[s, c]`` — which channel queue the FWD input /
      backward ``dy`` of device ``s``'s chunk ``c`` is popped from (``-1``
      = no queue: the embedding for virtual stage 0, the loss seed for the
      last);
    * ``caps_f`` / ``caps_b`` — exact max in-flight depth per channel
      queue (>= 1 so zero-traffic channels still get a dummy buffer).
    """
    pl = plan.placement
    S, T = grid.shape[:2]
    v = plan.num_virtual
    V = plan.total_virtual_stages
    send_f = np.zeros((_NUM_CH, S, T), bool)
    send_b = np.zeros((_NUM_CH, S, T), bool)
    in_f = np.full((S, v), -1, np.int32)
    in_b = np.full((S, v), -1, np.int32)
    for s in range(S):
        for c in range(v):
            vs = int(pl.vstage_of[s, c])
            if vs > 0:
                in_f[s, c] = _channel_of(int(pl.device_of[vs - 1]), s, S)
            if vs < V - 1:
                in_b[s, c] = _channel_of(int(pl.device_of[vs + 1]), s, S)
    for s in range(S):
        for t in range(T):
            op, _, c, _ = (int(x) for x in grid[s, t])
            if op == int(Op.IDLE):
                continue
            vs = int(pl.vstage_of[s, c])
            if op == int(Op.FWD) and vs < V - 1:
                send_f[_channel_of(s, int(pl.device_of[vs + 1]), S), s, t] = True
            elif op in _BWD_SENDERS and vs > 0:
                send_b[_channel_of(s, int(pl.device_of[vs - 1]), S), s, t] = True
    arr_f = np.zeros_like(send_f)
    arr_b = np.zeros_like(send_b)
    for ch, shift in ((_CH_DOWN, 1), (_CH_UP, -1), (_CH_LOOP, 0)):
        src_of = (np.arange(S) - shift) % S
        arr_f[ch] = send_f[ch][src_of]
        arr_b[ch] = send_b[ch][src_of]
    caps_f, caps_b = [], []
    for ch in range(_NUM_CH):
        cap_f = cap_b = 1
        for s in range(S):
            df = db = 0
            for t in range(T):
                op, _, c, _ = (int(x) for x in grid[s, t])
                # consumption happens during tick t, arrivals at its end
                if op == int(Op.FWD) and in_f[s, c] == ch:
                    df -= 1
                elif op in _BWD_SENDERS and in_b[s, c] == ch:
                    db -= 1
                if arr_f[ch, s, t]:
                    df += 1
                if arr_b[ch, s, t]:
                    db += 1
                cap_f = max(cap_f, df)
                cap_b = max(cap_b, db)
        caps_f.append(cap_f)
        caps_b.append(cap_b)
    return send_f, send_b, arr_f, arr_b, in_f, in_b, caps_f, caps_b


# ---------------------------------------------------------------------------
# Reference executor (single device, Python loop over the tabular grid)
# ---------------------------------------------------------------------------


def _add(sums: list, parts) -> None:
    """Accumulate ``parts`` (one per leaf; ``None`` for a leaf the
    differentiated function does not use) into the fp32 sums."""
    for acc, part in zip(sums, parts):
        if part is not None:
            acc.add_(part.float())


# -- task bodies, shared by both executors ----------------------------------------
#
# Each takes one virtual stage's parameters ``p`` (a tree of leaves that
# require grad), their leaves in ``flatten`` order and the matching fp32
# gradient sums, and the stage input ``x`` saved by its FWD task.


def _body(staged: StagedModel, p, x, last: bool, labels):
    """The stage body under autograd; the last stage adds the head's loss."""
    y = staged.stage_hidden(p, x)
    return staged.head_loss(p, y, labels) if last else y


@torch.no_grad()
def _fwd_task(staged: StagedModel, p, x):
    """FWD of a stage that is not the last (whose forward runs in its
    backward): the output to send downstream."""
    return staged.stage_hidden(p, x)


def _bwd_task(staged: StagedModel, p, leaves, sums, x, dy, tokens, labels, *, first, last, M, split, saved_residual):
    """BWD (``split`` False) or BWD_INPUT (``split`` True) of one stage and
    micro-batch: recompute the body under autograd from the saved input and
    differentiate it against ``dy`` (the popped output gradient; ``None``
    at the last stage, which seeds ``1 / M`` and adds the head's loss).

    Returns ``(loss part or None, dx or None, ctx)``: ``dx`` is the input
    gradient to send upstream (``None`` at the first stage, which spends it
    on the embedding's gradient), ``ctx`` what BWD_WEIGHT needs (split
    only: the stashed ``dy``, or under ``saved_residual`` the graph and
    ``dy``)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        out = _body(staged, p, x, last, labels)
    loss = None
    if last:
        dy = torch.full((), 1.0 / M, dtype=out.dtype, device=out.device)
        loss = out.detach().float() / M
    ctx = None
    if split:
        (dx,) = torch.autograd.grad(out, [x], dy, retain_graph=saved_residual)
        ctx = (out, dy) if saved_residual else dy
    else:
        *dparams, dx = torch.autograd.grad(out, leaves + [x], dy, allow_unused=True)
        _add(sums, dparams)
    if first:
        # the embedding's gradient through the first stage's input
        with torch.enable_grad():
            emb = staged.embed_tokens(p, tokens)
        _add(sums, torch.autograd.grad(emb, leaves, dx, allow_unused=True))
        dx = None
    return loss, dx, ctx


def _bwd_weight_task(staged: StagedModel, p, leaves, sums, x, ctx, labels, *, last, saved_residual):
    """BWD_WEIGHT: the parameters' gradient, from BWD_INPUT's graph
    (``saved_residual``) or by a second recompute (``double_remat``)."""
    if saved_residual:
        out, dy = ctx  # B's graph: no second recompute
    else:
        with torch.enable_grad():
            out = _body(staged, p, x, last, labels)
        dy = ctx
    _add(sums, torch.autograd.grad(out, leaves, dy, allow_unused=True))


def _grad_leaves(params: list):
    """The parameters as leaves autograd can differentiate (views, no
    copies), their leaves, and zeroed fp32 gradient sums."""
    params = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in params]
    leaves = [list(flatten(ps).values()) for ps in params]
    sums = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ls] for ls in leaves]
    return params, leaves, sums


def _unflatten(params: list, sums: list) -> list:
    grads = []
    for ps, ss in zip(params, sums):
        it = iter(ss)
        grads.append(tree_map(lambda _: next(it), ps))
    return grads


def reference_pipeline_grads(staged: StagedModel, all_params, tokens, labels, plan: SchedulePlan):
    """Execute any family plan on one device, following the lowered grid.

    ``all_params``: ``S * v`` per-virtual-stage trees in global order.
    tokens/labels: [M, b, T].  Returns (mean loss, gradients): the loss an
    fp32 scalar, the gradients fp32 trees like ``all_params`` (per copy:
    the replicated groups are not yet summed, see :func:`reduce_replicated`)
    -- those of the unpipelined mean of ``staged.full_loss`` over the
    micro-batches, up to fp32 summation order.
    """
    S, M, v = plan.num_stages, plan.num_microbatches, plan.num_virtual
    V = S * v
    if V != staged.num_stages or len(all_params) != V:
        raise ValueError(
            f"the plan runs {V} virtual stages; the staged model has {staged.num_stages} "
            f"and the parameters {len(all_params)}"
        )
    grid = plan.lower().grid
    pl = plan.placement  # kind-owned virtual-stage map (looped, V-shaped, ...)
    params, leaves, sums = _grad_leaves(all_params)
    slots: list[dict] = [{} for _ in range(S)]  # stage inputs of in-flight micro-batches
    wctx: list[dict] = [{} for _ in range(S)]  # what BWD_INPUT leaves for BWD_WEIGHT
    fwd_wire: list[dict] = [{} for _ in range(S)]
    bwd_wire: list[dict] = [{} for _ in range(S)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)

    for t in range(grid.shape[1]):
        sends = []
        for s in range(S):
            op, mb, chunk, _ = (int(x) for x in grid[s, t])
            if op == int(Op.IDLE):
                continue
            vs = int(pl.vstage_of[s, chunk])
            p, p_leaves, p_sums = params[vs], leaves[vs], sums[vs]
            key = (mb, chunk)
            sr = plan.zb_policy[s] == "saved_residual"
            if op == int(Op.FWD):
                with torch.no_grad():
                    x = staged.embed_tokens(p, tokens[mb]) if vs == 0 else fwd_wire[s].pop(key)
                slots[s][key] = x
                if vs < V - 1:
                    nxt = vs + 1
                    sends.append((fwd_wire, int(pl.device_of[nxt]), (mb, int(pl.chunk_of[nxt])),
                                  _fwd_task(staged, p, x)))
            elif op in _BWD_SENDERS:
                split = op == int(Op.BWD_INPUT)
                x = slots[s][key] if split else slots[s].pop(key)
                dy = None if vs == V - 1 else bwd_wire[s].pop(key)
                loss, dx, ctx = _bwd_task(
                    staged, p, p_leaves, p_sums, x, dy, tokens[mb], labels[mb],
                    first=vs == 0, last=vs == V - 1, M=M, split=split, saved_residual=split and sr,
                )
                if loss is not None:
                    loss_sum += loss
                if split:
                    wctx[s][key] = ctx
                if dx is not None:
                    prv = vs - 1
                    sends.append((bwd_wire, int(pl.device_of[prv]), (mb, int(pl.chunk_of[prv])), dx))
            else:  # BWD_WEIGHT
                _bwd_weight_task(
                    staged, p, p_leaves, p_sums, slots[s].pop(key), wctx[s].pop(key), labels[mb],
                    last=vs == V - 1, saved_residual=sr,
                )
        for wire, dst, key, payload in sends:
            wire[dst][key] = payload
    return loss_sum, _unflatten(params, sums)


def stage_body_runs(plan: SchedulePlan) -> int:
    """How many times :func:`reference_pipeline_grads` runs a virtual
    stage's body (``StagedModel.stage_hidden``) in one step of ``plan``,
    read off its lowered grid: every FWD task but the last virtual stage's
    (whose forward runs in its backward), every BWD and BWD_INPUT task (the
    recompute under autograd), and every BWD_WEIGHT task of a
    ``double_remat`` stage (the second recompute; ``saved_residual`` reuses
    BWD_INPUT's graph).  A run applies each layer of its virtual stage once,
    so a model whose layers all hold attention runs the attention forward
    ``stage_body_runs(plan) * layers per virtual stage`` times a step."""
    grid = plan.lower().grid
    pl, V = plan.placement, plan.total_virtual_stages
    runs = 0
    for s in range(plan.num_stages):
        for op, _, chunk, _ in grid[s].tolist():
            if op == int(Op.FWD):
                runs += int(pl.vstage_of[s, chunk]) < V - 1
            elif op in _BWD_SENDERS:
                runs += 1
            elif op == int(Op.BWD_WEIGHT):
                runs += plan.zb_policy[s] == "double_remat"
    return runs


@torch.no_grad()
def reduce_replicated(grads: list) -> list:
    """Sum each replicated leaf's gradient (``embed``, ``final_norm``) over
    the virtual stages and write the sum into every copy, in place, so that
    the tied copies stay equal after an update.  Stage-local leaves
    (``layers``) stay as they are.  Returns ``grads``."""
    for group in REPLICATED:
        for key, leaf in flatten(grads[0][group]).items():
            copies = [leaf] + [flatten(g[group])[key] for g in grads[1:]]
            total = leaf.clone()
            for c in copies[1:]:
                total.add_(c)
            for c in copies:
                c.copy_(total)
    return grads


# ---------------------------------------------------------------------------
# Multi-rank executor (one process per stage, point-to-point on the channels)
# ---------------------------------------------------------------------------

#: ring shift of each transfer channel: the receiver of a payload that
#: device ``s`` sends on ``ch`` is ``(s + _SHIFT[ch]) % S``
_SHIFT = {_CH_DOWN: 1, _CH_UP: -1, _CH_LOOP: 0}
_KINDS = ("f", "b")  # activations (tag 2 * ch), gradients (tag 2 * ch + 1)


class _RankStep:
    """One rank's walk of its row of the lowered grid; see :func:`make_pipeline_step`."""

    def __init__(self, staged: StagedModel, plan: SchedulePlan, group):
        S, v = plan.num_stages, plan.num_virtual
        if S * v != staged.num_stages:
            raise ValueError(f"the plan runs {S * v} virtual stages; the staged model has {staged.num_stages}")
        if group.S != S:
            raise ValueError(f"the plan has {S} stages; the rank group {group.S}")
        tabular = plan.lower()
        tabular.validate()  # each link is one FIFO source: no lock-step needed
        grid = tabular.grid
        send_f, send_b, arr_f, arr_b, self.in_f, self.in_b, caps_f, caps_b = _channel_tables(plan, grid)
        self.staged, self.plan, self.group = staged, plan, group
        self.caps = {"f": list(caps_f), "b": list(caps_b)}
        #: the deepest in-flight queue per channel in the last call
        self.max_in_flight = {"f": [0] * _NUM_CH, "b": [0] * _NUM_CH}
        s, pl, V = group.s, plan.placement, S * v
        # per tick: (op, mb, chunk, {kind: channel its payload leaves on},
        # arrivals at the tick's end as (kind, channel, source stage, key))
        self.ticks = []
        for t in range(grid.shape[1]):
            op, mb, chunk, _ = (int(x) for x in grid[s, t])
            out = {k: int(np.flatnonzero(tbl[:, s, t])[0]) for k, tbl in zip(_KINDS, (send_f, send_b))
                   if tbl[:, s, t].any()}
            arrivals = []
            for ch in range(_NUM_CH):
                src = (s - _SHIFT[ch]) % S
                for kind, arr, step in (("f", arr_f, 1), ("b", arr_b, -1)):
                    if arr[ch, s, t]:
                        _, smb, schunk, _ = (int(x) for x in grid[src, t])
                        vs = int(pl.vstage_of[src, schunk]) + step
                        assert int(pl.device_of[vs]) == s and 0 <= vs < V
                        arrivals.append((kind, ch, src, (smb, int(pl.chunk_of[vs]))))
            self.ticks.append((op, mb, chunk, out, arrivals))

    def _pop(self, queues, kind: str, ch: int, key):
        """The head of a channel queue, which must be ``key`` (FIFO links)."""
        got, h = queues[kind, ch].popleft()
        if got != key:
            raise RuntimeError(f"channel {ch} ({kind}) delivered {got}, the task expects {key}")
        return h if isinstance(h, torch.Tensor) else h.wait()

    def __call__(self, local_params, tokens, labels):
        staged, plan, g = self.staged, self.plan, self.group
        S, M, v = plan.num_stages, plan.num_microbatches, plan.num_virtual
        V, s, pl, dtype = S * v, g.s, plan.placement, staged.cfg.dtype
        if len(local_params) != v:
            raise ValueError(f"rank {g.rank} hosts {v} chunks; got {len(local_params)} parameter trees")
        b = tokens.shape[1]
        if b % g.D:
            raise ValueError(f"micro-batch size {b} does not split over {g.D} data replicas")
        bl = b // g.D  # this replica's share of every micro-batch
        tokens = tokens[:, g.d * bl:(g.d + 1) * bl]
        labels = labels[:, g.d * bl:(g.d + 1) * bl]
        shape = (bl, tokens.shape[2], staged.cfg.d_model)
        params, leaves, sums = _grad_leaves(local_params)
        slots, wctx = {}, {}
        queues = {(k, ch): collections.deque() for k in _KINDS for ch in range(_NUM_CH)}
        self.max_in_flight = {k: [0] * _NUM_CH for k in _KINDS}
        loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for op, mb, chunk, out, arrivals in self.ticks:
            payload = None
            if op != int(Op.IDLE):
                vs = int(pl.vstage_of[s, chunk])
                p, p_leaves, p_sums = params[chunk], leaves[chunk], sums[chunk]
                key, first, last = (mb, chunk), vs == 0, vs == V - 1
                sr = plan.zb_policy[s] == "saved_residual"
                if op == int(Op.FWD):
                    x = None if first else self._pop(queues, "f", int(self.in_f[s, chunk]), key)
                    with g.span("compute"):
                        if first:
                            with torch.no_grad():
                                x = staged.embed_tokens(p, tokens[mb])
                        slots[key] = x
                        if not last:
                            payload = ("f", _fwd_task(staged, p, x).to(dtype))
                elif op in _BWD_SENDERS:
                    dy = None if last else self._pop(queues, "b", int(self.in_b[s, chunk]), key)
                    split = op == int(Op.BWD_INPUT)
                    with g.span("compute"):
                        loss, dx, ctx = _bwd_task(
                            staged, p, p_leaves, p_sums, slots[key] if split else slots.pop(key), dy,
                            tokens[mb], labels[mb], first=first, last=last, M=M, split=split,
                            saved_residual=split and sr,
                        )
                        if loss is not None:
                            loss_sum += loss
                        if dx is not None:
                            payload = ("b", dx.to(dtype))
                    if split:
                        wctx[key] = ctx
                else:  # BWD_WEIGHT
                    with g.span("compute"):
                        _bwd_weight_task(
                            staged, p, p_leaves, p_sums, slots.pop(key), wctx.pop(key), labels[mb],
                            last=last, saved_residual=sr,
                        )
            # the tick's end: its send and its arrivals, in channel order
            sends, local = [], None
            if payload is not None:
                kind, tensor = payload
                if kind not in out:
                    raise RuntimeError(f"the channel tables have no {kind} send for rank {s}'s task {(op, mb, chunk)}")
                ch = out[kind]
                if ch == _CH_LOOP:
                    local = tensor
                else:
                    sends.append((tensor, (s + _SHIFT[ch]) % S, 2 * ch + _KINDS.index(kind)))
            remote = [a for a in arrivals if a[1] != _CH_LOOP]
            handles = iter(g.exchange(sends, [(shape, dtype, src, 2 * ch + _KINDS.index(kind))
                                              for kind, ch, src, _ in remote]))
            for kind, ch, _, key in arrivals:
                q = queues[kind, ch]
                q.append((key, local if ch == _CH_LOOP else next(handles)))
                if len(q) > self.caps[kind][ch]:
                    raise RuntimeError(f"channel {ch} ({kind}) holds {len(q)} payloads, over its capacity "
                                       f"{self.caps[kind][ch]}")
                self.max_in_flight[kind][ch] = max(self.max_in_flight[kind][ch], len(q))
        g.wait_sends()
        # replicated leaves: the sum over this rank's chunks, then over the
        # stages, written into every chunk (repro's psum of the row sums)
        names = list(flatten(params[0]))
        for i, name in enumerate(names):
            if name.split("/")[0] in REPLICATED:
                total = sums[0][i]
                for c in range(1, v):
                    total.add_(sums[c][i])
                g.all_reduce_sum(total, "stage")
                for c in range(1, v):
                    sums[c][i].copy_(total)
        loss = g.all_reduce_sum(loss_sum, "stage")
        if g.D > 1:  # the mean over the data replicas
            for leaf in (x for ss in sums for x in ss):
                g.all_reduce_sum(leaf, "data").div_(g.D)
            g.all_reduce_sum(loss, "data").div_(g.D)
        return loss, _unflatten(params, sums)


def make_pipeline_step(staged: StagedModel, plan: SchedulePlan, group):
    """Build one rank's ``step(local_params, tokens, labels) -> (loss,
    local_grads)``: the multi-rank counterpart of ``repro``'s
    ``make_pipeline_step`` (``shard_map`` over a stage mesh).

    ``group`` is the rank's :class:`~repro_torch.pipeline.ranks.RankGroup`.
    ``local_params`` is the list of the rank's ``v`` per-virtual-stage
    trees in chunk order (chunk ``c`` hosts virtual stage
    ``plan.placement.vstage_of[s, c]``; :func:`repro_torch.bridge.rank_params`
    cuts them from the full list); tokens/labels are the global ``[M, b,
    T]``, of which data replica ``d`` takes rows ``d * b / D`` to ``(d + 1) * b / D``
    of every micro-batch.

    The rank walks its own row of the lowered grid with the task bodies of
    :func:`reference_pipeline_grads`.  A task's payload, cast to
    ``cfg.dtype`` as ``repro`` casts it, leaves at the end of its tick on
    the channel the plan's send tables name (LOOP stays in the process);
    the receives that the arrival tables announce are posted at the end of
    the same tick, into per-channel FIFO queues of at most the tables'
    capacity, and waited on only when a task pops them.  Sends and receives
    go in tick order and, within a tick, in channel order, with tag
    ``2 * channel`` for activations and ``2 * channel + 1`` for gradients.

    Returns the loss (summed over the stages; with ``D > 1`` averaged over
    the replicas) and fp32 gradients like ``local_params``: the replicated
    leaves (``embed``, ``final_norm``) hold their sum over every virtual
    stage, as :func:`reduce_replicated` leaves them; with ``D > 1`` every
    gradient is averaged over the replicas.  The returned callable keeps
    ``max_in_flight`` (per channel, of its last call) beside ``caps``.
    """
    return _RankStep(staged, plan, group)
