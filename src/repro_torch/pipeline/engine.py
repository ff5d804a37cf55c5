"""The reference pipeline engine: one device walks a lowered plan tick by tick.

Port of ``repro/pipeline/engine.py``: its static schedule tables (copied
unchanged; they are numpy over the lowered grid) and
:func:`reference_pipeline_grads`, the single-device executor of any family
plan, with ``torch.autograd`` in place of ``jax.vjp``.  The multi-device
engine (one process per stage, NCCL send/recv on the channel tables) comes
with a later slice; :func:`reduce_replicated` is the gradient sum its
``shard_map`` counterpart applies at the end of a step.

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

import numpy as np
import torch

from repro_torch.core.schedule import Op, SchedulePlan
from repro_torch.pipeline.stage import StagedModel
from repro_torch.tree import flatten, tree_map

__all__ = [
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
    # the parameters as leaves autograd can differentiate (views, no copies)
    params = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in all_params]
    leaves = [list(flatten(ps).values()) for ps in params]
    sums = [[torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in ls] for ls in leaves]
    slots: list[dict] = [{} for _ in range(S)]  # stage inputs of in-flight micro-batches
    wctx: list[dict] = [{} for _ in range(S)]  # what BWD_INPUT leaves for BWD_WEIGHT
    fwd_wire: list[dict] = [{} for _ in range(S)]
    bwd_wire: list[dict] = [{} for _ in range(S)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)

    def forward(p, x, vs, mb):
        """The stage body under autograd; the last stage adds the head's loss."""
        y = staged.stage_hidden(p, x)
        return staged.head_loss(p, y, labels[mb]) if vs == V - 1 else y

    for t in range(grid.shape[1]):
        sends = []
        for s in range(S):
            op, mb, chunk, _ = (int(x) for x in grid[s, t])
            if op == int(Op.IDLE):
                continue
            vs = int(pl.vstage_of[s, chunk])
            p, p_leaves, p_sums = params[vs], leaves[vs], sums[vs]
            key = (mb, chunk)
            if op == int(Op.FWD):
                with torch.no_grad():
                    x = staged.embed_tokens(p, tokens[mb]) if vs == 0 else fwd_wire[s].pop(key)
                    slots[s][key] = x
                    if vs < V - 1:  # the last stage's forward runs in its backward
                        nxt = vs + 1
                        sends.append((fwd_wire, int(pl.device_of[nxt]), (mb, int(pl.chunk_of[nxt])),
                                      staged.stage_hidden(p, x)))
            elif op in (int(Op.BWD), int(Op.BWD_INPUT)):
                zb = op == int(Op.BWD_INPUT)
                sr = zb and plan.zb_policy[s] == "saved_residual"
                x = (slots[s][key] if zb else slots[s].pop(key)).detach().requires_grad_(True)
                with torch.enable_grad():
                    out = forward(p, x, vs, mb)
                if vs == V - 1:
                    cot = torch.full((), 1.0 / M, dtype=out.dtype, device=out.device)
                    loss_sum += out.detach().float() / M
                else:
                    cot = bwd_wire[s].pop(key)
                if zb:
                    (dx,) = torch.autograd.grad(out, [x], cot, retain_graph=sr)
                    wctx[s][key] = (out, cot) if sr else cot
                else:
                    *dparams, dx = torch.autograd.grad(out, p_leaves + [x], cot, allow_unused=True)
                    _add(p_sums, dparams)
                if vs == 0:
                    # the embedding's gradient through the first stage's input
                    with torch.enable_grad():
                        emb = staged.embed_tokens(p, tokens[mb])
                    _add(p_sums, torch.autograd.grad(emb, p_leaves, dx, allow_unused=True))
                else:
                    prv = vs - 1
                    sends.append((bwd_wire, int(pl.device_of[prv]), (mb, int(pl.chunk_of[prv])), dx))
            else:  # BWD_WEIGHT
                x = slots[s].pop(key)
                ctx = wctx[s].pop(key)
                if plan.zb_policy[s] == "saved_residual":
                    out, cot = ctx  # B's graph: no second recompute
                else:
                    with torch.enable_grad():
                        out = forward(p, x, vs, mb)
                    cot = ctx
                _add(p_sums, torch.autograd.grad(out, p_leaves, cot, allow_unused=True))
        for wire, dst, key, payload in sends:
            wire[dst][key] = payload
    grads = []
    for ps, ss in zip(params, sums):
        it = iter(ss)
        grads.append(tree_map(lambda _: next(it), ps))
    return loss_sum, grads


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
