"""The sharded train step, prefill and decode step: one process per
device, the weights (and state) held as each rank's shard under ``repro``'s
sharding rules.

Port of ``repro/distributed/spmd.py`` (``make_spmd_train_step``,
``make_spmd_prefill``, ``make_spmd_serve_step``, ``state_specs_for``,
``act_anchor_for``, ``_state_shardings``, ``_zero3_dp_axes``).  ``repro``
jits one program over a device mesh and lets GSPMD place the collectives.  Here each rank is a process of
:func:`repro_torch.pipeline.ranks.spawn` (NCCL when each rank has a card,
else gloo with pinned host staging), the mesh is
:func:`repro_torch.launch.mesh.make_local_mesh` at the rank's coordinate,
and the step says where every collective goes:

* **State.**  Parameters, AdamW's moments and the fp32 gradient sums are
  each rank's shards under :func:`~repro_torch.distributed.sharding.param_pspecs`
  (``tp_fsdp``) or :func:`~repro_torch.distributed.sharding.zero3_param_pspecs`
  (``zero3``), on the port's per-layer leaves.  Adafactor's statistics keep
  ``repro``'s layout: the spec of their group's leaf in the reference's
  stacked layout, truncated to the statistic's rank (``like_param``).
* **Batch.**  ``make_train_step``'s split into micro-batches comes first
  (``training/steps.py::_microbatches``); each rank then takes its rows of
  each micro-batch, over the data axes for ``tp_fsdp`` (as
  :func:`act_anchor_for` anchors the hidden stream) and over the axes of
  :func:`_zero3_dp_axes` for ``zero3``.  Ranks along the other axes hold the
  same rows.
* **Compute under ``zero3``: gather at use.**  Each part of the model (the
  embedding table, each layer, a norm, the head) is all-gathered to full
  just before it runs, matrices in ``cfg.dtype`` (the model casts them
  there at use anyway) and the rest in their own dtype, and freed after it;
  the backward reduce-scatters each gradient to its shard, averaged over
  the ranks (a leaf replicated over an axis is summed over that axis too).
* **Compute under ``tp_fsdp``: tensor-parallel products over "model"**
  (:mod:`repro_torch.distributed.tensor_parallel`).  A leaf is gathered over
  its data axes only (the FSDP half) and the products run on its "model"
  shard: column and row products with one all-reduce over "model" per
  attention, MLP and MoE block, the vocab-split embedding and logits, the
  MoE layer expert-parallel (each rank its E/tp experts, the banks gathered
  over "data" only) and Mamba2 by heads (``in_proj``'s output all-gathered,
  the conv, the SSD through K2 and the state on the rank's heads, one
  all-reduce for the gated norm and one for ``out_proj``).  The backward
  reduce-scatters each gradient over the data axes only, averaged over the
  row groups; a leaf each rank uses in part (the router, ``conv_w`` and
  Mamba2's 1-D leaves, ``wk`` and ``wv`` of a split head) is summed over
  "model" too.  Only the router, ``conv_w`` and the leaves of a layer whose
  heads or experts do not split whole over "model" (an attention block
  whose heads do not, a Mamba2 layer with ``H % tp != 0``, an MoE layer
  with ``E % tp != 0``) are gathered over "model", as ``zero3`` gathers
  every leaf.  The ranks along "model" share their rows' work instead of
  repeating it.  With
  ``remat_blocks`` (always under ``zero3``) each layer, its gather
  included, runs again in the backward; ``remat`` recomputes the whole
  loss.  With ``gather_params_once`` (``tp_fsdp``) every leaf is gathered
  once a step, before the micro-batches, the leaves of rank >= 2 in
  ``repro``'s stacked layout cast to ``cfg.dtype`` first, as ``repro`` casts
  them; the gradients still reduce-scatter at each use.  Every rank runs K1
  on its own rows (under ``tp_fsdp`` its own heads) in each attention layer,
  and K2 (its own heads) in each Mamba2 layer.
* **MoE.**  Under the anchor the MoE layers route each row as its own group
  (``moe_apply_grouped``), the expert counts summed over the ranks of the
  micro-batch's rows, so the load-balance term is the micro-batch's
  (:mod:`repro_torch.models.moe`).  Under ``tp_fsdp`` every rank of a
  column routes alike and computes the same load-balance and router z
  terms; each carries 1/tp of their gradient, so the router's gradient,
  summed over "model", counts them once.
* **Loss.**  Each rank's loss is its share (the cross-entropy and router
  z-loss over its rows, the load-balance share): the mean over the ranks
  is the micro-batch's loss, and so is the mean of the gradients.
* **Optimizer** on the shards: AdamW is elementwise; the step clips, its
  norm counting each element once (a shard replicated over an axis on that
  axis's rank 0 only) summed over the world; Adafactor's row and column
  means and its update RMS sum over the ranks that split the reduced dims
  (:class:`ShardedStats`).

**Serving** (:func:`make_spmd_prefill`, :func:`make_spmd_serve_step`): the
weights are stationary, each rank holding its shard of
``param_shardings(..., fsdp=False)`` (drawn by ``init_params``, the
serving cast's, or cut from a full tree); the prefill is
``prefill_with_cache``'s path (``prefill_fn`` for the encoder-decoder and
the VLM) and the decode ``decode_fn``, both through the tensor-parallel
products: K1 on each rank's heads in every attention layer of the prefill,
the MoE layer on the rank's experts (its banks gathered over the data axes,
which split their d dim even without FSDP), Mamba2 on the rank's heads
(the prefill stepping the recurrence token by token, so K2 is not on the
serving path).  The decode cache is each rank's shard under
``cache_shardings`` (the batch over the data axes, the KV sequence over
"model", the SSM state's heads over "model"), updated in place as ``repro``
donates it; the prefill fills one when given it (``kv_len``).  The rows
follow :func:`act_anchor_for`: over the data axes when the batch divides
them, else (B = 1) every rank takes them all; the logits are gathered over
the row axes, so each rank returns ``repro``'s whole output.

:func:`state_specs_for` traces the init under ``FakeTensorMode``: a seeded
``torch.Generator`` does not draw on ``meta``, and the fake mode runs the
same init on shapes alone; it returns meta tensors.  The step's
:meth:`SpmdTrainStep.init_state` draws the full seeded stream on every
rank and cuts each part to the rank's shard as soon as it is drawn (the
init's ``finish`` hook), so the shards equal ``api.init_params(cfg, seed)``
cut afterwards, and the peak is one part plus the shards.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    NamedSharding,
    PartitionSpec as P,
    _spec_for,
    _zero3_spec,
    cache_shardings,
    gather,
    local_shape,
    local_shard,
    map_with_path,
    param_pspecs,
    reduce_scatter,
    replicated,
    spec_axes,
    zero3_param_pspecs,
)
from repro_torch.distributed.tensor_parallel import MODEL, LeafUse, TensorParallel, gather_spec, leaf_use
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdafactorState, AdamWState, Optimizer, decay_mask, make_optimizer
from repro_torch.optim.adafactor import Whole
from repro_torch.training.state import TrainState, create_train_state
from repro_torch.training.steps import _batch_dim, _microbatches
from repro_torch.tree import flatten, tree_map

__all__ = [
    "state_specs_for",
    "act_anchor_for",
    "make_spmd_train_step",
    "make_spmd_prefill",
    "make_spmd_serve_step",
    "SpmdTrainStep",
    "SpmdPrefill",
    "SpmdServeStep",
    "ShardedStats",
]


def act_anchor_for(cfg: ModelConfig, mesh, batch: int, microbatches: int = 1):
    """The hidden-stream anchor [B, T, d] for this (cfg, mesh, batch), as
    ``repro`` sets it: the batch over (pod, data) when the per-micro-batch
    batch divides the data size; otherwise the model axis on d when
    divisible; else no anchor."""
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dsz = math.prod(mesh.shape[a] for a in data_axes)
    per_mb = batch // microbatches
    dp = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    if dp is not None and dsz > 1 and per_mb % dsz == 0:
        return cfg.replace(act_sharding=(dp, None, None))
    tp = mesh.shape.get("model", 1)
    if tp > 1 and cfg.d_model % tp == 0:
        return cfg.replace(act_sharding=(None, None, "model"))
    return cfg


def _zero3_dp_axes(mesh, batch: int, microbatches: int) -> tuple[str, ...]:
    """The largest of (every axis, all but the last, the first) whose size
    divides the per-micro-batch batch; ``()`` if none does."""
    names = tuple(mesh.axis_names)
    per_mb = batch // microbatches
    for axes in (names, names[:-1], names[:1]):
        n = math.prod(mesh.shape[a] for a in axes)
        if n > 1 and per_mb % n == 0:
            return axes
    return ()


def _map_state(fn, state: TrainState) -> TrainState:
    opt = state.opt_state
    if isinstance(opt, AdamWState):
        opt = AdamWState(opt.step, tree_map(fn, opt.m), tree_map(fn, opt.v))
    else:
        opt = AdafactorState(opt.step, {k: fn(v) for k, v in opt.v_row.items()},
                             {k: fn(v) for k, v in opt.v_col.items()})
    return TrainState(state.step, tree_map(fn, state.params), opt)


def state_specs_for(cfg: ModelConfig, optimizer: Optimizer) -> TrainState:
    """The full TrainState's shapes and dtypes as ``meta`` tensors, without
    allocating: the seeded init runs under ``FakeTensorMode``."""
    with FakeTensorMode():
        gen = torch.Generator(device="cpu").manual_seed(0)
        state = create_train_state(api._init(cfg, gen), optimizer)
    return _map_state(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)


def _group_shape(vr, vc) -> tuple:
    """An Adafactor group's leaf shape from its statistics."""
    return tuple(vr.shape) if vc.ndim == 0 else (*vr.shape, vc.shape[-1])


def _truncate(spec, ndim: int):
    return P(*spec[:ndim]) if len(spec) > ndim else spec


def _rules(mesh, strategy: str):
    """(the parameter spec tree of a tree, the spec of one (path, shape)) under a strategy."""
    if strategy == "zero3":
        return (lambda params: zero3_param_pspecs(params, mesh)), (lambda _, shape: _zero3_spec(shape, mesh))
    return (lambda params: param_pspecs(params, mesh)), (lambda path, shape: _spec_for(path, shape, mesh))


def _state_shardings(state_specs: TrainState, mesh, strategy: str = "tp_fsdp") -> TrainState:
    """The state's shardings: AdamW's m and v mirror the parameters;
    Adafactor's v_row and v_col take the spec of their group's leaf in
    ``repro``'s stacked layout (the rule on the group's reference path and
    stacked shape), truncated to the statistic's rank, as ``like_param``."""
    pspecs, rule = _rules(mesh, strategy)
    p_shard = map_with_path(lambda _, s: NamedSharding(mesh, s), pspecs(state_specs.params))
    opt = state_specs.opt_state
    if isinstance(opt, AdamWState):
        opt_shard = AdamWState(step=replicated(mesh), m=p_shard, v=p_shard)
    else:
        rows, cols = {}, {}
        for name, vr in opt.v_row.items():
            vc = opt.v_col[name]
            spec = rule(name, _group_shape(vr, vc))
            rows[name] = NamedSharding(mesh, _truncate(spec, vr.ndim))
            cols[name] = NamedSharding(mesh, _truncate(spec, vc.ndim))
        opt_shard = AdafactorState(step=replicated(mesh), v_row=rows, v_col=cols)
    return TrainState(step=replicated(mesh), params=p_shard, opt_state=opt_shard)


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec_axes(spec[i]) if i < len(spec) else () for i in range(ndim))


def _fit(spec, shape, mesh):
    """``spec`` with the entries that do not divide their dim dropped."""
    return P(*(a if shape[i] % math.prod(mesh.shape[x] for x in spec_axes(a)) == 0 else None
               for i, a in enumerate(spec)))


def _named(spec) -> set:
    return {a for entry in spec for a in spec_axes(entry)}


def _part_paths(cfg: ModelConfig) -> list:
    """The leaf paths of each part the init's ``finish`` sees, in order."""
    calls = []
    with FakeTensorMode():
        gen = torch.Generator(device="cpu").manual_seed(0)
        params = api._init(cfg, gen, lambda part: calls.append(list(flatten(part).values())) or part)
    path_of = {id(t): k for k, t in flatten(params).items()}
    return [[path_of[id(t)] for t in leaves] for leaves in calls]


def _draw_shards(cfg: ModelConfig, specs: dict, mesh, device, seed: int, serving: bool = False):
    """The rank's shards (under ``specs``, by path) of ``api.init_params(cfg,
    seed)``, or with ``serving`` of ``api.init_serving_params``: every rank
    draws the whole seeded stream on its device and keeps its shard of each
    part as soon as the part is drawn (and cast)."""
    calls, cut = iter(_part_paths(cfg)), set()

    def finish(part):
        paths = iter(next(calls))
        # the serving cast's dtype of each leaf, applied to its shard alone: the
        # peak is the drawn part (one fp32 expert bank) above the shards
        meta = tree_map(lambda t: torch.empty((), dtype=t.dtype, device="meta"), part)
        dtypes = iter(t.dtype for t in flatten(api.cast_for_serving(meta, cfg) if serving else meta).values())

        def one(t):
            path, dtype = next(paths), next(dtypes)
            if id(t) in cut:
                return t
            s = local_shard(t, specs[path], mesh).to(dtype, copy=True)
            cut.add(id(s))
            return s

        return tree_map(one, part)

    gen = torch.Generator(device=device).manual_seed(seed)
    return api._init(cfg, gen, finish)


class ShardedStats(Whole):
    """Adafactor's reductions over leaves split over the mesh.  Per group:
    the spec of its stacked local shards (``compute``), its full shape and
    the stored specs of its row and column statistics (``repro``'s)."""

    def __init__(self, mesh, groups: dict):
        self.mesh, self.groups = mesh, groups

    def _reshard(self, x, src, dst):
        if _padded(src, x.ndim) == _padded(dst, x.ndim):
            return x
        return local_shard(gather(x, src, self.mesh), dst, self.mesh).clone()

    def _specs(self, name):
        cs, full, rs, vs = self.groups[name]
        return cs, full, rs, vs, P(*cs[:-1]), P(*cs[:-2], cs[-1])

    def shapes(self, name, shape):
        _, full, rs, vs, _, _ = self._specs(name)
        return local_shape(full[:-1], rs, self.mesh), local_shape(full[:-2] + full[-1:], vs, self.mesh)

    def mean(self, name, t, dim, of, keepdim=False):
        cs, full = self.groups[name][:2]
        s = t.sum(dim=dim, keepdim=keepdim)
        if self.mesh.size > 1:
            self.mesh.group.all_reduce_over(s, spec_axes(cs[of]))
        return s / full[of]

    def square_mean(self, name, u):
        cs, full = self.groups[name][:2]
        s = u.square().sum()
        if self.mesh.size > 1:
            self.mesh.group.all_reduce_over(s, tuple(a for a in self.mesh.axis_names if a in _named(cs)))
        return s / math.prod(full)

    def load(self, name, vr, vc):
        if vc.ndim == 0:
            return vr, vc
        _, _, rs, vs, cr, cc = self._specs(name)
        return self._reshard(vr, rs, cr), self._reshard(vc, vs, cc)

    def store(self, name, vr, vc, vr_used, vc_used):
        if vc.ndim == 0:
            return
        _, _, rs, vs, cr, cc = self._specs(name)
        if vr_used is not vr:
            vr.copy_(self._reshard(vr_used, cr, rs))
        if vc_used is not vc:
            vc.copy_(self._reshard(vc_used, cc, vs))


class _Gather(torch.autograd.Function):
    """A leaf as its use reads it from the rank's shard (the forward's
    all-gather over the axes of ``step._gather[path]``, or the step's gather
    made once; under ``tp_fsdp`` narrowed to the columns of its
    :class:`~repro_torch.distributed.tensor_parallel.LeafUse`); the backward
    reduce-scatters its gradient to the shard."""

    @staticmethod
    def forward(ctx, shard, path, step):
        ctx.path, ctx.step = path, step
        x = step._once.get(path)
        if x is not None:
            x = x.detach()
        else:
            x = shard.to(step._dtype[path])
            spec = step._gather[path]
            x = gather(x, spec, step.mesh) if _named(spec) else (x.clone() if x is shard else x)
        cols = step.uses[path].cols
        ctx.shape = x.shape
        return x if cols is None else x.narrow(-1, *cols).contiguous()

    @staticmethod
    def backward(ctx, g):
        cols = ctx.step.uses[ctx.path].cols
        if cols is not None:
            full = g.new_zeros(ctx.shape)
            full.narrow(-1, *cols).copy_(g)
            g = full
        return ctx.step._grad_shard(g, ctx.path), None, None


class SpmdTrainStep:
    """One rank's sharded train step: ``step(state, batch) -> (state,
    metrics)`` on the global ``batch`` (every rank passes the same one and
    takes its rows); the state is the rank's shards, updated in place.  Build
    it with :func:`make_spmd_train_step`."""

    def __init__(self, cfg, mesh, optimizer, num_microbatches, remat, gather_params_once, strategy, row_axes,
                 state_specs, device):
        self.cfg, self.mesh, self.M, self.remat = cfg, mesh, num_microbatches, remat
        self.gather_params_once, self.strategy, self.row_axes = gather_params_once, strategy, row_axes
        self.device = device
        pspecs, _ = _rules(mesh, strategy)
        self.specs = flatten(pspecs(state_specs.params))
        self.full_shapes = {k: tuple(t.shape) for k, t in flatten(state_specs.params).items()}
        # tp_fsdp: the products over "model" (tensor_parallel); zero3 gathers every leaf whole
        self.tp = TensorParallel(mesh) if strategy == "tp_fsdp" else None
        if self.tp is None:
            self.uses = {k: LeafUse(model=True) for k in self.specs}
        else:
            self.uses = {k: leaf_use(k, spec, cfg, self.tp.size, self.tp.rank) for k, spec in self.specs.items()}
        self._gather = {k: gather_spec(spec, self.uses[k], data=True) for k, spec in self.specs.items()}
        # at use, matrices in cfg.dtype (the model casts them there);
        # gathered once, every leaf of rank >= 2 in repro's stacked layout
        cast_once = decay_mask(state_specs.params)
        at_use = flatten(api.cast_for_serving(state_specs.params, cfg))
        self._dtype = {
            k: (cfg.dtype if (cast_once[k] and t.dtype == torch.float32) else t.dtype)
            if gather_params_once else at_use[k].dtype
            for k, t in flatten(state_specs.params).items()
        }
        self._once: dict = {}
        self._path_of: dict = {}
        self.max_grad_norm = optimizer.config.get("max_grad_norm")
        self.optimizer = self._sharded(optimizer, state_specs)

    # -- placement -------------------------------------------------------------

    def _sharded(self, optimizer, state_specs) -> Optimizer:
        """``optimizer`` rebuilt for the shards: Adafactor's statistics
        stored under :func:`_state_shardings` (the entries that do not divide
        their dim dropped), the clip left to the step."""
        shards = None
        if optimizer.name == "adafactor":
            layout = optimizer.config.get("layout") or [(k, [k], False) for k in self.specs]
            stored = _state_shardings(state_specs, self.mesh, self.strategy).opt_state
            opt = state_specs.opt_state
            groups = {}
            for name, paths, stacked in layout:
                spec = self.specs[paths[0]]
                full = (len(paths), *self.full_shapes[paths[0]]) if stacked else self.full_shapes[paths[0]]
                cs = P(*_padded((None, *spec) if stacked else spec, len(full)))
                groups[name] = (cs, full, _fit(stored.v_row[name].spec, opt.v_row[name].shape, self.mesh),
                                _fit(stored.v_col[name].spec, opt.v_col[name].shape, self.mesh))
            shards = ShardedStats(self.mesh, groups)
        return make_optimizer(**{**optimizer.config, "max_grad_norm": None, "shards": shards})

    def _clip(self, grads):
        """``grads`` scaled so that the global norm is at most the
        optimizer's ``max_grad_norm`` (:func:`~repro_torch.optim.clip_by_global_norm`
        over the whole leaves), and that norm: each element counted once (a
        shard replicated over an axis on that axis's rank 0 only), summed
        over the world."""
        mesh = self.mesh
        flat = flatten(grads)
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for k, g in flat.items():
            if all(mesh.coord(a) == 0 for a in mesh.axis_names if a not in _named(self.specs[k])):
                sq = sq + g.float().square().sum()
        norm = torch.sqrt(self._world_sum(sq))
        scale = torch.clamp(self.max_grad_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm

    def _world_sum(self, t):
        if self.mesh.size > 1:
            self.mesh.group.all_reduce_over(t, self.mesh.axis_names)
        return t

    def _row_sum(self, t):
        if self.row_axes:
            self.mesh.group.all_reduce_over(t, self.row_axes)
        return t

    def _grad_shard(self, g, path):
        """The shard of the gradient of the mean over the row groups of their
        losses, from this rank's gradient of the leaf as used.  Under
        ``zero3`` (every rank a row group) and for a ``"sum"`` use, the
        ranks' gradients are summed over every axis; under ``tp_fsdp`` the
        ranks along "model" hold one row group's loss, so a leaf's gradient
        is its own shard's (``"local"``) or every such rank's alike
        (``"replicated"``: the rank keeps its chunk), summed over the data
        axes only."""
        spec, use = self.specs[path], self.uses[path]
        groups = self.mesh.size
        if self.tp is not None:
            groups //= self.tp.size
            if use.grad == "replicated":
                g = local_shard(g, P(*(e if MODEL in spec_axes(e) else None for e in spec)), self.mesh)
            if use.grad != "sum":
                spec = gather_spec(spec, LeafUse(), data=True)
        x = reduce_scatter(g, spec, self.mesh, torch.float32) if _named(spec) else g.float().clone()
        summed = tuple(a for a in self.mesh.axis_names
                       if a not in _named(spec) and (self.tp is None or use.grad == "sum" or a != MODEL))
        if summed and self.mesh.size > 1:
            self.mesh.group.all_reduce_over(x, summed)
        return x.div_(groups)

    def _use(self, part):
        return tree_map(lambda t: _Gather.apply(t, self._path_of[id(t)], self), part)

    def local_rows(self, mb: Mapping[str, torch.Tensor]) -> dict:
        """This rank's rows of one micro-batch, on its device."""
        n = math.prod(self.mesh.shape[a] for a in self.row_axes)
        i = self.mesh.index(self.row_axes)
        out = {}
        for k, v in mb.items():
            d = _batch_dim(k)
            size = v.shape[d] // n
            out[k] = v.narrow(d, i * size, size).to(self.device)
        return out

    # -- state -------------------------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """The rank's shards of ``create_train_state(api.init_params(cfg,
        seed))``: every rank draws the whole seeded stream on its device and
        keeps its shard of each part as soon as the part is drawn."""
        return create_train_state(_draw_shards(self.cfg, self.specs, self.mesh, self.device, seed), self.optimizer)

    def shard_state(self, params) -> TrainState:
        """A fresh state from a full parameter tree (cut to the rank's shards)."""
        shards = map_with_path(lambda k, t: local_shard(t.to(self.device), self.specs[k], self.mesh).clone(), params)
        return create_train_state(shards, self.optimizer)

    def gather_state(self, state: TrainState) -> TrainState:
        """The full state on every rank: the parameter and AdamW trees, or
        Adafactor's statistics keyed by the reference's group names."""
        full = lambda k, t: gather(t, self.specs[k], self.mesh)  # noqa: E731
        opt = state.opt_state
        if isinstance(opt, AdamWState):
            opt = AdamWState(opt.step, map_with_path(full, opt.m), map_with_path(full, opt.v))
        else:
            groups = self.optimizer.config["shards"].groups
            opt = AdafactorState(opt.step, {n: gather(t, groups[n][2], self.mesh) for n, t in opt.v_row.items()},
                                 {n: gather(t, groups[n][3], self.mesh) for n, t in opt.v_col.items()})
        return TrainState(state.step, map_with_path(full, state.params), opt)

    # -- the step ------------------------------------------------------------------

    def _world_mean(self, t: torch.Tensor) -> torch.Tensor:
        return self._world_sum(t.detach().float().clone()) / self.mesh.size

    def _loss(self, leaves, rows):
        def fn():
            return api.loss_fn(leaves, self.cfg, rows, use=self._use, row_sum=self._row_sum, tp=self.tp)

        return checkpoint(fn, use_reentrant=False) if self.remat else fn()

    def __call__(self, state: TrainState, batch: Mapping[str, torch.Tensor]):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), state.params)
        flat = flatten(leaves)
        self._path_of = {id(t): k for k, t in flat.items()}
        if self.gather_params_once:
            with torch.no_grad():
                self._once = {k: gather(t.to(self._dtype[k]), self._gather[k], self.mesh) for k, t in flat.items()}
        loss_sum, metrics = None, {}
        try:
            for mb in _microbatches(batch, self.M):
                loss, metrics = self._loss(leaves, self.local_rows(mb))
                loss.backward()
                loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        finally:
            self._once, self._path_of = {}, {}
        grads = tree_map(lambda t: torch.zeros_like(t) if t.grad is None else t.grad.div_(self.M), leaves)
        del leaves, flat
        loss = self._world_mean(loss_sum / self.M)
        metrics = {k: self._world_mean(v) for k, v in metrics.items()} if self.M == 1 else {}
        clip = {}
        if self.max_grad_norm is not None:
            grads, clip["grad_norm"] = self._clip(grads)
        params, opt_state, opt_metrics = self.optimizer.update(state.params, grads, state.opt_state)
        state.step, state.params, state.opt_state = state.step + 1, params, opt_state
        return state, {"loss": loss, **metrics, **opt_metrics, **clip}


def make_spmd_train_step(
    cfg: ModelConfig,
    mesh,
    batch_specs: Mapping,
    optimizer: Optimizer | None = None,
    num_microbatches: int = 1,
    remat: bool = True,
    gather_params_once: bool = False,
    strategy: str = "tp_fsdp",
    remat_blocks: bool = False,
    device=None,
):
    """Returns ``(step, (state_specs, batch_specs))`` as ``repro``'s does:
    ``step`` an :class:`SpmdTrainStep` for the rank at ``mesh``'s coordinate
    (a :func:`~repro_torch.launch.mesh.make_local_mesh` with its rank group;
    a one-process mesh needs none), ``state_specs`` the full state's meta
    tensors.  ``batch_specs`` maps batch keys to anything with a ``shape``
    (the global batch).  ``strategy`` is ``"tp_fsdp"`` (``repro``'s layout,
    the anchor of :func:`act_anchor_for`; ``remat`` checkpoints the whole
    loss, ``remat_blocks`` each layer instead; ``gather_params_once`` as in
    the module docstring) or ``"zero3"`` (every axis splits the batch where
    it divides, per-layer remat; ``repro``'s zero3 takes neither ``remat`` nor
    ``gather_params_once``).  ``device`` defaults to the group's, else cuda."""
    optimizer = optimizer or make_optimizer("adamw")
    M = num_microbatches
    batch_size = next(v.shape[0] for k, v in batch_specs.items() if k != "mrope_positions")
    if strategy == "zero3":
        row_axes = _zero3_dp_axes(mesh, batch_size, M)
        anchor = row_axes if len(row_axes) > 1 else (row_axes[0] if row_axes else None)
        cfg = cfg.replace(act_sharding=(anchor, None, None), remat_blocks=True)
        remat, gather_params_once = False, False
    elif strategy == "tp_fsdp":
        cfg = act_anchor_for(cfg, mesh, batch_size, M)
        row_axes = spec_axes(cfg.act_sharding[0]) if cfg.act_sharding else ()
        if remat_blocks:
            cfg = cfg.replace(remat_blocks=True)
            remat = False
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    state_specs = state_specs_for(cfg, optimizer)
    step = SpmdTrainStep(cfg, mesh, optimizer, M, remat, gather_params_once, strategy, row_axes, state_specs,
                         torch.device(_device(mesh, device)))
    return step, (state_specs, dict(batch_specs))


class _Serving:
    """What the sharded prefill and decode share: the anchored config, the
    stationary weights' specs (``param_pspecs(..., fsdp=False)``) and each
    leaf's use, the rank's rows, the ``use`` hook that hands the model the
    rank's shards (gathering only the leaves no product follows), and with
    ``kv_len`` the layout of the rank's shard of the decode cache."""

    def __init__(self, cfg, mesh, batch_size: int, device, kv_len: int | None = None):
        self.cfg = act_anchor_for(cfg, mesh, batch_size)
        self.mesh, self.device, self.kv_len = mesh, torch.device(device), kv_len
        anchor = self.cfg.act_sharding
        self.row_axes = spec_axes(anchor[0]) if anchor else ()
        self.tp = TensorParallel(mesh, kv_len)
        self.param_specs = state_specs_for(cfg, make_optimizer()).params
        self.specs = flatten(param_pspecs(self.param_specs, mesh, fsdp=False))
        self.uses = {k: leaf_use(k, spec, self.cfg, self.tp.size, self.tp.rank) for k, spec in self.specs.items()}
        self._gather = {k: gather_spec(spec, self.uses[k], data=True) for k, spec in self.specs.items()}
        self._path_of: dict = {}
        if kv_len is not None:
            self.cache_specs = api.init_cache(self.cfg, batch_size, kv_len, device="meta")
            self.cache_pspecs = flatten(map_with_path(lambda _, s: s.spec, cache_shardings(self.cache_specs, mesh)))

    def init_cache(self):
        """The rank's shard of an empty cache."""
        return map_with_path(
            lambda k, t: torch.zeros(local_shape(t.shape, self.cache_pspecs[k], self.mesh), dtype=t.dtype,
                                     device=self.device), self.cache_specs)

    def shard_cache(self, cache):
        """The rank's shard of a full cache (``api.init_cache``'s layout)."""
        return map_with_path(lambda k, t: local_shard(t.to(self.device), self.cache_pspecs[k], self.mesh).clone(),
                             cache)

    def gather_cache(self, cache):
        """The full cache on every rank from each rank's shard."""
        return map_with_path(lambda k, t: gather(t, self.cache_pspecs[k], self.mesh), cache)

    def init_params(self, seed: int = 0):
        """The rank's shards of ``api.init_serving_params(cfg, seed)``."""
        return _draw_shards(self.cfg, self.specs, self.mesh, self.device, seed, serving=True)

    def shard_params(self, params):
        """The rank's shards of a full parameter tree."""
        return map_with_path(lambda k, t: local_shard(t.to(self.device), self.specs[k], self.mesh).clone(), params)

    def _leaf(self, t, path):
        spec, cols = self._gather[path], self.uses[path].cols
        if _named(spec):
            t = gather(t, spec, self.mesh)
            if MODEL in _named(spec):
                self.tp.gathered.add(path)
        return t if cols is None else t.narrow(-1, *cols)

    def _use(self, part):
        return tree_map(lambda t: self._leaf(t, self._path_of[id(t)]), part)

    def local_rows(self, batch: Mapping[str, torch.Tensor]) -> dict:
        """The rank's rows of ``batch`` on its device."""
        n = math.prod(self.mesh.shape[a] for a in self.row_axes)
        i = self.mesh.index(self.row_axes)
        out = {}
        for k, v in batch.items():
            d = _batch_dim(k)
            out[k] = v.narrow(d, i * (v.shape[d] // n), v.shape[d] // n).to(self.device)
        return out

    def _all_rows(self, logits):
        if self.row_axes and self.mesh.size > 1:
            return self.mesh.group.all_gather_over(logits, self.row_axes, dim=0)
        return logits

    def _run(self, params, fn):
        self._path_of = {id(t): k for k, t in flatten(params).items()}
        try:
            with torch.no_grad():
                return fn()
        finally:
            self._path_of = {}


class SpmdPrefill(_Serving):
    """One rank's sharded prefill: ``prefill(params, batch, cache=None) ->
    logits [B, 1, V]`` of the whole global ``batch`` (every rank passes the
    same one and takes its rows), ``params`` the rank's shards.  A text
    family runs ``prefill_with_cache``'s path (Mamba2's recurrence on the
    rank's heads), filling ``cache`` in place when one is given (the rank's
    shard of a fresh cache under ``kv_len``, :meth:`init_cache`); the
    encoder-decoder and the VLM run ``prefill_fn``, as ``repro``'s does
    (neither has ``prefill_with_cache``).  Build it with
    :func:`make_spmd_prefill`."""

    def __call__(self, params, batch: Mapping[str, torch.Tensor], cache=None):
        rows = self.local_rows(batch)
        if self.cfg.family in ("encdec", "vlm"):
            if cache is not None:
                raise ValueError(f"family {self.cfg.family!r} has no prefill_with_cache")
            return self._run(params, lambda: self._all_rows(
                api.prefill_fn(params, self.cfg, rows, use=self._use, tp=self.tp)))
        if cache is not None and self.kv_len is None:
            raise ValueError("a cache needs make_spmd_prefill(..., kv_len=...)")
        return self._run(params, lambda: self._all_rows(
            api.prefill_with_cache(params, self.cfg, cache, rows, use=self._use, tp=self.tp)[0]))


class SpmdServeStep(_Serving):
    """One rank's sharded decode step: ``step(params, cache, index, batch)
    -> (logits [B, 1, V], cache)``, ``cache`` the rank's shard under
    ``cache_shardings`` (updated in place), ``index`` one position or a [B]
    vector of the global batch's.  Build it with
    :func:`make_spmd_serve_step`."""

    def __call__(self, params, cache, index, batch: Mapping[str, torch.Tensor]):
        rows = self.local_rows(batch)
        index = torch.as_tensor(index, dtype=torch.long)
        if index.ndim:
            index = self.local_rows({"index": index})["index"]
        else:
            index = index.to(self.device)
        logits = self._run(params, lambda: api.decode_fn(params, self.cfg, cache, index, rows, use=self._use,
                                                         tp=self.tp)[0])
        return self._all_rows(logits), cache


def _device(mesh, device):
    """``device``, else the rank group's, else cuda."""
    if device is not None:
        return device
    return mesh.group.device if mesh.group is not None else resolve_device(None)


def make_spmd_prefill(cfg: ModelConfig, mesh, batch_specs: Mapping, device=None, kv_len: int | None = None):
    """Returns ``(prefill, (param_specs, batch_specs))`` as ``repro``'s does:
    ``prefill`` an :class:`SpmdPrefill` for the rank at ``mesh``'s
    coordinate (the module docstring), ``param_specs`` the full parameter
    tree's meta tensors.  ``batch_specs`` maps batch keys to anything with
    a ``shape`` (the global batch); ``kv_len`` lays out the cache the
    prefill may fill (as :func:`make_spmd_serve_step`'s at that length)."""
    batch_size = next(v.shape[0] for k, v in batch_specs.items() if k != "mrope_positions")
    step = SpmdPrefill(cfg, mesh, batch_size, _device(mesh, device), kv_len)
    return step, (step.param_specs, dict(batch_specs))


def make_spmd_serve_step(cfg: ModelConfig, mesh, batch_specs: Mapping, kv_len: int, device=None):
    """Returns ``(step, (param_specs, cache_specs, index_spec, batch_specs))``
    as ``repro``'s does: ``step`` an :class:`SpmdServeStep` (one new token
    against a ``kv_len`` cache, the module docstring), the specs as meta
    tensors of the full trees."""
    batch_size = next(iter(batch_specs.values())).shape[0]
    step = SpmdServeStep(cfg, mesh, batch_size, _device(mesh, device), kv_len)
    index_spec = torch.empty((), dtype=torch.int32, device="meta")
    return step, (step.param_specs, step.cache_specs, index_spec, dict(batch_specs))
