"""Weight and cache bridge between ``repro``'s trees and the port's.

The port cannot reproduce ``jax.random``, so parity runs carry the
reference's weights across.  The bridge takes them as numpy arrays keyed by
path, with the key scheme of ``repro/checkpoint/io.py::_path_str`` (dict
keys and list indices joined by ``/``), e.g. ``embed/table`` or
``blocks/0/attn/wq/w``.  It imports no JAX: flattening a JAX tree to such a
dictionary is the caller's work.

The reference keeps its irregular leading layers unstacked under
``prefix/<i>/...`` (kimi-k2's first dense layer; empty for the other
families) and stacks its repeating block of the rest into ``[n_blocks,
...]`` leaves (``blocks/<j>/...`` is layer ``j`` of the pattern in every
block, e.g. ``blocks/0/attn/wq/w``, ``blocks/0/mamba/A_log`` or
``blocks/1/moe/experts/gate``); the port keeps one entry per layer under
``layers/<i>/...``, the prefix first.  :func:`params_from_repro` unstacks
and :func:`params_to_repro` stacks back, bitwise.  A hybrid's layers hold
``kv`` or ``ssm`` caches by kind (jamba's period-8 block mixes them), and
:func:`cache_from_repro` carries each under its own key.

An encoder-decoder's layers are unstacked lists in both packages
(``encoder/<i>/...``, ``decoder/<i>/...`` with the decoder layers'
``xattn`` and ``ln_x``, and ``enc_norm``), so its trees map key for key;
its decode cache holds ``decoder/<i>/kv/...`` (the reference's ``xkv`` is
``None``, which flattens to nothing, and the port has no such entry).

A pipeline's parameters (``repro.pipeline.stage.StagedModel``) are stacked
once more, over the ``V`` virtual stages: ``blocks/<j>/...`` leaves are
``[V, reps, ...]`` (layer ``j`` of the pattern in each repeat of each
stage), ``embed/table`` is ``[V, vocab, d]`` and ``final_norm/scale``
``[V, d]``.  The port's :class:`~repro_torch.pipeline.stage.StagedModel`
keeps a list of ``V`` trees; :func:`staged_params_from_repro` and
:func:`staged_params_to_repro` convert both ways, bitwise.

A training state (``repro.training.TrainState`` with an AdamW state)
flattens to ``step``, ``params/...``, ``opt_state/step``,
``opt_state/m/...`` and ``opt_state/v/...``; the moments are stacked like
the parameters.  :func:`train_state_from_repro` and
:func:`train_state_to_repro` carry it to the port's
:class:`~repro_torch.training.TrainState` (per-virtual-stage lists, an
:class:`~repro_torch.optim.AdamWState`) and back, at any ``S * v``
layout, bitwise.

The multi-rank engine gives each rank only its chunks.
:func:`rank_params` cuts a rank's list (chunk ``c`` of stage ``s`` is
virtual stage ``plan.placement.vstage_of[s, c]``) out of the full one,
:func:`rank_train_state` a rank's training state out of ``repro``'s, and
:func:`gather_to_rank0` brings every rank's list back to global rank 0 in
global virtual-stage order (:func:`gather_train_state_to_rank0` a rank's
training state).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import structure
from repro_torch.optim import AdamWState
from repro_torch.training import TrainState
from repro_torch.tree import flatten, tree_map

__all__ = [
    "flatten",
    "params_from_repro",
    "params_to_repro",
    "cache_from_repro",
    "staged_params_from_repro",
    "staged_params_to_repro",
    "train_state_from_repro",
    "train_state_to_repro",
    "rank_params",
    "rank_train_state",
    "gather_to_rank0",
    "gather_train_state_to_rank0",
]

#: the tag of :func:`gather_to_rank0`'s transfers (the engine's channels use 0-5)
_GATHER_TAG = 6


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _set(tree: dict, path: list[str], value) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def _layer_index(st, idx: int, block: int) -> int:
    return len(st.prefix) + block * len(st.pattern) + idx


def _unflatten(flat: Mapping[str, np.ndarray], device) -> dict:
    """The tree of ``/``-joined paths, a node whose keys are all indices a list."""
    tree: dict = {}
    for key, arr in flat.items():
        _set(tree, key.split("/"), _tensor(arr, device))

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            if sorted(map(int, node)) != list(range(len(node))):
                raise ValueError(f"list entries {sorted(node)} are not 0..{len(node) - 1}")
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


def params_from_repro(flat: Mapping[str, np.ndarray], cfg: ModelConfig, device=None) -> dict:
    """The port's parameter tree from ``repro``'s flattened parameters."""
    if cfg.family == "encdec":
        tree = _unflatten(flat, device)
        if len(tree["encoder"]) != cfg.encoder_layers or len(tree["decoder"]) != cfg.num_layers:
            raise ValueError(f"{len(tree['encoder'])} encoder and {len(tree['decoder'])} decoder layers, "
                             f"the config has {cfg.encoder_layers} and {cfg.num_layers}")
        return tree
    st = structure(cfg)
    tree: dict = {}
    layers: dict[int, dict] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "blocks":
            idx, rest = int(parts[1]), parts[2:]
            if np.shape(arr)[0] != st.n_blocks:
                raise ValueError(f"{key}: {np.shape(arr)[0]} stacked blocks, the config has {st.n_blocks}")
            for n in range(st.n_blocks):
                _set(layers.setdefault(_layer_index(st, idx, n), {}), rest, _tensor(arr[n], device))
        elif parts[0] == "prefix":
            idx = int(parts[1])
            if idx >= len(st.prefix):
                raise ValueError(f"{key}: the config has {len(st.prefix)} prefix layers")
            _set(layers.setdefault(idx, {}), parts[2:], _tensor(arr, device))
        else:
            _set(tree, parts, _tensor(arr, device))
    if sorted(layers) != list(range(st.num_layers)):
        raise ValueError(f"expected layers 0..{st.num_layers - 1}, got {sorted(layers)}")
    tree["layers"] = [layers[i] for i in range(st.num_layers)]
    return tree


def params_to_repro(params: dict, cfg: ModelConfig) -> dict[str, np.ndarray]:
    """``repro``'s flattened parameters from the port's tree (the inverse of
    :func:`params_from_repro`; leaves in float32/float16)."""
    if cfg.family == "encdec":
        return {key: t.detach().cpu().numpy() for key, t in flatten(params).items()}
    st = structure(cfg)
    out: dict[str, np.ndarray] = {}
    for key, t in flatten({k: v for k, v in params.items() if k != "layers"}).items():
        out[key] = t.detach().cpu().numpy()
    layers = params["layers"]
    for i in range(len(st.prefix)):
        for key, t in flatten(layers[i]).items():
            out[f"prefix/{i}/{key}"] = t.detach().cpu().numpy()
    for j in range(len(st.pattern)):
        per_block = [flatten(layers[_layer_index(st, j, n)]) for n in range(st.n_blocks)]
        for key in per_block[0]:
            out[f"blocks/{j}/{key}"] = np.stack(
                [b[key].detach().cpu().numpy() for b in per_block]
            )
    return out


def cache_from_repro(
    flat: Mapping[str, np.ndarray], cfg: ModelConfig, slot_major: bool = False, device=None
) -> dict:
    """The port's decode cache from ``repro``'s flattened decode cache.

    ``slot_major=False``: the cache of ``api.init_cache(cfg, B, L)`` /
    ``prefill_with_cache``, leaves ``blocks/<j>/kv/k`` of shape
    ``[n_blocks, B, L, K, hd]`` (``prefix/<i>/kv/k``: ``[B, L, K, hd]``).
    ``slot_major=True``: ``ServeEngine.kv``, leaves ``[max_slots, n_blocks,
    1, L, K, hd]`` (prefix: ``[max_slots, 1, L, K, hd]``).  Either way the
    port's layer ``i`` holds ``{"kv": {"k", "v"}}`` of shape ``[B or
    max_slots, L, K, hd]`` (a Mamba2 layer ``{"ssm": {"state", "conv"}}``,
    in the same rows).  An encoder-decoder's cache (``api.init_cache``'s,
    leaves ``decoder/<i>/kv/k`` of shape ``[B, L, K, hd]``) maps key for key."""
    if cfg.family == "encdec":
        return _unflatten(flat, device)
    st = structure(cfg)
    layers: dict[int, dict] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        group, idx, rest = parts[0], int(parts[1]), parts[2:]
        arr = np.asarray(arr)
        if group == "prefix":
            _set(layers.setdefault(idx, {}), rest, _tensor(arr[:, 0] if slot_major else arr, device))
            continue
        if group != "blocks":
            raise ValueError(f"unexpected cache key {key!r}")
        for n in range(st.n_blocks):
            rows = arr[:, n, 0] if slot_major else arr[n]
            _set(layers.setdefault(_layer_index(st, idx, n), {}), rest, _tensor(rows, device))
    return {"layers": [layers[i] for i in range(st.num_layers)]}


def staged_params_from_repro(flat: Mapping[str, np.ndarray], staged, device=None) -> list[dict]:
    """The port's per-stage trees from ``repro``'s flattened, stacked
    ``StagedModel`` parameters; ``staged`` is the port's
    :class:`~repro_torch.pipeline.stage.StagedModel` of the same cut."""
    P, V = len(staged.pattern), staged.num_stages
    stages: list[dict] = [{"layers": [{} for _ in range(staged.layers_per_stage)]} for _ in range(V)]
    for key, arr in flat.items():
        parts = key.split("/")
        arr = np.asarray(arr)
        if arr.shape[0] != V:
            raise ValueError(f"{key}: {arr.shape[0]} stacked stages, the model has {V}")
        for vs in range(V):
            if parts[0] == "blocks":
                j, rest = int(parts[1]), parts[2:]
                if arr.shape[1] != staged.reps:
                    raise ValueError(f"{key}: {arr.shape[1]} repeats a stage, the model has {staged.reps}")
                for r in range(staged.reps):
                    _set(stages[vs]["layers"][r * P + j], rest, _tensor(arr[vs, r], device))
            else:
                _set(stages[vs], parts, _tensor(arr[vs], device))
    return stages


def staged_params_to_repro(params: list[dict], staged) -> dict[str, np.ndarray]:
    """``repro``'s flattened, stacked ``StagedModel`` parameters from the
    port's per-stage trees (the inverse of :func:`staged_params_from_repro`)."""
    P = len(staged.pattern)
    numpy = lambda t: t.detach().cpu().numpy()  # noqa: E731
    shared = [flatten({k: v for k, v in p.items() if k != "layers"}) for p in params]
    layers = [[flatten(layer) for layer in p["layers"]] for p in params]
    out = {key: np.stack([numpy(f[key]) for f in shared]) for key in shared[0]}
    for j in range(P):
        for key in layers[0][j]:
            out[f"blocks/{j}/{key}"] = np.stack(
                [np.stack([numpy(ls[r * P + j][key]) for r in range(staged.reps)]) for ls in layers]
            )
    return out


def _group(flat: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    n = len(prefix)
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix)}


def train_state_from_repro(flat: Mapping[str, np.ndarray], staged, device=None):
    """The port's pipeline :class:`~repro_torch.training.TrainState` (AdamW)
    from ``repro``'s flattened ``TrainState`` of the same ``StagedModel``
    cut (``staged`` the port's, at ``S * v`` virtual stages)."""
    params, m, v = (
        staged_params_from_repro(_group(flat, prefix), staged, device)
        for prefix in ("params/", "opt_state/m/", "opt_state/v/")
    )
    opt = AdamWState(step=int(flat["opt_state/step"]), m=m, v=v)
    return TrainState(step=int(flat["step"]), params=params, opt_state=opt)


def train_state_to_repro(state, staged) -> dict[str, np.ndarray]:
    """``repro``'s flattened ``TrainState`` from the port's (the inverse of
    :func:`train_state_from_repro`; the step counters as int32 scalars)."""
    out = {"step": np.asarray(state.step, np.int32), "opt_state/step": np.asarray(state.opt_state.step, np.int32)}
    for prefix, tree in (("params/", state.params), ("opt_state/m/", state.opt_state.m), ("opt_state/v/", state.opt_state.v)):
        out.update({prefix + k: a for k, a in staged_params_to_repro(tree, staged).items()})
    return out


def _placement(plan):
    """A plan's placement map, or the map itself."""
    return getattr(plan, "placement", plan)


def rank_params(all_params: list, plan, s: int) -> list:
    """Stage ``s``'s list of per-chunk trees, in chunk order, from the full
    list of ``S * v`` per-virtual-stage trees (no copies).  ``plan`` is a
    plan or its ``Placement``."""
    return [all_params[int(vs)] for vs in _placement(plan).vstage_of[s]]


def rank_train_state(flat: Mapping[str, np.ndarray], staged, plan, s: int, device=None):
    """Stage ``s``'s local :class:`~repro_torch.training.TrainState` under
    ``plan``'s placement (a plan or its ``Placement``) from ``repro``'s
    flattened ``TrainState`` of the same ``S * v`` cut: the chunks' trees of
    the parameters and of both AdamW moments (:func:`rank_params` of
    :func:`train_state_from_repro`)."""
    state = train_state_from_repro(flat, staged, device)
    opt = state.opt_state
    return TrainState(
        step=state.step,
        params=rank_params(state.params, plan, s),
        opt_state=AdamWState(step=opt.step, m=rank_params(opt.m, plan, s), v=rank_params(opt.v, plan, s)),
    )


def gather_to_rank0(local: list, plan, group) -> list | None:
    """The full list of per-virtual-stage trees on global rank 0, gathered
    from every stage of replica 0 (each rank's ``local`` list under
    ``plan``'s placement, e.g. its parameters or gradients; all leaves of
    one dtype; ``plan`` is a plan or its ``Placement``); ``None`` on every
    other rank.  Every rank of replica 0 must call it."""
    if group.d != 0:
        return None
    placement = _placement(plan)
    leaves = [t for tree in local for t in flatten(tree).values()]
    flat = torch.cat([t.reshape(-1) for t in leaves])
    if group.s != 0:
        group.exchange([(flat, 0, _GATHER_TAG)], [])
        group.wait_sends()
        return None
    full: list = [None] * placement.device_of.size
    for s in range(group.S):
        if s == 0:
            got = flat
        else:
            (h,) = group.exchange([], [(flat.shape, flat.dtype, s, _GATHER_TAG)])
            got = h.wait()
        parts = iter(torch.split(got, [t.numel() for t in leaves]))
        for c, tree in enumerate(local):
            full[int(placement.vstage_of[s, c])] = tree_map(
                lambda t: next(parts).view(t.shape).clone(), tree
            )
    return full


def gather_train_state_to_rank0(state, plan, group):
    """A rank-local :class:`~repro_torch.training.TrainState` (AdamW, or
    ``opt_state=None``) gathered to global rank 0: the full lists of the
    parameters and the moments in global virtual-stage order
    (:func:`gather_to_rank0` of each); ``None`` on every other rank.  Every
    rank of replica 0 must call it."""
    params = gather_to_rank0(state.params, plan, group)
    opt = state.opt_state
    if opt is not None:
        opt = AdamWState(step=opt.step, m=gather_to_rank0(opt.m, plan, group), v=gather_to_rank0(opt.v, plan, group))
    return None if params is None else TrainState(step=state.step, params=params, opt_state=opt)
