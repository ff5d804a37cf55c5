"""Mixture-of-Experts layer: top-k router and capacity-based sorted dispatch.

Port of ``repro/models/moe.py``.  Tokens are routed with a fixed
per-expert capacity ``C = floor(T * top_k * capacity_factor / E) + 1``
and packed into a dense ``[E, C, d]`` buffer by an argsort-based dispatch
(a stable sort of the (token, slot) entries by expert, ``searchsorted`` for
each expert's first entry, each entry's rank within its expert); entries
ranked at or past ``C`` are dropped (GShard/Switch semantics).  The expert
SwiGLUs run as batched matrix products over the expert dimension
(``torch.bmm``), as the reference runs them as einsums outside any Pallas
kernel.  The router carries the Switch load-balance loss and the router
z-loss.

Two entry points, one dispatch:

* :func:`moe_apply` -- ``x [T, d]`` routed as one group, the reference's
  flat ``moe_apply`` (the training forward, prefill and ``api.decode_fn``);
* :func:`moe_apply_grouped` -- ``x [G, S, d]``, each of the G groups routed
  and packed on its own with its own capacity (``S`` in place of ``T``),
  the math of the reference's ``moe_apply_grouped`` (its ``slots_one``,
  ``dispatch_one`` and ``combine_one``) without its sharding pins, and
  without its ``slots_one`` overwrite of expert 0's first slot by a dropped
  entry (ROADMAP.md queue 3).  The serve engine's decode routes each slot
  row as its own group (``G = b``, ``S = 1``), as the reference engine's
  per-slot ``vmap`` does, and the training forward under
  ``cfg.act_sharding`` each batch row (the reference's distributed form);
  the G groups share one batched product over the experts, so each
  expert's weights are read once a call.

**Rows split over ranks.**  The distributed step gives each rank some rows
of a micro-batch.  The load-balance term ``E * sum_e frac_e * mean_prob_e``
over the micro-batch's G * S tokens is a product of two batch means, so the
mean of per-rank terms is not the whole term.  With ``row_sum`` (a function
that sums a tensor in place over the ranks holding the micro-batch's
rows), the expert counts are summed over those ranks (``frac`` is then the
whole micro-batch's; it carries no gradient) and each rank's term is
``E * sum_e frac_e * local_mean_prob_e``: its mean over the ranks, value and
gradient, is the whole micro-batch's term, as the mean of the router z-loss
and of the cross-entropy over equal row counts are.

**Experts split over ranks.**  ``_moe(..., experts=(first, count))`` is one
rank's part of an expert-parallel layer
(:meth:`repro_torch.distributed.tensor_parallel.TensorParallel.moe`): every
entry is routed over all E experts, so the capacity and the drops are the
whole layer's, and only the kept entries routed to the rank's experts are
packed, computed and combined; the ranks' partial outputs sum to the
whole.

The router logits are computed in fp32 from the fp32 router weight (the
serving cast leaves ``router/w`` in ``param_dtype``); the expert banks are
used in ``cfg.dtype``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import _normal, dense_init, mlp, mlp_init

__all__ = ["moe_init", "moe_apply", "moe_apply_grouped", "router_topk", "route"]


def moe_init(gen: torch.Generator, cfg: ModelConfig, finish=None):
    """The layer's parameters, drawn from ``gen`` in this order: the router
    ``[d, E]``, the ``gate``, ``up`` (``[E, d, ff]``) and ``down``
    (``[E, ff, d]``) expert banks, then the shared expert's SwiGLU.
    ``finish`` (default: none) maps ``{name: bank}`` as soon as that bank is
    drawn, so that a cast holds one bank at a time in ``param_dtype``."""
    finish = finish or (lambda part: part)
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.expert_ff

    def bank(name, shape, fan_in):
        drawn = _normal(gen, shape, cfg).mul_(1.0 / math.sqrt(fan_in))  # in place: one bank in fp32
        return finish({name: drawn})[name]

    p = {"router": dense_init(gen, d, E, cfg)}
    p["experts"] = {
        "gate": bank("gate", (E, d, ff), d),
        "up": bank("up", (E, d, ff), d),
        "down": bank("down", (E, ff, d), ff),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=ff * cfg.n_shared_experts)
    return p


def router_topk(cfg: ModelConfig, logits):
    """Top-k routing weights over the last axis.  Returns (weights [..., k],
    idx [..., k], probs [..., E]), all from fp32 logits."""
    k = cfg.num_experts_per_tok
    logits = logits.float()
    if cfg.router_scoring == "sigmoid":  # kimi-k2 style
        scores = torch.sigmoid(logits)
        w, idx = torch.topk(scores, k, dim=-1)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
        probs = scores / scores.sum(-1, keepdim=True).clamp(min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
        w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    return w, idx, probs


def _load_balance_loss(cfg: ModelConfig, probs, idx, row_sum=None):
    """Switch-style aux loss: E * <fraction routed to e> . <mean prob of e>.
    probs [T, E], idx [T, k]; ``row_sum`` sums the counts over the ranks that
    hold the rest of the micro-batch (the module docstring)."""
    E = cfg.num_experts
    flat = idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.long, device=idx.device).scatter_add_(0, flat, torch.ones_like(flat)).float()
    if row_sum is not None:
        counts = row_sum(counts)
    frac = counts / counts.sum().clamp(min=1.0)
    return E * (frac * probs.mean(dim=0)).sum()


def route(p, x, cfg: ModelConfig, capacity_factor: float | None = None) -> dict:
    """The routing of ``x [G, S, d]``, each group on its own: ``logits``
    [G, S, E] (fp32), ``w``, ``idx`` [G, S, k], ``probs`` [G, S, E], and
    per (token, slot) entry in token-major order ``rank`` [G, S*k] (the
    entry's place among its expert's entries, in token order) and ``keep``
    (``rank < C``); ``C`` the capacity of a group."""
    G, S, _ = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = x.float() @ p["router"]["w"].float()
    w, idx, probs = router_topk(cfg, logits)
    flat_e = idx.reshape(G, S * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # group by expert, token order within
    se = flat_e.gather(-1, order)
    experts = torch.arange(E, device=x.device).expand(G, E).contiguous()
    seg_start = torch.searchsorted(se, experts, side="left")  # [G, E]
    ranked = torch.arange(S * k, device=x.device) - seg_start.gather(-1, se)
    rank = torch.empty_like(ranked).scatter_(-1, order, ranked)  # back to token-major order
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    C = max(int((S * k * cf) // E) + 1, 1)
    return {"logits": logits, "w": w, "idx": idx, "probs": probs, "rank": rank, "keep": rank < C, "C": C}


def _moe(p, x, cfg: ModelConfig, capacity_factor: float | None, row_sum=None, experts=None, shared: bool = True,
         on_route=None):
    """x [G, S, d] -> (y [G, S, d] in cfg.dtype, aux), each group routed on its own.

    ``experts`` (first, count) computes one rank's part of an
    expert-parallel layer: the banks hold those experts only, every entry
    is routed over all E (so C and ``keep`` are the whole layer's) and only
    the kept entries routed to them are dispatched and combined; ``shared``
    adds the shared expert (as ``p["shared"]`` holds it); ``on_route`` is
    called with the routing (``route``'s dict)."""
    G, S, d = x.shape
    E, k, dt = cfg.num_experts, cfg.num_experts_per_tok, cfg.dtype
    r = route(p, x, cfg, capacity_factor)
    if on_route is not None:
        on_route(r)
    C, keep, rank = r["C"], r["keep"], r["rank"]
    first, n = experts or (0, E)
    local = r["idx"].reshape(G, S * k) - first
    mine = keep & (local >= 0) & (local < n) if experts else keep

    # dispatch: scatter every entry's token into a [G, n * C + 1, d] buffer,
    # the kept ones to their (expert, rank) slots and the rest to the spare
    # last slot, which is cut off (static shapes: no value is read)
    slot = torch.where(mine, local * C + rank, n * C)
    src = x.repeat_interleave(k, dim=1)  # [G, S * k, d], token-major like the entries
    buf = x.new_zeros((G, n * C + 1, d)).scatter(1, slot[..., None].expand(G, S * k, d), src)
    buf = buf[:, : n * C].reshape(G, n, C, d)

    # the expert SwiGLUs, batched over the experts; the G groups' rows share each product
    ex = p["experts"]
    rows = buf.to(dt).transpose(0, 1).reshape(n, G * C, d)
    h = F.silu(torch.bmm(rows, ex["gate"].to(dt))) * torch.bmm(rows, ex["up"].to(dt))
    out = torch.bmm(h, ex["down"].to(dt)).reshape(n, G, C, d).transpose(0, 1)  # [G, n, C, d]

    # combine: each token's k outputs, weighted (dropped entries, and another rank's, weigh 0)
    gathered = out[torch.arange(G, device=x.device)[:, None], local.clamp(0, n - 1), rank.clamp(max=C - 1)]
    gathered = torch.where(mine[..., None], gathered, 0.0)
    weight = torch.where(mine, r["w"].reshape(G, S * k), 0.0).to(dt)
    y = (gathered * weight[..., None]).reshape(G, S, k, d).sum(dim=2)

    if cfg.n_shared_experts and shared:
        y = y + mlp(p["shared"], x, cfg)

    aux = {
        "load_balance": _load_balance_loss(cfg, r["probs"].reshape(-1, E), r["idx"].reshape(-1, k), row_sum),
        "router_z": torch.logsumexp(r["logits"], dim=-1).square().mean(),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y, aux


def moe_apply(p, x, cfg: ModelConfig, capacity_factor: float | None = None):
    """x [T, d] (already flattened), routed as one group.  Returns
    (y [T, d], aux dict: ``load_balance``, ``router_z``, ``dropped_frac``)."""
    y, aux = _moe(p, x[None], cfg, capacity_factor)
    return y[0], aux


def moe_apply_grouped(p, x, cfg: ModelConfig, capacity_factor: float | None = None, row_sum=None):
    """x [G, S, d], each group routed and packed on its own with the capacity
    of S tokens.  Returns (y [G, S, d], aux over all G * S tokens); with
    ``row_sum``, the load-balance term is this rank's share (the module
    docstring)."""
    return _moe(p, x, cfg, capacity_factor, row_sum)
