"""AdamW with decoupled weight decay (Loshchilov & Hutter).

Port of ``repro/optim/adamw.py``.  The state holds fp32 first and second
moments shaped like the parameters, and a step count.  Unlike the
reference, :func:`adamw_update` updates the parameters and the moments in
place (and returns them): at mamba2-780m a functional update would hold a
second copy of 9.4 GB of parameters and moments.

Weight decay follows the reference's rule as the reference applies it.
``repro`` decays every leaf with ``ndim >= 2`` (``adamw.py:59``), and it
stacks the layers into ``[n_blocks, ...]`` leaves, so every per-layer leaf
is at least 2-D there: norm scales, ``A_log``, ``D``, ``dt_bias`` and
``conv_b`` are decayed.  The port keeps one 1-D tensor per layer for
those, so :func:`decay_mask` reads the rank each leaf has in the reference
layout: a leaf under ``layers/`` gains the stacked axis, and the rest
(``embed/table`` decayed, ``final_norm/scale`` not) keep their own.  A
pipeline's parameters (a list of per-virtual-stage trees) are stacked once
more over the stages in the reference (``[V, ...]``, and ``[V, reps, ...]``
for the layers), so there every leaf, ``final_norm`` and the layers' norm
scales and biases included, has rank >= 2 and is decayed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import flatten, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_update", "decay_mask"]


@dataclasses.dataclass
class AdamWState:
    step: int
    m: Any  # tree like params, fp32
    v: Any  # tree like params, fp32


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))


def decay_mask(params) -> dict[str, bool]:
    """``{path: decayed}``: the leaf's rank in the reference's stacked layout
    is >= 2.  ``params`` is one model's tree, or a pipeline's list of
    per-virtual-stage trees (paths ``<stage>/...``)."""
    staged = isinstance(params, list)
    mask = {}
    for key, t in flatten(params).items():
        group = key.split("/")[1 if staged else 0]
        mask[key] = t.ndim + int(staged) + int(group == "layers") >= 2
    return mask


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    """Returns (params, state), both updated in place."""
    step = state.step + 1
    c1 = 1.0 - b1**step
    c2 = 1.0 - b2**step
    decay = decay_mask(params)
    flat_g, flat_m, flat_v = flatten(grads), flatten(state.m), flatten(state.v)
    for key, p in flatten(params).items():
        g32, m, v = flat_g[key].float(), flat_m[key], flat_v[key]
        m.mul_(b1).add_((1.0 - b1) * g32)
        v.mul_(b2).add_((1.0 - b2) * g32.square())
        delta = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay and decay[key]:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state.step = step
    return params, state
