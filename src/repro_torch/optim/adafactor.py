"""Adafactor (Shazeer & Stern, 2018) with factored second moments.

Port of ``repro/optim/adafactor.py``, the optimizer of the >= 100 B MoE
configs (kimi-k2, llama4-maverick): the factored row/column statistics
cost O(n + m) per (n, m) matrix instead of O(nm).  A leaf of rank >= 2
keeps the mean of the squared gradient over its last axis (``v_row``,
shape ``p.shape[:-1]``) and over its second to last (``v_col``,
``p.shape[:-2] + p.shape[-1:]``), so an expert bank ``[E, d, ff]`` keeps
``[E, d]`` and ``[E, ff]``; a leaf of lower rank keeps the full second
moment.  β₂ follows the step, ``1 - t^-0.8``; the update is clipped by its
RMS; weight decay (off by default) is decoupled and applies to rank >= 2
only.  The learning rate comes from outside, as for AdamW.

Ranks, the RMS clip and the factored statistics are taken in the
reference's layout: ``repro`` stacks the layers of its repeating block into
``[n_blocks, ...]`` leaves and keeps a leaf's statistics and RMS over the
stack.  ``layout`` (:func:`repro_torch.models.transformer.reference_layout`)
names those stacks: a list of ``(name, paths, stacked)``, each group's
port leaves (paths of :func:`repro_torch.tree.flatten`) stacked on a new
first axis when ``stacked``, and the state is kept per group under
``name``, the reference's path, in the reference's shapes.  Without a
layout every leaf is its own unstacked group.  :func:`adafactor_update`
updates the parameters in place (and returns them).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import flatten

__all__ = ["AdafactorState", "adafactor_init", "adafactor_update"]


@dataclasses.dataclass
class AdafactorState:
    step: int
    v_row: dict  # {group name: [n] row stats (rank >= 2) or the full v (rank < 2)}
    v_col: dict  # {group name: [m] column stats (rank >= 2) or a () placeholder}


def _leaf_layout(params) -> list:
    """Every leaf its own unstacked group, named by its path."""
    return [(key, [key], False) for key in flatten(params)]


def _shape(leaves: list, stacked: bool) -> tuple:
    shape = tuple(leaves[0].shape)
    return (len(leaves), *shape) if stacked else shape


def adafactor_init(params, layout=None) -> AdafactorState:
    layout = layout or _leaf_layout(params)
    flat = flatten(params)
    v_row, v_col = {}, {}
    for name, paths, stacked in layout:
        leaves = [flat[k] for k in paths]
        shape, dev = _shape(leaves, stacked), leaves[0].device
        if len(shape) >= 2:  # factored: reduce over the last axis, and over the one before
            v_row[name] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
            v_col[name] = torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, device=dev)
        else:
            v_row[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
            v_col[name] = torch.zeros((), dtype=torch.float32, device=dev)
    return AdafactorState(step=0, v_row=v_row, v_col=v_col)


def _stack(leaves: list, stacked: bool) -> torch.Tensor:
    if not stacked:
        return leaves[0]
    return leaves[0][None] if len(leaves) == 1 else torch.stack(leaves)


@torch.no_grad()
def adafactor_update(
    params,
    grads,
    state: AdafactorState,
    lr: float,
    decay_rate: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    layout=None,
):
    """Returns (params, state), both updated in place."""
    layout = layout or _leaf_layout(params)
    step = state.step + 1
    # time-dependent decay: beta2_t = 1 - t^-0.8 (Adafactor paper eq. 37), in fp32
    beta2 = 1.0 - torch.tensor(float(step), dtype=torch.float32) ** -decay_rate
    flat_p, flat_g = flatten(params), flatten(grads)
    for name, paths, stacked in layout:
        ps = [flat_p[k] for k in paths]
        g32 = _stack([flat_g[k] for k in paths], stacked).float()
        dev = g32.device
        b2 = beta2.to(dev)
        g2 = g32.square() + eps
        vr, vc = state.v_row[name], state.v_col[name]
        if g32.ndim >= 2:
            vr.mul_(b2).add_((1.0 - b2) * g2.mean(dim=-1))
            vc.mul_(b2).add_((1.0 - b2) * g2.mean(dim=-2))
            # v ~ (vr x vc) / mean(vr)
            r = vr / vr.mean(dim=-1, keepdim=True).clamp(min=eps)
            u = g32 / torch.sqrt((r[..., None] * vc[..., None, :]).clamp(min=eps))
        else:
            vr.mul_(b2).add_((1.0 - b2) * g2)
            u = g32 / torch.sqrt(vr.clamp(min=eps))
        del g2
        # update clipping: divide by max(1, RMS(u) / threshold)
        rms_u = torch.sqrt(u.square().mean())
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        decay = weight_decay and g32.ndim >= 2
        for i, p in enumerate(ps):
            ui = u[i] if stacked else u
            if decay:
                ui = ui + weight_decay * p.float()
            p.copy_(p.float() - lr * ui)
    state.step = step
    return params, state
