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

``shards`` is for leaves split over ranks (the distributed step): the
statistics' means over a leaf's rows and columns and the RMS of its whole
update are reductions across the shards.  :class:`Whole` (the default)
takes them over a leaf held whole in this process; the distributed step's
view (:class:`repro_torch.distributed.spmd.ShardedStats`) sums the local
partial sums over the ranks that split the reduced dims, and keeps the
statistics in the reference's layout, moving them to the shards' layout
for the update and back.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.tree import flatten

__all__ = ["AdafactorState", "Whole", "adafactor_init", "adafactor_update"]


@dataclasses.dataclass
class AdafactorState:
    step: int
    v_row: dict  # {group name: [n] row stats (rank >= 2) or the full v (rank < 2)}
    v_col: dict  # {group name: [m] column stats (rank >= 2) or a () placeholder}


class Whole:
    """Every group held whole in this process: the reductions are local and
    the statistics are used where they are stored."""

    def shapes(self, name: str, shape: tuple) -> tuple[tuple, tuple]:
        """The (v_row, v_col) shapes of a factored group of ``shape``."""
        return shape[:-1], shape[:-2] + shape[-1:]

    def mean(self, name: str, t, dim: int, of: int, keepdim: bool = False):
        """The mean of ``t`` over its ``dim``, which is the group's dim ``of``."""
        return t.mean(dim=dim, keepdim=keepdim)

    def square_mean(self, name: str, u):
        return u.square().mean()

    def load(self, name: str, vr, vc):
        """The statistics in the layout of the group's gradient."""
        return vr, vc

    def store(self, name: str, vr, vc, vr_used, vc_used) -> None:
        """Write the updated statistics back where they are stored."""


def _leaf_layout(params) -> list:
    """Every leaf its own unstacked group, named by its path."""
    return [(key, [key], False) for key in flatten(params)]


def _shape(leaves: list, stacked: bool) -> tuple:
    shape = tuple(leaves[0].shape)
    return (len(leaves), *shape) if stacked else shape


def adafactor_init(params, layout=None, shards=None) -> AdafactorState:
    layout = layout or _leaf_layout(params)
    shards = shards or Whole()
    flat = flatten(params)
    v_row, v_col = {}, {}
    for name, paths, stacked in layout:
        leaves = [flat[k] for k in paths]
        shape, dev = _shape(leaves, stacked), leaves[0].device
        if len(shape) >= 2:  # factored: reduce over the last axis, and over the one before
            row, col = shards.shapes(name, shape)
            v_row[name] = torch.zeros(row, dtype=torch.float32, device=dev)
            v_col[name] = torch.zeros(col, dtype=torch.float32, device=dev)
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
    shards=None,
):
    """Returns (params, state), both updated in place."""
    layout = layout or _leaf_layout(params)
    shards = shards or Whole()
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
        vr, vc = shards.load(name, state.v_row[name], state.v_col[name])
        if g32.ndim >= 2:
            vr.mul_(b2).add_((1.0 - b2) * shards.mean(name, g2, -1, of=-1))
            vc.mul_(b2).add_((1.0 - b2) * shards.mean(name, g2, -2, of=-2))
            # v ~ (vr x vc) / mean(vr)
            r = vr / shards.mean(name, vr, -1, of=-2, keepdim=True).clamp(min=eps)
            u = g32 / torch.sqrt((r[..., None] * vc[..., None, :]).clamp(min=eps))
        else:
            vr.mul_(b2).add_((1.0 - b2) * g2)
            u = g32 / torch.sqrt(vr.clamp(min=eps))
        del g2
        shards.store(name, state.v_row[name], state.v_col[name], vr, vc)
        # update clipping: divide by max(1, RMS(u) / threshold)
        rms_u = torch.sqrt(shards.square_mean(name, u))
        u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
        decay = weight_decay and g32.ndim >= 2
        for i, p in enumerate(ps):
            ui = u[i] if stacked else u
            if decay:
                ui = ui + weight_decay * p.float()
            p.copy_(p.float() - lr * ui)
    state.step = step
    return params, state
