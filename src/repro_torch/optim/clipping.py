"""Gradient clipping utilities (port of ``repro/optim/clipping.py``)."""

from __future__ import annotations

import torch

from repro_torch.tree import flatten, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree, reduce=None) -> torch.Tensor:
    """The L2 norm over every leaf.  ``reduce``, if given, sums the squared
    norm over the ranks that hold the rest of the tree before the root."""
    leaves = list(flatten(tree).values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    sq = sum(g.float().square().sum() for g in leaves)
    return torch.sqrt(sq if reduce is None else reduce(sq))


def clip_by_global_norm(tree, max_norm: float, reduce=None):
    """Scale gradients so their global norm is at most ``max_norm``.
    Returns (clipped tree, norm before clipping); ``reduce`` as in
    :func:`global_norm`."""
    norm = global_norm(tree, reduce)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm
