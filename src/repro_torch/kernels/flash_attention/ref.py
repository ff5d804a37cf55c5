"""Plain PyTorch version of flash attention: the kernel's oracle.

Port of ``repro/kernels/flash_attention/ref.py``: materialised fp32 scores,
causal and sliding-window masks, softmax, then probabilities in v's type
times v.  q [B, T, H, hd]; k, v [B, S, K, hd] with ``H % K == 0`` (query
head h reads KV head ``h // (H // K)``, folded into the einsum instead of a
repeated copy).  Queries are aligned to the end of the key range: query i
sits at key position ``i + S - T``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention", "causal_window_mask"]


def causal_window_mask(T: int, S: int, causal: bool, window: int | None, device=None):
    """[T, S] boolean mask of the key positions each query sees.  Query i
    sits at ``i + S - T``: causal keeps ``k_pos <= q_pos``, a window keeps
    ``k_pos > q_pos - window`` (the reference's ``_causal_window_mask``)."""
    q_pos = torch.arange(T, device=device)[:, None] + (S - T)
    k_pos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention(q, k, v, causal: bool = True, window: int | None = None):
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    r = H // K
    qg = q.reshape(B, T, K, r, hd).float()
    logits = torch.einsum("btkrh,bskh->bkrts", qg, k.float()) * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~causal_window_mask(T, S, causal, window, q.device), -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrts,bskh->btkrh", probs.to(v.dtype), v)
    return out.reshape(B, T, H, hd)
