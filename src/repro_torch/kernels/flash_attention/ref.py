"""Plain PyTorch version of flash attention: the kernel's oracle.

Port of ``repro/kernels/flash_attention/ref.py``: materialised fp32 scores,
causal and sliding-window masks, softmax, then probabilities in v's type
times v.  q [B, T, H, hd]; k, v [B, S, K, hd] with ``H % K == 0`` (query
head h reads KV head ``h // (H // K)``, folded into the einsum instead of a
repeated copy).  Queries are aligned to the end of the key range: query i
sits at key position ``i + S - T``.

The training side of ``repro/models/attention.py`` lives here too, since the
kernel's training entry differentiates it: :func:`chunked_attention` (the
same function over query chunks of ``q_chunk``, one ``[B, H, q_chunk, S]``
score tile at a time) and :func:`train_attention`, which picks
:func:`attention` below :data:`CHUNKED_ATTN_THRESHOLD` query tokens and
:func:`chunked_attention` from it up, as the reference's ``attn_train``
does without its flash kernel.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "attention",
    "causal_window_mask",
    "chunked_attention",
    "train_attention",
    "train_attention_flops",
    "CHUNKED_ATTN_THRESHOLD",
]

#: query length at and above which the training attention runs in chunks
CHUNKED_ATTN_THRESHOLD = 2048
#: query tokens a chunk of :func:`chunked_attention` holds (at most)
Q_CHUNK = 512


def causal_window_mask(T: int, S: int, causal: bool, window: int | None, device=None):
    """[T, S] boolean mask of the key positions each query sees.  Query i
    sits at ``i + S - T``: causal keeps ``k_pos <= q_pos``, a window keeps
    ``k_pos > q_pos - window`` (the reference's ``_causal_window_mask``)."""
    return _mask_at(torch.arange(T, device=device) + (S - T), S, causal, window)


def _mask_at(q_pos, S: int, causal: bool, window: int | None):
    """[len(q_pos), S] mask for queries at key positions ``q_pos``."""
    q_pos = q_pos[:, None]
    k_pos = torch.arange(S, device=q_pos.device)[None, :]
    mask = torch.ones((q_pos.shape[0], S), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def _attend(q, k, v, mask):
    B, T, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, T, K, H // K, hd).float()
    logits = torch.einsum("btkrh,bskh->bkrts", qg, k.float()) * (1.0 / math.sqrt(hd))
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrts,bskh->btkrh", probs.to(v.dtype), v)
    return out.reshape(B, T, H, hd)


def attention(q, k, v, causal: bool = True, window: int | None = None):
    T, S = q.shape[1], k.shape[1]
    return _attend(q, k, v, causal_window_mask(T, S, causal, window, q.device))


def chunked_attention(q, k, v, causal: bool = True, window: int | None = None, q_chunk: int = Q_CHUNK):
    """:func:`attention` over query chunks (the reference's ``lax.map``
    written as a loop): T is padded to a multiple of ``q_chunk``, and chunk
    ``i`` holds the queries at key positions ``i * q_chunk + j + S - T``."""
    T, S = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, T)
    pad = (-T) % q_chunk
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    pos = torch.arange(T + pad, device=q.device) + (S - T)
    out = [
        _attend(q[:, i : i + q_chunk], k, v, _mask_at(pos[i : i + q_chunk], S, causal, window))
        for i in range(0, T + pad, q_chunk)
    ]
    return torch.cat(out, dim=1)[:, :T]


def train_attention(q, k, v, causal: bool = True, window: int | None = None):
    """The plain training attention: :func:`attention` below
    :data:`CHUNKED_ATTN_THRESHOLD` query tokens, :func:`chunked_attention`
    from it up."""
    if q.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        return chunked_attention(q, k, v, causal=causal, window=window)
    return attention(q, k, v, causal=causal, window=window)


def train_attention_flops(B: int, T: int, S: int, H: int, hd: int) -> int:
    """FLOPs of :func:`train_attention`'s forward as an operation counter
    counts its two products (2 per multiply-add): ``q.kT`` and ``p.v`` over
    the full T x S square, masked or not, 2*B*H*T*S*hd each; from
    :data:`CHUNKED_ATTN_THRESHOLD` query tokens up over T padded to a
    whole number of chunks."""
    if T >= CHUNKED_ATTN_THRESHOLD:
        T = -(-T // Q_CHUNK) * Q_CHUNK
    return 4 * B * H * T * S * hd
