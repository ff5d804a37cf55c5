"""Grouped-query attention with RoPE / M-RoPE, sliding windows, a KV cache
and encoder-decoder cross attention.

Port of ``repro/models/attention.py``:

* ``attn_train`` -- full-sequence causal (or, for an encoder, bidirectional)
  attention for training, with 1-D RoPE or, for an M-RoPE config given
  three position streams, M-RoPE.  Its attention goes through
  :func:`repro_torch.kernels.flash_attention.ops.flash_attention_train`:
  the CUDA kernel forward for a CUDA tensor (its backward differentiates
  the plain version), the plain version for a CPU tensor.  The plain
  version is what the reference's ``attn_train`` computes without its flash
  kernel: ``sdpa`` under the causal/window mask below
  ``CHUNKED_ATTN_THRESHOLD`` query tokens, ``chunked_attention`` from it up.
* ``cross_attn`` -- decoder queries over the encoder's memory, no
  positions on k/v and no mask.  The reference computes it with ``sdpa``
  and no mask, which is the function the kernel computes with
  ``causal=False`` at T query and S memory positions, so the full-sequence
  forward goes through ``flash_attention_train`` as ``attn_train`` does;
  one-token decode (``cross_attn_decode``) stays plain torch, as
  self-attention decode does.

* ``attn_prefill`` -- full-sequence causal attention that also fills the
  decode KV cache.  Its attention goes through
  :func:`repro_torch.kernels.flash_attention.ops.flash_attention`: the CUDA
  kernel for a CUDA tensor, the plain version for a CPU tensor.  At T == S
  that is the function the reference's ``sdpa`` computes under its
  ``_causal_window_mask`` (``ref.causal_window_mask`` here).
* ``attn_decode`` -- one-token decode against the cache, with a per-row
  position vector ``[B]``: the reference's ``vmap`` of single-slot decode
  written out as a batch dimension (per-row RoPE position, cache slot and
  valid mask; an M-RoPE config broadcasts the position to its three
  streams).  Decode attention stays plain torch, as the reference leaves
  it outside Pallas.

:data:`k1_launches` splits the kernel's launch count (``flash_ops.launches``,
read around each training call) by the attention that made them: causal
self-attention (``"decoder"``), bidirectional self-attention
(``"encoder"``) and cross attention (``"cross"``).

The cache is updated in place (the reference returns a new one); both
functions also return it, so callers read like the reference.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.flash_attention.ref import CHUNKED_ATTN_THRESHOLD, chunked_attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, dense, dense_init, rope_frequencies

__all__ = [
    "attn_init",
    "cross_attn_init",
    "attn_train",
    "cross_attn",
    "cross_attn_decode",
    "k1_launches",
    "chunked_attention",
    "CHUNKED_ATTN_THRESHOLD",
    "attn_prefill",
    "attn_decode",
    "init_kv_cache",
    "sdpa",
]


def attn_init(gen: torch.Generator, cfg: ModelConfig):
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, cfg, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, cfg, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, cfg, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, cfg),
    }


def cross_attn_init(gen: torch.Generator, cfg: ModelConfig):
    return attn_init(gen, cfg.replace(qkv_bias=False))


#: K1 launches by the attention that made them, summed since the counts
#: were last set to 0
k1_launches = {"decoder": 0, "encoder": 0, "cross": 0}


def _train_attention(kind: str, q, k, v, causal: bool, window, plain_attention: bool):
    """The training attention of ``kind`` (a key of :data:`k1_launches`):
    the kernel's training entry, or with ``plain_attention`` its plain
    version."""
    if plain_attention:
        return flash_ref.train_attention(q, k, v, causal=causal, window=window)
    n0 = flash_ops.launches
    out = flash_ops.flash_attention_train(q, k, v, causal=causal, window=window)
    k1_launches[kind] += flash_ops.launches - n0
    return out


def _split_heads(x, n_heads: int, hd: int):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _merge_heads(x):
    return x.reshape(*x.shape[:-2], -1)


def sdpa(q, k, v, mask=None):
    """Grouped-query scaled-dot-product attention (the decode path).

    q: [B,T,H,hd]; k, v: [B,S,K,hd] with H = K*r; mask broadcastable over
    [B,K,r,T,S], or None for none.  Scores in fp32 (the reference's ``preferred_element_type``),
    masked with -1e30; the probabilities are cast to v's type before the
    second product.
    """
    B, T, H, hd = q.shape
    K = k.shape[2]
    r = H // K
    qg = q.reshape(B, T, K, r, hd).float()
    logits = torch.einsum("btkrh,bskh->bkrts", qg, k.float()) * (1.0 / math.sqrt(hd))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrts,bskh->btkrh", probs.to(v.dtype), v)
    return out.reshape(B, T, H, hd)


def _project_qkv(p, x, cfg: ModelConfig, positions, mrope_positions=None):
    q = _split_heads(dense(p["wq"], x, cfg), cfg.num_heads, cfg.hd)
    k = _split_heads(dense(p["wk"], x, cfg), cfg.num_kv_heads, cfg.hd)
    v = _split_heads(dense(p["wv"], x, cfg), cfg.num_kv_heads, cfg.hd)
    if cfg.mrope and mrope_positions is not None:
        return apply_mrope(cfg, q, mrope_positions), apply_mrope(cfg, k, mrope_positions), v
    cos, sin = rope_frequencies(cfg, positions)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def attn_train(
    p, x, cfg: ModelConfig, *, window: int | None = None, causal: bool = True,
    positions=None, mrope_positions=None, plain_attention: bool = False,
):
    """Full-sequence attention.  x: [B, T, d] -> [B, T, d].

    Positions default to ``0..T-1``; ``mrope_positions`` [3, B, T] take
    their place for an M-RoPE config.  GQA stays grouped (no repeated
    K/V).  ``plain_attention`` computes the attention with the plain
    training version (:func:`flash_ref.train_attention`) on any device; it
    exists for the on-card comparison and the training path never sets it."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions)
    kind = "decoder" if causal else "encoder"
    out = _train_attention(kind, q, k, v, causal, window, plain_attention)
    return dense(p["wo"], _merge_heads(out), cfg)


# -- KV cache -------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int | None = None, device=None):
    """Cache for one attention layer.  Windowed layers allocate only the window."""
    L = min(max_len, window) if window else max_len
    shape = (batch, L, cfg.num_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def attn_prefill(p, x, cache, cfg: ModelConfig, *, window: int | None = None, plain_attention: bool = False):
    """Full-sequence prefill that fills the decode KV cache in one pass.

    x: [B, T, d].  Returns (out [B, T, d], cache) with the cache in exactly
    the state T successive :func:`attn_decode` calls at positions ``0..T-1``
    would leave it: slots ``i % L`` hold the last ``min(T, L)`` tokens'
    projections.  ``plain_attention`` computes the attention with the
    kernel's plain version (:func:`ref.attention`) on any device; it exists
    for the on-card comparison and the serving path never sets it.
    """
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if plain_attention:
        out = flash_ref.attention(q, k, v, causal=True, window=window)
    else:
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    L = cache["k"].shape[1]
    if T <= L:
        cache["k"][:, :T] = k
        cache["v"][:, :T] = v
    else:
        # ring buffer: only the last L tokens survive T sequential writes
        idx = torch.arange(T - L, T, device=x.device) % L
        cache["k"][:, idx] = k[:, T - L :].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, T - L :].to(cache["v"].dtype)
    return dense(p["wo"], _merge_heads(out), cfg), cache


def attn_decode(p, x, cache, index, cfg: ModelConfig, *, window: int | None = None):
    """One-token decode.  x: [B, 1, d]; ``index``: [B] positions of the new
    tokens (one per row) or one int for every row.  Returns (out, cache).
    Windowed layers use a ring buffer."""
    B = x.shape[0]
    index = torch.as_tensor(index, dtype=torch.long, device=x.device).expand(B)
    positions = index[:, None]
    mrope_positions = positions.expand(3, B, 1) if cfg.mrope else None
    q, k, v = _project_qkv(p, x, cfg, positions, mrope_positions)
    L = cache["k"].shape[1]
    slot = index % L  # ring buffer when windowed; the position otherwise
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    # valid slots: for a ring buffer every slot < min(index+1, L) is valid
    valid = torch.arange(L, device=x.device)[None, :] < torch.clamp(index + 1, max=L)[:, None]
    out = sdpa(q, cache["k"], cache["v"], valid[:, None, None, None, :])
    return dense(p["wo"], _merge_heads(out), cfg), cache


# -- cross attention (enc-dec) ---------------------------------------------------


def _cross_qkv(p, x, memory, cfg: ModelConfig):
    q = _split_heads(dense(p["wq"], x, cfg), cfg.num_heads, cfg.hd)
    k = _split_heads(dense(p["wk"], memory, cfg), cfg.num_kv_heads, cfg.hd)
    v = _split_heads(dense(p["wv"], memory, cfg), cfg.num_kv_heads, cfg.hd)
    return q, k, v


def cross_attn(p, x, memory, cfg: ModelConfig, *, plain_attention: bool = False):
    """Decoder queries x [B, T, d] attend to the encoder memory [B, S, d]
    (no positions on k/v, no mask): the kernel at ``causal=False``."""
    q, k, v = _cross_qkv(p, x, memory, cfg)
    out = _train_attention("cross", q, k, v, False, None, plain_attention)
    return dense(p["wo"], _merge_heads(out), cfg)


def cross_attn_decode(p, x, memory, cfg: ModelConfig):
    """:func:`cross_attn` of one decode token x [B, 1, d], in plain torch."""
    q, k, v = _cross_qkv(p, x, memory, cfg)
    return dense(p["wo"], _merge_heads(sdpa(q, k, v)), cfg)
