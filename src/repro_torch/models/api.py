"""Model API of the ported slices, after ``repro/models/api.py``.

* ``init_params(cfg, seed, device)``   -- weights from a seeded ``torch.Generator``
* ``init_serving_params(cfg, seed, device)`` -- the same weights, cast for
  serving a layer at a time (``cast_for_serving(init_params(...))``, bitwise)
* ``loss_fn(params, cfg, batch)``      -> (loss, metrics), the training loss
* ``cast_for_serving(params, cfg)``    -- matrices and the embedding table to ``cfg.dtype``
* ``init_cache(cfg, batch, max_len, device)``
* ``prefill_with_cache(params, cfg, cache, batch)`` -> (logits [B,1,V], cache)
* ``decode_fn(params, cfg, cache, index, batch)``   -> (logits [B,1,V], cache)

Batches are dictionaries with ``tokens`` ([B,T] for prefill, [B,1] for
decode) and, for the loss, ``labels`` [B,T], as in the reference.  The dense,
MoE, SSM and hybrid families serve and train; every other family and path
raises ``NotImplementedError`` here.  Caches are updated in place.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, check_ported

__all__ = [
    "init_params",
    "init_serving_params",
    "loss_fn",
    "cast_for_serving",
    "init_cache",
    "prefill_with_cache",
    "decode_fn",
]

#: parameter leaves that are matrices (cast to cfg.dtype once for serving),
#: the MoE expert banks (``experts/{gate,up,down}``, which the MoE layer casts
#: to cfg.dtype at use), and the Mamba2 conv bias, which mamba_decode casts to
#: cfg.dtype at use; norm scales and biases stay in param_dtype, since
#: layernorm upcasts them to fp32 and a bf16 round trip would change its
#: results
_MATRIX_LEAVES = ("w", "table", "head", "in_proj", "out_proj", "conv_w", "conv_b", "gate", "up", "down")
#: (parent, leaf) pairs that stay in param_dtype: the MoE router reads its
#: weight in fp32, and a bf16 copy would change the routing
_KEPT = (("router", "w"),)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Parameters in ``cfg.param_dtype`` drawn on ``device`` (default cuda)."""
    check_ported(cfg, "serve", "train")
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return tf.init_decoder(gen, cfg)


def init_serving_params(cfg: ModelConfig, seed: int = 0, device=None):
    """``cast_for_serving(init_params(cfg, seed, device), cfg)``, bitwise,
    without the whole fp32 tree: the embedding, each layer and each MoE
    expert bank are cast as soon as they are drawn, from the same generator
    stream, so the peak is the serving tree plus one part (at most one
    expert bank) in ``param_dtype``."""
    check_ported(cfg, "serve")
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return tf.init_decoder(gen, cfg, finish=lambda part: cast_for_serving(part, cfg))


def loss_fn(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    """Mean next-token loss of a text batch (``tokens``, ``labels`` [B,T])."""
    check_ported(cfg, "train")
    return tf.decoder_loss(params, cfg, batch["tokens"], labels=batch["labels"])


def cast_for_serving(params, cfg: ModelConfig):
    """The same tree with matrices, expert banks and the embedding table in
    ``cfg.dtype``; the MoE router's weight stays in ``param_dtype``.

    The reference casts ``param_dtype -> dtype`` at every use; one cast at
    load gives the same numbers with half the weight memory."""

    def walk(node, name=None, parent=None):
        if isinstance(node, dict):
            return {k: walk(v, k, name) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if name in _MATRIX_LEAVES and (parent, name) not in _KEPT:
            return node.to(cfg.dtype)
        return node

    return walk(params)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, device=None):
    check_ported(cfg, "serve")
    return tf.init_decode_cache(cfg, batch_size, max_len, resolve_device(device))


def prefill_with_cache(
    params, cfg: ModelConfig, cache, batch: Mapping[str, torch.Tensor],
    *, plain_attention: bool = False,
):
    """Fused prefill that also fills the decode cache in one pass."""
    check_ported(cfg, "serve")
    return tf.prefill_with_cache(
        params, cfg, cache, batch["tokens"], plain_attention=plain_attention
    )


def decode_fn(
    params, cfg: ModelConfig, cache, index, batch: Mapping[str, torch.Tensor], *, per_row_moe: bool = False,
):
    """One decode step; ``index`` is one position or a [B] vector of them.
    MoE layers route the batch as one group (the reference's
    ``decode_fn``), or with ``per_row_moe`` each row as its own group (the
    reference engine's per-slot decode)."""
    check_ported(cfg, "serve")
    return tf.decode_step(params, cfg, cache, index, batch["tokens"], per_row_moe=per_row_moe)
