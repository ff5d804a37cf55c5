"""Model API of the ported slices, after ``repro/models/api.py``.

* ``init_params(cfg, seed, device)``   -- weights from a seeded ``torch.Generator``
* ``loss_fn(params, cfg, batch)``      -> (loss, metrics), the training loss
* ``cast_for_serving(params, cfg)``    -- matrices and the embedding table to ``cfg.dtype``
* ``init_cache(cfg, batch, max_len, device)``
* ``prefill_with_cache(params, cfg, cache, batch)`` -> (logits [B,1,V], cache)
* ``decode_fn(params, cfg, cache, index, batch)``   -> (logits [B,1,V], cache)

Batches are dictionaries with ``tokens`` ([B,T] for prefill, [B,1] for
decode) and, for the loss, ``labels`` [B,T], as in the reference.  The dense
and SSM families serve and train; every other family and path raises
``NotImplementedError`` here.  Caches are updated in place.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, check_ported

__all__ = [
    "init_params",
    "loss_fn",
    "cast_for_serving",
    "init_cache",
    "prefill_with_cache",
    "decode_fn",
]

#: parameter leaves that are matrices (cast to cfg.dtype once for serving),
#: and the Mamba2 conv bias, which mamba_decode casts to cfg.dtype at use;
#: norm scales and biases stay in param_dtype, since layernorm upcasts them
#: to fp32 and a bf16 round trip would change its results
_MATRIX_LEAVES = ("w", "table", "head", "in_proj", "out_proj", "conv_w", "conv_b")


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Parameters in ``cfg.param_dtype`` drawn on ``device`` (default cuda)."""
    check_ported(cfg, "serve", "train")
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return tf.init_decoder(gen, cfg)


def loss_fn(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    """Mean next-token loss of a text batch (``tokens``, ``labels`` [B,T])."""
    check_ported(cfg, "train")
    return tf.decoder_loss(params, cfg, batch["tokens"], labels=batch["labels"])


def cast_for_serving(params, cfg: ModelConfig):
    """The same tree with matrices and the embedding table in ``cfg.dtype``.

    The reference casts ``param_dtype -> dtype`` at every use; one cast at
    load gives the same numbers with half the weight memory."""

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(cfg.dtype) if name in _MATRIX_LEAVES else node

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


def decode_fn(params, cfg: ModelConfig, cache, index, batch: Mapping[str, torch.Tensor]):
    """One decode step; ``index`` is one position or a [B] vector of them."""
    check_ported(cfg, "serve")
    return tf.decode_step(params, cfg, cache, index, batch["tokens"])
