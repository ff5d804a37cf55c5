"""Model API over every architecture family, after ``repro/models/api.py``.

* ``init_params(cfg, seed, device)``   -- weights from a seeded ``torch.Generator``
* ``init_serving_params(cfg, seed, device)`` -- the same weights, cast for
  serving a layer at a time (``cast_for_serving(init_params(...))``, bitwise)
* ``loss_fn(params, cfg, batch)``      -> (loss, metrics), the training loss
* ``forward_fn(params, cfg, batch)``   -> (logits [B,T,V], aux)
* ``prefill_fn(params, cfg, batch)``   -> logits [B,1,V] of the last position
* ``cast_for_serving(params, cfg)``    -- matrices and the embedding table to ``cfg.dtype``
* ``init_cache(cfg, batch, max_len, device)``
* ``prefill_with_cache(params, cfg, cache, batch)`` -> (logits [B,1,V], cache)
* ``decode_fn(params, cfg, cache, index, batch)``   -> (logits [B,1,V], cache)

Batch keys by family, as in the reference:

* text (dense, moe, ssm, hybrid, audio): ``tokens`` [B,T], ``labels`` [B,T]
* vlm: ``embeds`` [B,T,d], ``labels`` [B,T], ``mrope_positions`` [3,B,T]
* encdec: ``src_embeds`` [B,S,d], ``tgt_tokens`` [B,T], ``labels`` [B,T]

Decode batches carry ``tokens`` [B,1] (every family) and, for encdec,
``memory`` [B,S,d], the encoder's output.  ``prefill_with_cache`` refuses
the encdec and vlm families, as the reference's does.  Caches are updated
in place.
"""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, check_servable

__all__ = [
    "init_params",
    "init_serving_params",
    "loss_fn",
    "forward_fn",
    "prefill_fn",
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


def _init(cfg: ModelConfig, gen: torch.Generator, finish=None):
    if cfg.family == "encdec":
        return tf.init_encdec(gen, cfg, finish)
    return tf.init_decoder(gen, cfg, finish)


def init_params(cfg: ModelConfig, seed: int = 0, device=None):
    """Parameters in ``cfg.param_dtype`` drawn on ``device`` (default cuda)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return _init(cfg, gen)


def init_serving_params(cfg: ModelConfig, seed: int = 0, device=None):
    """``cast_for_serving(init_params(cfg, seed, device), cfg)``, bitwise,
    without the whole fp32 tree: the embedding, each layer and each MoE
    expert bank are cast as soon as they are drawn, from the same generator
    stream, so the peak is the serving tree plus one part (at most one
    expert bank) in ``param_dtype``."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return _init(cfg, gen, finish=lambda part: cast_for_serving(part, cfg))


def loss_fn(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], **hooks):
    """Mean next-token loss of a batch (its keys by family, above);
    ``hooks`` are the distributed step's ``use`` and ``row_sum``
    (:mod:`repro_torch.models.transformer`)."""
    if cfg.family == "encdec":
        return tf.encdec_loss(params, cfg, batch["src_embeds"], batch["tgt_tokens"], batch["labels"], **hooks)
    if cfg.family == "vlm":
        return tf.decoder_loss(
            params, cfg, labels=batch["labels"], embeds=batch["embeds"],
            mrope_positions=batch.get("mrope_positions"), **hooks,
        )
    return tf.decoder_loss(params, cfg, batch["tokens"], labels=batch["labels"], **hooks)


def forward_fn(
    params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor], *, last_only: bool = False,
    plain_attention: bool = False,
):
    """(logits, aux) of the full-sequence forward; ``last_only`` unembeds
    the last position alone.  ``plain_attention`` runs every full-sequence
    attention through the kernel's plain version (the on-card comparison)."""
    if cfg.family == "encdec":
        return tf.encdec_forward(
            params, cfg, batch["src_embeds"], batch["tgt_tokens"], last_only=last_only,
            plain_attention=plain_attention,
        )
    if cfg.family == "vlm":
        return tf.decoder_forward(
            params, cfg, embeds=batch["embeds"], mrope_positions=batch.get("mrope_positions"),
            last_only=last_only, plain_attention=plain_attention,
        )
    return tf.decoder_forward(params, cfg, batch["tokens"], last_only=last_only, plain_attention=plain_attention)


def prefill_fn(params, cfg: ModelConfig, batch: Mapping[str, torch.Tensor]):
    """Inference prefill: the full-sequence forward, the last position's
    logits [B, 1, V] only (no [B, T, V] tensor)."""
    return forward_fn(params, cfg, batch, last_only=True)[0]


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
    if cfg.family == "encdec":
        return tf.init_encdec_cache(cfg, batch_size, max_len, resolve_device(device))
    return tf.init_decode_cache(cfg, batch_size, max_len, resolve_device(device))


def prefill_with_cache(
    params, cfg: ModelConfig, cache, batch: Mapping[str, torch.Tensor],
    *, plain_attention: bool = False,
):
    """Fused prefill that also fills the decode cache in one pass (text
    families only: encdec threads encoder memory explicitly and vlm M-RoPE
    positions, and neither is a serving path in the reference)."""
    check_servable(cfg, "prefill_with_cache")
    return tf.prefill_with_cache(
        params, cfg, cache, batch["tokens"], plain_attention=plain_attention
    )


def decode_fn(
    params, cfg: ModelConfig, cache, index, batch: Mapping[str, torch.Tensor], *, per_row_moe: bool = False,
):
    """One decode step; ``index`` is one position or a [B] vector of them.
    MoE layers route the batch as one group (the reference's
    ``decode_fn``), or with ``per_row_moe`` each row as its own group (the
    reference engine's per-slot decode).  An encoder-decoder decodes against
    ``batch["memory"]``."""
    if cfg.family == "encdec":
        return tf.encdec_decode_step(params, cfg, cache, index, batch["tokens"], batch["memory"])
    return tf.decode_step(params, cfg, cache, index, batch["tokens"], per_row_moe=per_row_moe)
