"""Input stand-ins for every (architecture x input shape) pair.

Port of ``repro/configs/io.py``.  ``input_specs()`` returns tensors on
the ``meta`` device -- the shapes and dtypes of a batch, with no storage --
where the reference returns ``ShapeDtypeStruct``s; ``make_batch()``
materialises small real tensors of the same structure from the reference's
numpy generator, with the same draws in the same order, so one seed gives
the same arrays in both packages.

Modality frontends are the sanctioned stubs: audio frame embeddings arrive
pre-computed at an ``AUDIO_SUBSAMPLE``-times subsampled rate (an
encoder-decoder's ``src_embeds``, and the encoder ``memory`` of a decode
batch); vision patch embeddings arrive interleaved with text at the full
sequence length (a VLM's ``embeds``, with three equal M-RoPE position
streams).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import INPUT_SHAPES, ArchSpec, InputShape
from repro_torch.models.common import ModelConfig

__all__ = ["serving_config", "input_specs", "make_batch", "AUDIO_SUBSAMPLE"]

AUDIO_SUBSAMPLE = 8  # conv frontend frame rate vs target tokens


def serving_config(spec: ArchSpec, shape: InputShape) -> ModelConfig:
    """The ModelConfig actually run for this shape.

    For ``long_500k`` with the "windowed" policy, dense full-attention archs
    get an explicit sliding-window serving variant (a beyond-paper config):
    otherwise a 524k KV cache per layer is quadratic in attention cost.
    Serving shapes raise ``max_seq_len`` to the shape's length.
    """
    cfg = spec.model
    if shape.name == "long_500k" and spec.long_context == "windowed":
        cfg = cfg.replace(attn_window=spec.long_window)
    if shape.kind != "train":
        cfg = cfg.replace(max_seq_len=max(cfg.max_seq_len, shape.seq_len))
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frames(T: int) -> int:
    return max(T // AUDIO_SUBSAMPLE, 1)


def _train_specs(cfg: ModelConfig, B: int, T: int) -> dict[str, torch.Tensor]:
    i32, f32 = torch.int32, torch.float32
    if cfg.family == "encdec":
        return {
            "src_embeds": _meta((B, _frames(T), cfg.d_model), f32),
            "tgt_tokens": _meta((B, T), i32),
            "labels": _meta((B, T), i32),
        }
    if cfg.family == "vlm":
        return {
            "embeds": _meta((B, T, cfg.d_model), f32),
            "labels": _meta((B, T), i32),
            "mrope_positions": _meta((3, B, T), i32),
        }
    return {"tokens": _meta((B, T), i32), "labels": _meta((B, T), i32)}


def _decode_specs(cfg: ModelConfig, B: int, T: int) -> dict[str, torch.Tensor]:
    out = {"tokens": _meta((B, 1), torch.int32)}
    if cfg.family == "encdec":
        out["memory"] = _meta((B, _frames(T), cfg.d_model), torch.float32)
    return out


def input_specs(spec: ArchSpec, shape: InputShape | str, reduced: bool = False) -> dict[str, torch.Tensor]:
    """A batch's tensors on the ``meta`` device for one (arch, shape) pair.

    ``reduced=True`` shrinks to smoke-test scale (the smoke ModelConfig with
    seq/batch cut down) while keeping the same structure.
    """
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    cfg = spec.smoke if reduced else serving_config(spec, shape)
    B = 2 if reduced else shape.global_batch
    T = 32 if reduced else shape.seq_len
    if shape.kind == "decode":
        return _decode_specs(cfg, B, T)
    return _train_specs(cfg, B, T)


def _normal(rng, shape, scale: float = 1.0) -> torch.Tensor:
    """The reference's float32 array of ``rng``'s float64 draws times ``scale``."""
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def make_batch(cfg: ModelConfig, B: int, T: int, kind: str = "train", seed: int = 0):
    """Small real CPU tensors matching :func:`input_specs`' structure (int64
    tokens, as the port's embedding indexes with them)."""
    rng = np.random.default_rng(seed)
    if kind == "decode":
        out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))}
        if cfg.family == "encdec":
            out["memory"] = _normal(rng, (B, _frames(T), cfg.d_model))
        return out
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    labels = toks[:, 1:].contiguous()
    if cfg.family == "encdec":
        return {
            "src_embeds": _normal(rng, (B, _frames(T), cfg.d_model), 0.02),
            "tgt_tokens": toks[:, :-1].contiguous(),
            "labels": labels,
        }
    if cfg.family == "vlm":
        return {
            "embeds": _normal(rng, (B, T, cfg.d_model), 0.02),
            "labels": labels,
            "mrope_positions": torch.arange(T, dtype=torch.int32).expand(3, B, T).contiguous(),
        }
    return {"tokens": toks[:, :-1].contiguous(), "labels": labels}
