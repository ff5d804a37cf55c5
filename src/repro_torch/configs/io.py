"""Input stand-ins for every (architecture x input shape) pair.

Port of ``repro/configs/io.py`` for the ported families (dense and SSM).
``input_specs()`` returns tensors on the ``meta`` device -- the shapes and
dtypes of a batch, with no storage -- where the reference returns
``ShapeDtypeStruct``s; ``make_batch()`` materialises small real tensors of
the same structure from the reference's numpy generator, so one seed gives
the same tokens and labels in both packages.

The encoder-decoder (audio frames at an ``AUDIO_SUBSAMPLE``-times
subsampled rate) and vision-language inputs come with their families
(ROADMAP.md queue 1, item 9); their branches raise here.
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


def _later(cfg: ModelConfig) -> None:
    if cfg.family in ("encdec", "vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} inputs come with their family (ROADMAP.md queue 1, item 9)"
        )


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(spec: ArchSpec, shape: InputShape | str, reduced: bool = False) -> dict[str, torch.Tensor]:
    """A batch's tensors on the ``meta`` device for one (arch, shape) pair.

    ``reduced=True`` shrinks to smoke-test scale (the smoke ModelConfig with
    seq/batch cut down) while keeping the same structure.
    """
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    cfg = spec.smoke if reduced else serving_config(spec, shape)
    _later(cfg)
    B = 2 if reduced else shape.global_batch
    T = 32 if reduced else shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((B, 1), torch.int32)}
    return {"tokens": _meta((B, T), torch.int32), "labels": _meta((B, T), torch.int32)}


def make_batch(cfg: ModelConfig, B: int, T: int, kind: str = "train", seed: int = 0):
    """Small real CPU tensors matching :func:`input_specs`' structure (int64
    tokens, as the port's embedding indexes with them)."""
    _later(cfg)
    rng = np.random.default_rng(seed)
    if kind == "decode":
        return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1)))
    return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
