"""Model configuration and per-layer structure description.

Port of ``repro/models/common.py`` for the dense decoder-only family, with
``torch`` dtypes in place of ``jnp`` ones.  :class:`ModelConfig` holds only
the fields the port reads; the MoE, SSM, encoder-decoder and multimodal
fields of the reference arrive with the slices that read them, and
:func:`check_ported` refuses those families until then.  ``layer_specs``
expands a config into a per-layer recipe (the sliding window of each layer)
that :mod:`repro_torch.models.transformer` consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig", "LayerSpec", "layer_specs", "param_count", "check_ported"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" is ported (see check_ported)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    qkv_bias: bool = False
    mlp_act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # attention
    rope_theta: float = 10_000.0
    attn_window: int | None = None  # sliding window size (None = full attention)
    # pattern of window sizes cycled over layers; overrides attn_window.
    # e.g. gemma3: (1024, 1024, 1024, 1024, 1024, None) = 5 local : 1 global
    window_pattern: tuple[int | None, ...] = ()

    # numerics
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32

    # ---------------------------------------------------------------

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: the later slice that brings each family of the reference (ROADMAP.md, queue 1)
_UNPORTED = {
    "moe": "the MoE layer (models/moe.py)",
    "ssm": "the Mamba2 layer (models/mamba.py, kernel K2)",
    "hybrid": "the Mamba2 layer (models/mamba.py, kernel K2)",
    "encdec": "the encoder-decoder family",
    "audio": "the encoder-decoder family",
    "vlm": "the vision-language family",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is of the dense family."""
    if cfg.family != "dense":
        what = _UNPORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"{what} is not ported yet: it comes with a later slice (ROADMAP.md, queue 1, "
            "'other families')"
        )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    window: int | None  # sliding window size, None = full/global


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        if cfg.window_pattern:
            window = cfg.window_pattern[i % len(cfg.window_pattern)]
        else:
            window = cfg.attn_window
        specs.append(LayerSpec(index=i, window=window))
    return specs


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the dense decoder, counted as the reference counts them:
    3·d per layer and d for the final norm, whatever the norm's kind."""
    check_ported(cfg)
    d = cfg.d_model
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.qkv_bias:
        attn += cfg.q_dim + 2 * cfg.kv_dim
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    layer = attn + mult * d * cfg.d_ff + 3 * d
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return embed + cfg.num_layers * layer + d
