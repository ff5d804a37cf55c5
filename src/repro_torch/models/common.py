"""Model configuration and per-layer structure description.

Port of ``repro/models/common.py`` for the dense and SSM (Mamba2)
decoder-only families, with ``torch`` dtypes in place of ``jnp`` ones.
:class:`ModelConfig` holds only the fields the port reads; the MoE,
hybrid, encoder-decoder and multimodal fields of the reference arrive with
the slices that read them.  :func:`check_ported` says which family is
ported on which path: the dense and SSM families serve and train.
``layer_specs`` expands a config into a per-layer recipe (layer kind and
sliding window) that :mod:`repro_torch.models.transformer` consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig", "LayerSpec", "layer_specs", "param_count", "check_ported"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" or "ssm" (see check_ported)
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

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0  # N
    ssm_heads: int = 0  # H (0 -> d_model * ssm_expand // ssm_head_dim)
    ssm_head_dim: int = 64  # P
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    ssm_expand: int = 2

    # numerics
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    max_seq_len: int = 131_072

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

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


#: the families each path of the port runs
_PORTED = {"serve": ("dense", "ssm"), "train": ("dense", "ssm")}
#: what is missing for a family on a path, and the later slice that brings it
#: (ROADMAP.md, queue 1)
_LATER = {
    ("moe", None): "the MoE layer (models/moe.py) comes with the MoE slice",
    ("hybrid", None): "the Mamba2/attention hybrid family comes with the hybrid slice",
    ("encdec", None): "the encoder-decoder family comes with a later slice",
    ("audio", None): "the encoder-decoder family comes with a later slice",
    ("vlm", None): "the vision-language family comes with a later slice",
}


def check_ported(cfg: ModelConfig, *paths: str) -> None:
    """Raise ``NotImplementedError`` unless ``cfg``'s family is ported on one
    of ``paths`` (``"serve"``, ``"train"``)."""
    if any(cfg.family in _PORTED[p] for p in paths):
        return
    what = next(
        (_LATER[(cfg.family, p)] for p in paths if (cfg.family, p) in _LATER),
        _LATER.get((cfg.family, None), f"family {cfg.family!r} comes with a later slice"),
    )
    raise NotImplementedError(
        f"not ported yet on the {'/'.join(paths)} path: {what} (ROADMAP.md, queue 1)"
    )


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    kind: str  # "attn" | "mamba"
    window: int | None  # sliding window size, None = full/global


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        kind = "mamba" if cfg.family == "ssm" else "attn"
        if kind != "attn":
            window = None
        elif cfg.window_pattern:
            window = cfg.window_pattern[i % len(cfg.window_pattern)]
        else:
            window = cfg.attn_window
        specs.append(LayerSpec(index=i, kind=kind, window=window))
    return specs


def _layer_params(cfg: ModelConfig, kind: str) -> int:
    """Parameters of one layer, counted as the reference counts them: the
    attention layer's norms as 2·d and the FFN's as d (3·d in all for a
    dense layer, whatever the norm's kind), the Mamba2 layer's ``ln1`` as d
    plus d for the absent FFN's norm."""
    d = cfg.d_model
    if kind == "attn":
        layer = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d + 2 * d
        if cfg.qkv_bias:
            layer += cfg.q_dim + 2 * cfg.kv_dim
    else:  # mamba2, one B/C group (models/mamba.py)
        d_in, H, N = d * cfg.ssm_expand, cfg.n_ssm_heads, cfg.ssm_state
        layer = (
            d * (2 * d_in + 2 * N + H)  # in_proj -> z, x, B, C, dt
            + cfg.ssm_conv_width * (d_in + 2 * N)  # depthwise conv over x, B, C
            + 3 * H  # dt_bias, A_log, D
            + d_in  # gate norm
            + d_in * d  # out_proj
            + d
        )
    mult = 3 if cfg.mlp_act == "swiglu" else 2
    return layer + mult * d * cfg.d_ff + d


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the decoder, held to the reference's ``param_count``."""
    check_ported(cfg, "serve", "train")
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    layers = sum(_layer_params(cfg, spec.kind) for spec in layer_specs(cfg))
    return embed + layers + cfg.d_model
