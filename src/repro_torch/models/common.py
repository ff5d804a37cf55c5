"""Model configuration and per-layer structure description.

Port of ``repro/models/common.py``, with ``torch`` dtypes in place of
``jnp`` ones.  :class:`ModelConfig` holds every field of the reference's,
the block remat and the sharding anchor of the distributed step
(:mod:`repro_torch.distributed.spmd`) among them.  Every family trains; the
encoder-decoder and vision-language families do not serve, as in the
reference, whose serve engine and ``prefill_with_cache`` refuse them
(:func:`check_servable`).  ``audio`` is a decoder over tokens, as the
reference's model API treats any family it does not branch on.
``layer_specs`` expands a config into a per-layer recipe (attention vs
Mamba2, MoE vs dense FFN, sliding window) that
:mod:`repro_torch.models.transformer` consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ModelConfig", "LayerSpec", "layer_specs", "param_count", "active_param_count", "check_servable", "encoder_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
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
    mrope: bool = False  # Qwen2-VL multimodal rotary (3 position streams)
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # per-head-dim halves

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden size (0 -> d_ff)
    moe_every: int = 1  # a layer is MoE iff (layer_idx % moe_every == moe_offset)
    moe_offset: int = 0
    first_k_dense: int = 0  # kimi-k2: leading dense layers before the MoE stack
    n_shared_experts: int = 0  # kimi-style always-on shared expert(s)
    router_scoring: str = "softmax"  # softmax | sigmoid (kimi)
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0  # N
    ssm_heads: int = 0  # H (0 -> d_model * ssm_expand // ssm_head_dim)
    ssm_head_dim: int = 64  # P
    ssm_conv_width: int = 4
    ssm_chunk: int = 64
    ssm_expand: int = 2
    # hybrid interleave: a layer is attention iff (idx % attn_every == attn_offset)
    attn_every: int = 1  # 1 -> all attention; jamba: 8 with attn_offset 4
    attn_offset: int = 0

    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: embeddings arrive pre-computed
    frontend: str | None = None  # None | "audio" | "vision"

    # numerics
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    max_seq_len: int = 131_072

    # recompute each layer during the backward (torch.utils.checkpoint),
    # the counterpart of the reference's jax.checkpoint of each scanned block:
    # the live activations are one layer's plus the layer-boundary hiddens
    remat_blocks: bool = False

    # distribution: the reference's PartitionSpec-style anchor of the hidden
    # stream [B, T, d], e.g. (("pod", "data"), None, None); None on one
    # device.  Where it is set the MoE layers route each batch row as its own
    # group in training too (the reference's moe_apply_grouped).  The port
    # pins no sharding with it: each rank of the distributed step computes
    # on its own rows (repro's constrain_hidden has no work to do here).
    act_sharding: tuple | None = None

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
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_servable(cfg: ModelConfig, what: str = "serving") -> None:
    """Raise ``NotImplementedError`` for the families the reference does not
    serve: the encoder-decoder (it threads encoder memory explicitly) and
    the vision-language one (M-RoPE positions)."""
    if cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(f"{what} does not support family {cfg.family!r}")


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    index: int
    kind: str  # "attn" | "mamba"
    moe: bool
    window: int | None  # sliding window size, None = full/global


def layer_specs(cfg: ModelConfig, num_layers: int | None = None) -> list[LayerSpec]:
    n = num_layers if num_layers is not None else cfg.num_layers
    specs = []
    for i in range(n):
        if cfg.family == "ssm":
            kind = "mamba"
        elif cfg.family == "hybrid":
            kind = "attn" if (i % cfg.attn_every) == cfg.attn_offset else "mamba"
        else:
            kind = "attn"
        moe = bool(cfg.num_experts) and (i % cfg.moe_every) == cfg.moe_offset and i >= cfg.first_k_dense
        if kind != "attn":
            window = None
        elif cfg.window_pattern:
            window = cfg.window_pattern[i % len(cfg.window_pattern)]
        else:
            window = cfg.attn_window
        specs.append(LayerSpec(index=i, kind=kind, moe=moe, window=window))
    return specs


def _layer_params(cfg: ModelConfig, spec: LayerSpec) -> tuple[int, int]:
    """(total, active) parameters of one layer, counted as the reference
    counts them: the attention layer's norms as 2·d and the FFN's as d (3·d
    in all for a dense layer, whatever the norm's kind), the Mamba2 layer's
    ``ln1`` as d plus d for the FFN's norm; an MoE FFN as its experts, the
    router and the shared experts (active: ``num_experts_per_tok`` experts)."""
    d = cfg.d_model
    if spec.kind == "attn":
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
    if not spec.moe:
        mult = 3 if cfg.mlp_act == "swiglu" else 2
        ffn = mult * d * cfg.d_ff + d
        return layer + ffn, layer + ffn
    per_expert = 3 * d * cfg.expert_ff  # SwiGLU: gate, up, down
    common = d * cfg.num_experts + cfg.n_shared_experts * per_expert + d  # router, shared, norm
    return (
        layer + cfg.num_experts * per_expert + common,
        layer + cfg.num_experts_per_tok * per_expert + common,
    )


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder-decoder's encoder layers are built and run
    with: dense attention layers, no windows, no experts."""
    return cfg.replace(num_experts=0, window_pattern=(), attn_every=1, family="dense")


def _count(cfg: ModelConfig, which: int) -> int:
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    layers = sum(_layer_params(cfg, spec)[which] for spec in layer_specs(cfg))
    if cfg.encoder_layers:
        enc = encoder_config(cfg)
        layers += sum(_layer_params(enc, spec)[which] for spec in layer_specs(enc, cfg.encoder_layers))
        # each decoder layer's cross attention and its norm, counted as the
        # reference counts them (the encoder's final norm is not counted)
        d = cfg.d_model
        layers += cfg.num_layers * (2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + d)
    return embed + layers + cfg.d_model


def param_count(cfg: ModelConfig) -> int:
    """Parameters of the model (an encoder-decoder's encoder and cross
    attention included), held to the reference's ``param_count``."""
    return _count(cfg, 0)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: only the routed experts), held to
    the reference's ``active_param_count``."""
    return _count(cfg, 1)
