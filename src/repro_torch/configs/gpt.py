"""The paper's own GPT test configurations (Table 1) and U-Net proxies
(Table 2).

Port of ``repro/configs/gpt.py``.  GPT configs are real ModelConfigs; the
U-Net rows are StageCosts profiles whose cross-stage bytes are several
times larger relative to compute than GPT's.  :func:`gpt_stage_costs`
takes the chip's FLOP rate from its caller (``repro``'s defaults to a
fraction of one TPU's peak): pass a spec's, e.g.
``load_device_spec(...).peak_flops_for("bf16") * mfu``.
"""

from __future__ import annotations

from repro_torch.core.taskgraph import StageCosts
from repro_torch.models.common import ModelConfig

__all__ = ["GPT_CONFIGS", "UNET_COSTS", "gpt_stage_costs"]


def _gpt(name, n_layers, d_hidden, d_ffn, n_heads, head_dim) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=n_layers,
        d_model=d_hidden,
        num_heads=n_heads,
        num_kv_heads=n_heads,
        d_ff=d_ffn,
        vocab_size=50_257,
        head_dim=head_dim,
        mlp_act="gelu",
        norm="layernorm",
        tie_embeddings=True,
        rope_theta=10_000.0,
    )


# Table 1: Config, N_layers, D_hidden, D_ffn, N_heads, D_head
GPT_CONFIGS: dict[str, ModelConfig] = {
    "GPT-Medium": _gpt("GPT-Medium", 24, 1024, 4096, 16, 64),
    "GPT-Large": _gpt("GPT-Large", 24, 1536, 6144, 16, 96),
    "GPT-XL": _gpt("GPT-XL", 24, 2048, 8192, 32, 64),
    "GPT-2.7B": _gpt("GPT-2.7B", 32, 2560, 10240, 32, 80),
}


def gpt_stage_costs(
    cfg: ModelConfig,
    num_stages: int,
    micro_batch_size: int,
    seq_len: int = 1024,
    *,
    chip_flops: float,
) -> StageCosts:
    """Analytic per-stage costs: 6*N*D flops split over stages, at
    ``chip_flops`` FLOP/s; cross-stage bytes = hidden-stream activation
    (b * seq * d_model * 2 bytes)."""
    layers_per_stage = max(cfg.num_layers // num_stages, 1)
    d, ff = cfg.d_model, cfg.d_ff
    per_layer_params = 4 * d * d + 2 * d * ff  # attn + gelu MLP
    tokens = micro_batch_size * seq_len
    fwd_flops = 2 * per_layer_params * tokens * layers_per_stage
    t_f = fwd_flops / chip_flops
    act_bytes = float(tokens * d * 2)  # bf16 hidden stream
    return StageCosts.uniform(num_stages, t_f, 2.0 * t_f, act_bytes=act_bytes)


def _unet_costs(num_stages: int, t_f: float, comm_frac: float) -> StageCosts:
    """U-Net proxy: cross-stage transfer takes ``comm_frac``*t_f at the
    nominal 12.5 GB/s link -- 3-5x the GPT stages' ~0.15 fraction (paper
    6.2.2/6.2.3: U-Net ships several times more tensor bytes between stages
    than layer-based LMs)."""
    act_bytes = comm_frac * t_f * 12.5e9
    return StageCosts.uniform(num_stages, t_f, 2.0 * t_f, act_bytes=act_bytes)


UNET_COSTS = {
    "UNet-Base": lambda S: _unet_costs(S, t_f=0.020, comm_frac=0.25),
    "UNet-Medium": lambda S: _unet_costs(S, t_f=0.150, comm_frac=0.15),
}
