"""The paper's own GPT test configurations (Table 1).

Port of ``repro/configs/gpt.py::GPT_CONFIGS``.  The analytic stage costs and
the U-Net proxies of that module belong to the schedule layer, which a later
slice of the port brings.
"""

from __future__ import annotations

from repro_torch.models.common import ModelConfig

__all__ = ["GPT_CONFIGS"]


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
