"""Kimi K2 — trillion-parameter MoE (paper-table) [arXiv:2501.kimi2].

Port of ``repro/configs/kimi_k2_1t_a32b.py``, field for field.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts
top-8, one shared expert, sigmoid router scoring, first layer dense
(DeepSeek-V3-style layout the K2 report follows).  Adafactor: fp32 Adam
m/v for ~1T params (8 TB) does not fit 512 x 16 GB HBM; factored second
moments do (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    num_experts=384,
    num_experts_per_tok=8,
    moe_d_ff=2048,
    first_k_dense=1,
    n_shared_experts=1,
    router_scoring="sigmoid",
    rope_theta=50_000.0,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    num_experts=4,
    num_experts_per_tok=2,
    moe_d_ff=512,
    first_k_dense=1,
    n_shared_experts=1,
    router_scoring="sigmoid",
)

SPEC = register(
    ArchSpec(
        arch_id="kimi-k2-1t-a32b",
        citation="arXiv:2501.kimi2",
        model=FULL,
        smoke=SMOKE,
        optimizer="adafactor",
        long_context="windowed",
        long_window=8_192,
        notes="most interesting hillclimb pair candidate: EP all-to-all inside "
        "a stage contends with cross-stage p2p, the paper's preemption "
        "scenario made internal",
    )
)
