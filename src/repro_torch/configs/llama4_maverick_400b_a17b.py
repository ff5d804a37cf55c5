"""Llama-4 Maverick 400B-A17B — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family].

Port of ``repro/configs/llama4_maverick_400b_a17b.py``, field for field.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128 experts
top-1 routing plus one always-on shared expert, MoE on every *other* layer
(Maverick's interleave_moe_layer_step=2 — this is what lands the total at
~400B rather than ~780B).  Adafactor for the same optimizer-state-budget
reason as kimi-k2.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    num_experts=128,
    num_experts_per_tok=1,
    moe_d_ff=8192,
    moe_every=2,
    moe_offset=1,
    n_shared_experts=1,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    num_experts=4,
    num_experts_per_tok=1,
    moe_d_ff=512,
    moe_every=2,
    moe_offset=1,
    n_shared_experts=1,
)

SPEC = register(
    ArchSpec(
        arch_id="llama4-maverick-400b-a17b",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
        model=FULL,
        smoke=SMOKE,
        optimizer="adafactor",
        long_context="windowed",
        long_window=8_192,
        notes="top-1 routing; iRoPE chunked attention in the real model "
        "justifies the windowed long-context serving variant",
    )
)
