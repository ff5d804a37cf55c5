"""Jamba-v0.1 52B — hybrid Mamba + attention 1:7 interleave, MoE
[arXiv:2403.19887].

Port of ``repro/configs/jamba_v0_1_52b.py``, field for field.

32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 16 experts top-2 on every
other layer, vocab=65536.  Each 8-layer Jamba block has exactly one
attention layer (offset 4), the rest Mamba; our mamba implementation is
Mamba2/SSD (the TPU-native chunked form) with Jamba's d_state=16.

long_500k: NATIVE — Mamba layers carry O(1) recurrent state; the four
attention layers keep a full KV (sharded), giving O(L) decode memory in
only 4/32 layers.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=65_536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14_336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=64,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    num_experts=4,
    num_experts_per_tok=2,
    moe_d_ff=512,
    moe_every=2,
    moe_offset=1,
    attn_every=2,
    attn_offset=1,  # layer 0 mamba(+moe), layer 1 attention
    ssm_state=16,
    ssm_head_dim=32,
    ssm_chunk=8,
)

SPEC = register(
    ArchSpec(
        arch_id="jamba-v0.1-52b",
        citation="arXiv:2403.19887",
        model=FULL,
        smoke=SMOKE,
        long_context="native",
        notes="Mamba state is per-layer => stage-local under pipeline "
        "partition; nothing extra crosses stages (DESIGN.md §5)",
    )
)
