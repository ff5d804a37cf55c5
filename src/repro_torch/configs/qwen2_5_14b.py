"""Qwen2.5-14B — dense, GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family].

Port of ``repro/configs/qwen2_5_14b.py``, field for field.

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    qkv_bias=True,
)

SPEC = register(
    ArchSpec(
        arch_id="qwen2.5-14b",
        citation="hf:Qwen/Qwen2.5-0.5B",
        model=FULL,
        smoke=SMOKE,
        long_context="windowed",
        long_window=8_192,
        notes="pure full-attention dense arch; long_500k served with an "
        "explicit sliding-window variant (beyond-paper config)",
    )
)
