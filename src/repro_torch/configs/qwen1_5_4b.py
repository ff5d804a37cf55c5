"""Qwen1.5-4B — dense, MHA-with-bias (kv == heads) [hf:Qwen/Qwen1.5-0.5B].

Port of ``repro/configs/qwen1_5_4b.py``, field for field.

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936, QKV bias.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen1.5-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    d_ff=512,
    vocab_size=1024,
    qkv_bias=True,
)

SPEC = register(
    ArchSpec(
        arch_id="qwen1.5-4b",
        citation="hf:Qwen/Qwen1.5-0.5B",
        model=FULL,
        smoke=SMOKE,
        long_context="windowed",
        long_window=8_192,
    )
)
