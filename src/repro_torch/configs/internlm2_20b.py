"""InternLM2-20B — dense, GQA [arXiv:2403.17297].

Port of ``repro/configs/internlm2_20b.py``, field for field.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internlm2-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
)

SPEC = register(
    ArchSpec(
        arch_id="internlm2-20b",
        citation="arXiv:2403.17297",
        model=FULL,
        smoke=SMOKE,
        long_context="windowed",
        long_window=8_192,
    )
)
