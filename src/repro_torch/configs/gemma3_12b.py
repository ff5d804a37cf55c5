"""Gemma-3 12B — dense, 5:1 local:global attention, 128k context

Port of ``repro/configs/gemma3_12b.py``, field for field.
[hf:google/gemma-3-1b-pt family].

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144, head_dim=256
(q_dim 4096 != d_model, as in the released model).  Window pattern cycles
five 1024-token sliding-window layers then one global layer.

long_500k: NATIVE — global layers hold the full 500k KV (memory sharded
over the mesh), local layers hold only their 1024 ring buffer; per-token
decode is O(L) not O(L²).
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    d_ff=15_360,
    vocab_size=262_144,
    head_dim=256,
    window_pattern=(1024, 1024, 1024, 1024, 1024, None),
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    max_seq_len=131_072,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    d_ff=512,
    vocab_size=1024,
    head_dim=64,
    window_pattern=(64, None),
    tie_embeddings=True,
)

SPEC = register(
    ArchSpec(
        arch_id="gemma3-12b",
        citation="hf:google/gemma-3-1b-pt",
        model=FULL,
        smoke=SMOKE,
        long_context="native",
        notes="5:1 sliding-window:global; long_500k runs natively (windowed "
        "layers O(1) memory, global layers full-KV sharded)",
    )
)
