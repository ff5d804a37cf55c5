"""Qwen2-VL-2B — VLM backbone with M-RoPE, dynamic resolution
[arXiv:2409.12191].

Port of ``repro/configs/qwen2_vl_2b.py``, field for field.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, QKV bias, M-RoPE
(temporal/height/width position streams split over head-dim sections).
The ViT vision encoder + projector is the sanctioned stub: ``input_specs``
supplies precomputed patch embeddings [B, S_patches, 1536] interleaved with
text embeddings; this module is the language decoder that consumes them.

long_500k: skipped — the visual-token budget is bounded by the stub
frontend and a 524k single-stream decode is not meaningful for this model.
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),  # head_dim 128 -> hd/2 = 64 slots
    rope_theta=1_000_000.0,
    frontend="vision",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=192,
    num_heads=4,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=1024,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(6, 9, 9),  # head_dim 48 -> hd/2 = 24 slots
    frontend="vision",
    tie_embeddings=True,
)

SPEC = register(
    ArchSpec(
        arch_id="qwen2-vl-2b",
        citation="arXiv:2409.12191",
        model=FULL,
        smoke=SMOKE,
        long_context="skip",
        notes="vision frontend stubbed per brief; M-RoPE exercised with "
        "3-stream positions; long_500k skipped (visual token budget bounded)",
    )
)
