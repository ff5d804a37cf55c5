"""SeamlessM4T-medium — encoder-decoder multimodal (speech) [arXiv:2308.11596].

Port of ``repro/configs/seamless_m4t_medium.py``, field for field.

12L decoder + 12L encoder, d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096
vocab=256206.  LayerNorm + GeLU (standard transformer recipe).  The speech
frontend (mel-spectrogram + conv feature extractor) is the sanctioned stub:
``input_specs()`` supplies precomputed frame embeddings [B, S_frames, 1024];
the port implements the transformer backbone that consumes them.

long_500k: skipped — an enc-dec speech translation model has no meaningful
524k-token decode (its decoder length is capped far below).
"""

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    encoder_layers=12,
    norm="layernorm",
    mlp_act="gelu",
    frontend="audio",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="seamless-m4t-smoke",
    family="encdec",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=1024,
    encoder_layers=2,
    norm="layernorm",
    mlp_act="gelu",
    frontend="audio",
    tie_embeddings=True,
)

SPEC = register(
    ArchSpec(
        arch_id="seamless-m4t-medium",
        citation="arXiv:2308.11596",
        model=FULL,
        smoke=SMOKE,
        long_context="skip",
        notes="enc-dec speech backbone; audio frontend stubbed per brief; "
        "long_500k skipped (no modeling meaning for speech decode)",
    )
)
