"""Mamba2-780M: attention-free SSD (state-space duality) [arXiv:2405.21060].

Port of ``repro/configs/mamba2_780m.py``: 48 layers, d_model 1536,
ssm_state 128, head_dim 64, expand 2, vocab 50 280, tied embeddings.  No
attention and no FFN: the Mamba2 block is the whole layer.  ``SPEC`` is
registered with the arch registry as the reference registers it.

long_500k: NATIVE -- decode state is O(1) per layer ([B, H, P, N]).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.common import ModelConfig

__all__ = ["FULL", "SMOKE", "SPEC"]

FULL = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=64,
    ssm_expand=2,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    num_layers=2,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=1024,
    ssm_state=32,
    ssm_head_dim=32,
    ssm_chunk=8,
    tie_embeddings=True,
)

SPEC = register(
    ArchSpec(
        arch_id="mamba2-780m",
        citation="arXiv:2405.21060",
        model=FULL,
        smoke=SMOKE,
        long_context="native",
        notes="attention-free; kFkB still applies (layer-partitionable, "
        "cross-stage tensor is the hidden stream) — DESIGN.md §5",
    )
)
