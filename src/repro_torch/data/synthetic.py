"""Deterministic synthetic token streams (port of ``repro/data/synthetic.py``, text only).

Each batch is a pure function of ``(seed, step)``: numpy's generator seeded
with ``(seed << 20) ^ step`` draws the same numbers as the reference, so the
tokens are the reference's.  The stream has a learnable pattern (an affine
walk over the vocabulary ring plus small noise), so loss curves mean
something.  Tensors are made on the caller's device (``cuda`` by default);
tokens and labels are int64, the index type torch's embedding takes.  The
frontend embeddings and M-RoPE positions of the multimodal families come
with their slices.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Batch", "SyntheticTextDataset"]


@dataclasses.dataclass
class Batch:
    tokens: torch.Tensor  # [B, T] int64
    labels: torch.Tensor  # [B, T] int64 (next-token targets)


@dataclasses.dataclass
class SyntheticTextDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int, device=None) -> Batch:
        """Pure function of (seed, step): shardable and resumable."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, T, V = self.global_batch, self.seq_len, self.vocab_size
        base = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        pos = np.arange(T + 1, dtype=np.int64)[None, :]
        noise = rng.integers(0, 7, size=(B, T + 1))
        stream = torch.from_numpy((base + 31 * pos + noise) % V).to(resolve_device(device))
        return Batch(tokens=stream[:, :-1], labels=stream[:, 1:])
