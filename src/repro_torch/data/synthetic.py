"""Deterministic synthetic token streams (port of ``repro/data/synthetic.py``).

Each batch is a pure function of ``(seed, step)``: numpy's generator seeded
with ``(seed << 20) ^ step`` draws the same numbers as the reference, so the
tokens are the reference's.  The stream has a learnable pattern (an affine
walk over the vocabulary ring plus small noise), so loss curves mean
something.  Tensors are made on the caller's device (``cuda`` by default);
tokens and labels are int64, the index type torch's embedding takes.

For the modality-frontend architectures (audio, vlm) the dataset also
emits precomputed frame or patch embeddings (``embed_dim``; ``embed_len``
positions, default the sequence length), drawn from the same generator
after the token noise, and M-RoPE's three position streams (``mrope``).
:func:`microbatch_split` cuts a batch into micro-batches along its batch
axis, which is axis 1 of the ``[3, B, T]`` positions.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["Batch", "SyntheticTextDataset", "microbatch_split"]


@dataclasses.dataclass
class Batch:
    tokens: torch.Tensor  # [B, T] int64
    labels: torch.Tensor  # [B, T] int64 (next-token targets)
    embeds: torch.Tensor | None = None  # [B, S, d] modality-frontend output
    mrope_positions: torch.Tensor | None = None  # [3, B, T] int32 for M-RoPE models


@dataclasses.dataclass
class SyntheticTextDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int | None = None  # emit frontend embeddings if set
    embed_len: int | None = None
    mrope: bool = False

    def batch_at(self, step: int, device=None) -> Batch:
        """Pure function of (seed, step): shardable and resumable."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, T, V = self.global_batch, self.seq_len, self.vocab_size
        base = rng.integers(0, V, size=(B, 1), dtype=np.int64)
        pos = np.arange(T + 1, dtype=np.int64)[None, :]
        noise = rng.integers(0, 7, size=(B, T + 1))
        device = resolve_device(device)
        stream = torch.from_numpy((base + 31 * pos + noise) % V).to(device)
        embeds = mrope_positions = None
        if self.embed_dim:
            S = self.embed_len or T
            e = rng.standard_normal(size=(B, S, self.embed_dim)).astype(np.float32)
            embeds = torch.from_numpy(e).to(device)
        if self.mrope:
            mrope_positions = torch.arange(T, dtype=torch.int32, device=device).expand(3, B, T)
        return Batch(tokens=stream[:, :-1], labels=stream[:, 1:], embeds=embeds, mrope_positions=mrope_positions)


def microbatch_split(batch: Batch, num_microbatches: int) -> list[Batch]:
    """Split a global batch into M micro-batches along the batch axis (axis
    1 of the positions, whose axis 0 is the three streams)."""
    B = batch.tokens.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by M={num_microbatches}")

    def cut(x, dim: int = 0):
        return None if x is None else x.chunk(num_microbatches, dim=dim)

    parts = [cut(batch.tokens), cut(batch.labels), cut(batch.embeds), cut(batch.mrope_positions, 1)]
    return [Batch(*(None if p is None else p[i] for p in parts)) for i in range(num_microbatches)]
