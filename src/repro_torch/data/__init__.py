"""Synthetic data (port of ``repro.data``, text only)."""

from repro_torch.data.synthetic import Batch, SyntheticTextDataset

__all__ = ["Batch", "SyntheticTextDataset"]
