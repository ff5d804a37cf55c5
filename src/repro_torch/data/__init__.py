"""Synthetic data (port of ``repro.data``)."""

from repro_torch.data.synthetic import Batch, SyntheticTextDataset, microbatch_split

__all__ = ["Batch", "SyntheticTextDataset", "microbatch_split"]
