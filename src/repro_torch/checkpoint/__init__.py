"""Checkpoints of the port's trees (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.io import latest_step, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
