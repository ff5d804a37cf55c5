"""Mamba2 chunked SSD scan forward: CUDA kernel (``csrc/ssd_fwd.cu``), wrapper and plain version."""
