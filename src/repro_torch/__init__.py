"""PyTorch/CUDA port of ``repro``, beside it in the same repository.

The serving slice: GPT-family models (``configs.gpt``) served by
``serve.ServeEngine`` with continuous batching over decode slots, a fused
prefill whose attention runs in a hand-written CUDA flash-attention kernel
(``kernels.flash_attention``), and a grouped greedy decode over the
``[M, b]`` grid.  The entry point is ``python -m repro_torch.launch.serve_decode``.

The port imports ``torch`` and numpy only: no JAX and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
