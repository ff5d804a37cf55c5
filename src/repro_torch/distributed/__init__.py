"""Sharding rules, the sharded train step, the sharded prefill and decode
step, and the tensor-parallel products they run (port of
``repro.distributed``; :mod:`repro_torch.distributed.tensor_parallel`)."""

from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    param_pspecs,
    param_shardings,
    replicated,
)
from repro_torch.distributed.spmd import make_spmd_prefill, make_spmd_serve_step, make_spmd_train_step

__all__ = [
    "batch_shardings",
    "cache_shardings",
    "param_pspecs",
    "param_shardings",
    "replicated",
    "make_spmd_train_step",
    "make_spmd_prefill",
    "make_spmd_serve_step",
]
