"""Sharding rules and the sharded train step (port of ``repro.distributed``).

The serving half of ``repro/distributed/spmd.py`` is not ported yet:
:func:`make_spmd_prefill` and :func:`make_spmd_serve_step` raise
``NotImplementedError`` naming ROADMAP.md queue 1, item 9.
"""

from repro_torch.distributed.sharding import (
    batch_shardings,
    cache_shardings,
    param_pspecs,
    param_shardings,
    replicated,
)
from repro_torch.distributed.spmd import make_spmd_train_step

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


def make_spmd_prefill(cfg, mesh, batch_specs):
    raise NotImplementedError(
        "the sharded prefill (repro's make_spmd_prefill) is not ported yet (ROADMAP.md, queue 1, item 9)"
    )


def make_spmd_serve_step(cfg, mesh, batch_specs, kv_len):
    raise NotImplementedError(
        "the sharded decode step (repro's make_spmd_serve_step, with cache_shardings) is not ported yet "
        "(ROADMAP.md, queue 1, item 9)"
    )
