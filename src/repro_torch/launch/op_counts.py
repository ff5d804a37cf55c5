"""Operation counts of one program: its FLOPs and HBM bytes, in eager PyTorch.

The port's counterpart of ``repro/launch/hlo_analysis.py``, which parses
XLA's optimized HLO.  Eager PyTorch has no HLO; the counts come from the
operations the program dispatches:

* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode``: matrix
  products at 2 * |result| * |contracted| (its ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, convolution and attention formulas), elementwise work not
  counted -- the rule of ``hlo_analysis.py``, which counts ``dot`` ops only.
  A kernel launched through ``ctypes`` is invisible to the counter: K1's
  training entry is a custom operator with a FLOP formula for that reason
  (``kernels/flash_attention/ops.py``), so a forward counts the same FLOPs
  through the kernel as through the plain attention.  The counter reads a
  custom operator's inputs and output, not its inside: K1's bytes are those
  of q, k, v and out, what the kernel moves.
* **HBM bytes** from :class:`ByteCounter`: the bytes of every operand and
  every result of each aten operation that materialises a tensor; views and
  metadata operations count nothing.  That is eager PyTorch's
  kernel-boundary traffic, the counterpart of XLA's fusion-boundary rule
  (operand + result bytes of each top-level instruction), and **not the same
  number as ``repro``'s**: XLA fuses a chain of elementwise operations into
  one kernel that reads its inputs once, where eager PyTorch runs each of
  them as a kernel of its own, so the count here is larger by a factor that
  depends on the program.

Counting a program built on the ``meta`` device allocates nothing and
launches nothing.  The collective-bytes half of ``hlo_analysis`` (wire
bytes per collective kind) is :mod:`repro_torch.launch.hlo_analysis`'s
recorder, which logs the port's own collective calls.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.devicespec import ProgramCounts

__all__ = ["ByteCounter", "count_ops", "tensor_bytes"]

_aten = torch.ops.aten
#: operations that return a tensor without moving its data (allocations and
#: reinterpretations that are not declared views)
_NO_TRAFFIC = {
    _aten.empty.memory_format,
    _aten.empty_strided.default,
    _aten.empty_like.default,
    _aten.new_empty.default,
    _aten.new_empty_strided.default,
    _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ByteCounter(TorchDispatchMode):
    """Sums the operand and result bytes of every operation that moves data
    (``hbm_bytes``); views and the allocations in ``_NO_TRAFFIC`` count
    nothing, nor does an operation that returns no tensor.  A custom
    operator counts as one operation."""

    def __init__(self) -> None:
        super().__init__()
        self.hbm_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _NO_TRAFFIC:
            return out
        results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if results:
            operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.hbm_bytes += sum(tensor_bytes(t) for t in operands + results)
        return out


def count_ops(fn: Callable[[], object]) -> ProgramCounts:
    """FLOPs and HBM bytes of one call of ``fn``, run under both counters."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn()
    return ProgramCounts(flops=float(flops.get_total_flops()), hbm_bytes=float(nbytes.hbm_bytes))
