"""Hand-written CUDA kernels of the port and their build."""

from __future__ import annotations

__all__ = ["check_cp_async"]


def check_cp_async(name: str, ptr: int, shape, strides, itemsize: int) -> None:
    """Raise ``ValueError`` naming ``name`` unless its pointer and the
    strides (in elements) of its leading dims are 16-byte aligned: the
    kernels' tensor-core routes copy rows into shared memory with 16-byte
    ``cp.async``.  A dim of size 1 is never stepped over, so its stride does
    not matter; the last dim must be contiguous (the callers check)."""
    if ptr % 16:
        raise ValueError(f"{name}: data pointer {ptr:#x} is not 16-byte aligned (the mma route uses cp.async)")
    for d, (n, st) in enumerate(zip(shape[:-1], strides[:-1])):
        if n > 1 and (st * itemsize) % 16:
            raise ValueError(
                f"{name}: stride {st} of dim {d} is {st * itemsize} bytes, not a multiple of 16 "
                "(the mma route uses cp.async)"
            )
