"""Chunked SSD scan: checks, dispatch, the launch count and the gradient.

Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_chunked_pallas`` (and its
wrapper ``ops.py::ssd_chunked``) with the hand-written CUDA kernel in
``csrc/ssd_fwd.cu``, built for ``sm_90a`` at first use.

* A CUDA tensor launches the kernel on the route :func:`route` picks from
  the dtypes and (P, N, chunk) alone: ``"mma"`` (tensor cores, cp.async,
  P split across blocks in slices of :data:`P_SLICE`) for bf16 x with bf16
  B/C, P a multiple of the slice and N and chunk multiples of 16
  (mamba2-780m), ``"fma"`` (fp32 FMAs) for the rest: fp32 x, mixed types,
  mamba2-smoke's chunk 8.  The mma route copies
  rows with 16-byte ``cp.async``, so :func:`repro_torch.kernels.check_cp_async`
  refuses x/Bm/Cm whose pointer or row strides are not 16-byte aligned with
  a ``ValueError`` naming the tensor; such inputs are never sent to the
  other route.  A refused or failed launch raises.
* A CPU tensor takes the plain version, :func:`.ref.ssd_chunked`.  Nothing
  falls back from the kernel to the plain version.
* ``launches`` counts kernel launches, so a run can show that its path went
  through the kernel.

The gradient.  ``repro`` has no backward kernel for the scan: it trains
with ``mamba_train``'s default ``use_kernel=False``, that is
``jax.value_and_grad`` through the jnp ``ssd_chunked``.  Here the forward
runs the kernel (or, on the CPU, the plain version) under a
``torch.autograd.Function`` that saves its inputs; the backward recomputes
:func:`.ref.ssd_chunked` from them and differentiates it with
``torch.autograd.grad``.  That plain version masks before ``exp``, so its
gradient stays finite where the reference's is NaN (see :mod:`.ref`).

What bounds the kernel on this card, and what its design does about it, is
in the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import check_cp_async
from repro_torch.kernels.ssd_scan import ref as _ref

__all__ = ["ssd_chunked", "route", "P_SLICE", "SOURCE", "SHAPES", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_fwd.cu"
#: (P, N, Q) the kernel is instantiated for: mamba2-780m, mamba2-smoke, the
#: rows of the reference's kernel tests (tests/test_kernels.py::SSD_CASES)
#: and jamba-v0.1-52b's Mamba layers (d_state 16)
SHAPES = ((64, 128, 64), (32, 32, 8), (16, 8, 8), (32, 16, 16), (64, 128, 32), (8, 4, 16), (64, 16, 64))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"fma": 0, "mma": 1}
#: P columns one block of the mma route owns (mamba2-780m: 2 blocks a head)
P_SLICE = 32

#: kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.repro_ssd_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 10
            + [ctypes.c_longlong] * 14
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_ssd_error_string.argtypes = [ctypes.c_int]
        lib.repro_ssd_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_ssd_error_string)
    return _fn


def _group(M, name: str):
    """[B, T, N] or [B, T, 1, N] -> [B, T, N] (a view); G != 1 is refused."""
    if M.ndim == 4:
        if M.shape[2] != 1:
            raise ValueError(f"{name}: only one B/C group is supported, got G={M.shape[2]}")
        return M[:, :, 0, :]
    if M.ndim != 3:
        raise ValueError(f"{name} must be [B,T,N] or [B,T,1,N], got {tuple(M.shape)}")
    return M


def _check(x, dt, A, Bm, Cm, chunk: int) -> None:
    if x.ndim != 4 or dt.ndim != 3 or A.ndim != 1:
        raise ValueError(f"expected x [B,T,H,P], dt [B,T,H], A [H]; got {x.ndim}/{dt.ndim}/{A.ndim}-D")
    Bg, Cg = _group(Bm, "Bm"), _group(Cm, "Cm")
    if not (x.device == dt.device == A.device == Bm.device == Cm.device):
        raise ValueError("x, dt, A, Bm and Cm must be on one device")
    if x.dtype not in _DTYPES or Bm.dtype not in _DTYPES or Bm.dtype != Cm.dtype:
        raise TypeError(
            f"x and Bm/Cm must be one of {list(_DTYPES)} (Bm and Cm alike); "
            f"got {x.dtype}, {Bm.dtype}/{Cm.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}/{A.dtype}")
    B, T, H, P = x.shape
    if tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not match x {tuple(x.shape)}")
    if Bg.shape[:2] != (B, T) or Bg.shape != Cg.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do not match x {tuple(x.shape)}")
    if chunk < 1 or T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")


def route(x_dtype: torch.dtype, bc_dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel route: ``"mma"`` (tensor cores) for bf16 x and bf16 B/C
    with P a multiple of :data:`P_SLICE`, N and chunk multiples of 16 and
    chunk <= 64; ``"fma"`` for every other case (fp32 x, whose tolerance
    TF32 would break; mixed types; mamba2-smoke's chunk 8)."""
    bf16 = x_dtype == torch.bfloat16 and bc_dtype == torch.bfloat16
    tiles = P % P_SLICE == 0 and N % 16 == 0 and chunk % 16 == 0 and chunk <= 64
    return "mma" if bf16 and tiles else "fma"


def _launch(x, dt, A, Bm, Cm, chunk: int):
    global launches
    Bm, Cm = _group(Bm, "Bm"), _group(Cm, "Cm")
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    path = route(x.dtype, Bm.dtype, P, N, chunk)
    if path == "mma":
        for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
            check_cp_async(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
    y = torch.empty((B, T, H, P), dtype=x.dtype, device=x.device)
    fn, err_str = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], _DTYPES[Bm.dtype], _ROUTES[path], P_SLICE, P, N, chunk, B, T, H,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), A.stride(0),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_fwd ({path} route) launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return y


class _SSDChunked(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward: the
    gradient of the plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return _ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            y = _ref.ssd_chunked(*inputs, chunk=ctx.chunk)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, gy))
        return (*(next(grads) if n else None for n in need), None)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 64):
    """x [B,T,H,P], dt [B,T,H] fp32, A [H] fp32, Bm/Cm [B,T,N] or [B,T,1,N]
    -> y [B,T,H,P] in x's type; differentiable in every tensor input."""
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cuda":
        P, N = x.shape[-1], Bm.shape[-1]
        if (P, N, chunk) not in SHAPES:
            raise ValueError(f"(P, N, chunk) = {(P, N, chunk)} is not one of the kernel's {SHAPES}")
        if x.stride(-1) != 1 or Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
            raise ValueError("the P axis of x and the N axis of Bm/Cm must be contiguous")
    elif x.device.type != "cpu":
        raise ValueError(f"ssd_chunked runs on cuda or cpu, not {x.device}")
    return _SSDChunked.apply(x, dt, A, Bm, Cm, chunk)
