"""Flash attention forward: checks, dispatch and the launch count.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention_pallas``
(and its wrapper ``ops.py::flash_attention``) with the hand-written CUDA
kernel in ``csrc/flash_fwd.cu``, built for ``sm_90a`` at first use.

* A CUDA tensor launches the kernel on the route :func:`route` picks from
  the dtype alone: ``"mma"`` (tensor cores, cp.async) for bf16 and fp16,
  ``"fma"`` (fp32 FMAs) for fp32.  The mma route copies rows with 16-byte
  ``cp.async``, so :func:`repro_torch.kernels.check_cp_async` refuses
  q/k/v whose pointer or row strides are not 16-byte aligned with a
  ``ValueError`` naming the tensor; such inputs are never sent to the
  other route.  A refused or
  failed launch raises.
* A CPU tensor takes the plain version in :mod:`.ref`.  Nothing falls back
  from the kernel to the plain version.
* ``launches`` counts kernel launches, so a run can show that its path went
  through the kernel.

:func:`flash_attention_train` is the training entry: an autograd function
whose forward launches the kernel (CPU tensors: the plain training
attention, ``ref.train_attention``) and whose backward recomputes that
plain function from the saved q/k/v and differentiates it.  The reference
has no backward kernel to port; ``repro`` trains through the plain
attention.  Without a gradient to take (``torch.no_grad()``, or no input
that requires one) it runs the forward alone and saves nothing.

The training forward is the custom operator
``repro_torch::flash_attention_train``, so that an operation counter
(``torch.utils.flop_counter.FlopCounterMode``, which cannot see into a
``ctypes`` launch) counts it by its FLOP formula: the plain training
attention's two products over the full T x S square
(:func:`ref.train_attention_flops`), whatever implements it.  A forward
without a gradient so counts the same FLOPs through the kernel as through
the plain attention.  Under autograd the backward recomputes the plain
attention and differentiates it, and counters see that as it runs: the
kernel's route counts one forward more than the plain attention, which
keeps its probabilities for the backward instead.

What bounds the kernel on this card, and what its design does about it, is
in the note at the top of the CUDA source: at the serving shapes the bound
is the bytes of q/k/v/o; the kernel reads them once through strides (no
transpose, no GQA repeat, no pad copies) and skips fully masked tiles;
the mma route keeps both products on the tensor cores and overlaps the
next key tile's copy with the current tile's compute.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build
from repro_torch.kernels import check_cp_async
from repro_torch.kernels.flash_attention import ref as _ref

__all__ = ["flash_attention", "flash_attention_train", "route", "SOURCE", "HEAD_DIMS", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"
#: head widths the kernel is instantiated for: Table 1's 64, 80 and 96, 112
#: (kimi-k2: 7168 / 64), 128 (qwen2.5-14b, internlm2-20b, qwen1.5-4b,
#: jamba-v0.1-52b, llama4-maverick) and 256 (gemma3-12b)
HEAD_DIMS = (64, 80, 96, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_ROUTES = {"fma": 0, "mma": 1}

#: kernel launches since the count was last set to 0
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = _build.load(SOURCE)
        fn = lib.repro_flash_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong] * 12
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.repro_cuda_error_string)
    return _fn


def _check(q, k, v, causal: bool, window: int | None) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected 4-D q/k/v, got {q.ndim}/{k.ndim}/{v.ndim}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v must share one of {list(_DTYPES)}; got {q.dtype}/{k.dtype}/{v.dtype}")
    B, T, H, hd = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    Bk, S, K, hdk = k.shape
    if Bk != B or hdk != hd:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"num_heads {H} is not a multiple of num_kv_heads {K}")
    if T == 0 or S == 0:
        raise ValueError("empty query or key range")
    if causal and T > S:
        raise ValueError(f"causal attention needs T <= S (queries end-aligned), got T={T} S={S}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dimension of q/k/v must be contiguous")


def route(dtype: torch.dtype) -> str:
    """The kernel route for q/k/v of ``dtype``: ``"mma"`` (tensor cores) for
    bf16 and fp16, ``"fma"`` for fp32, whose tolerance TF32 would break."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes {list(_DTYPES)}, not {dtype}")
    return "fma" if dtype == torch.float32 else "mma"


def flash_attention(q, k, v, causal: bool = True, window: int | None = None):
    """q [B,T,H,hd]; k, v [B,S,K,hd] -> [B,T,H,hd] in q's type; scores
    scaled by 1/sqrt(hd)."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return _ref.attention(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _check_kernel_shape(B: int, H: int, hd: int) -> None:
    """What the kernel takes beyond :func:`_check`: an instantiated head
    width, and B*H within the fma route's grid rows."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in the kernel's {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the grid's 65535 rows")


def _launch(q, k, v, causal: bool, window: int | None):
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    B, T, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    _check_kernel_shape(B, H, hd)
    path = route(q.dtype)
    if path == "mma":
        for name, t in (("q", q), ("k", k), ("v", v)):
            check_cp_async(name, t.data_ptr(), t.shape, t.stride(), t.element_size())
    out = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], _ROUTES[path], hd, B, T, S, H, K,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / math.sqrt(hd), int(causal), int(window or 0), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd ({path} route) launch failed: {err_str(err).decode()} ({err})")
    launches += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention_train", mutates_args=())
def _train_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, window: int | None) -> torch.Tensor:
    if q.device.type == "cpu":
        return _ref.train_attention(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


@_train_forward.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention_train)
def _train_forward_flops(q_shape, k_shape, v_shape, causal, window, out_shape=None, **kwargs) -> int:
    B, T, H, hd = q_shape
    return _ref.train_attention_flops(B, T, k_shape[1], H, hd)


class _FlashTrain(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain training attention (CPU).
    Backward: the gradient of the plain training attention, recomputed from
    the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _train_forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, go):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
            out = _ref.train_attention(*inputs, causal=ctx.causal, window=ctx.window)
            wanted = [t for t, n in zip(inputs, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, go))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention_train(q, k, v, causal: bool = True, window: int | None = None):
    """The training attention, differentiable in q, k and v: q [B,T,H,hd];
    k, v [B,S,K,hd] -> [B,T,H,hd] in q's type."""
    _check(q, k, v, causal, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashTrain.apply(q, k, v, causal, window)
    return _train_forward(q, k, v, causal, window)
