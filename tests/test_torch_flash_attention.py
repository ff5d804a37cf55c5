"""The port's flash attention against ``repro``'s oracle and Pallas kernel.

On the CPU the wrapper takes the plain version, so these tests hold the
plain version to ``repro.kernels.flash_attention.ref.attention`` and to
``flash_attention_pallas`` in interpret mode over every ``FLASH_CASES`` row
of ``test_kernels.py``, at that row's tolerance.  The CUDA kernel itself is
held to the plain version by the ``gpu``-marked tests (and by chip_smoke.py).

The training entry ``flash_attention_train`` takes the plain training
attention on the CPU (forward and backward); on the card its forward
launches the kernel and its backward differentiates the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jax_ref
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels import check_cp_async
from repro_torch.kernels.flash_attention import ops, ref
from test_kernels import FLASH_CASES

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# the slice's head width (GPT-2.7B), not a power of two
CASES = FLASH_CASES + [
    (128, 128, 80, True, None, 64, 64, jnp.float32, 2e-6),
    (96, 96, 80, True, None, 32, 32, jnp.bfloat16, 2e-2),
]


def _qkv(B, T, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


def _both(arrs, jdtype):
    j = [jnp.asarray(a, jdtype) for a in arrs]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(_TORCH[jdtype]) for x in j]
    return j, t


@pytest.mark.parametrize("T,S,hd,causal,window,bq,bk,dtype,tol", CASES)
def test_plain_matches_reference_and_pallas(T, S, hd, causal, window, bq, bk, dtype, tol):
    B, H = 2, 3
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, T, S, H, H, hd), dtype)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    got = got.float().numpy()
    want = np.asarray(jax_ref.attention(jq, jk, jv, causal=causal, window=window), np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)

    flat = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], hd)  # noqa: E731
    pallas = flash_attention_pallas(
        flat(jq), flat(jk), flat(jv), causal=causal, window=window,
        block_q=bq, block_k=bk, interpret=True,
    )
    pallas = np.asarray(pallas, np.float32).reshape(B, H, T, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


# T < S and native GQA are held to ref.attention only: flash_attention_pallas
# places query i at position i (kernel.py:67) where the oracle places it at
# i + S - T (ref.py:25), so the two agree only at T == S; and the Pallas
# wrapper takes GQA pre-repeated.
REF_ONLY = [
    # (B, T, S, H, K, hd, causal, window)
    (2, 5, 17, 4, 4, 32, True, None),
    (1, 24, 40, 4, 4, 80, True, 12),
    (2, 16, 16, 6, 2, 32, True, None),
    (1, 9, 30, 8, 2, 80, False, None),
]


@pytest.mark.parametrize("B,T,S,H,K,hd,causal,window", REF_ONLY)
def test_plain_matches_reference_t_lt_s_and_gqa(B, T, S, H, K, hd, causal, window):
    (jq, jk, jv), (q, k, v) = _both(_qkv(B, T, S, H, K, hd, seed=1), jnp.float32)
    got = ops.flash_attention(q, k, v, causal=causal, window=window).numpy()
    rep = H // K
    want = jax_ref.attention(
        jq, jnp.repeat(jk, rep, axis=2), jnp.repeat(jv, rep, axis=2), causal=causal, window=window
    )
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6, rtol=2e-6)


REFUSALS = [
    # (name, q shape, k shape, dtype, kwargs, error)
    ("float64", (1, 8, 4, 32), (1, 8, 4, 32), torch.float64, {}, TypeError),
    ("int", (1, 8, 4, 32), (1, 8, 4, 32), torch.int32, {}, TypeError),
    ("h_not_multiple_of_k", (1, 8, 6, 32), (1, 8, 4, 32), torch.float32, {}, ValueError),
    ("head_dim_mismatch", (1, 8, 4, 32), (1, 8, 4, 64), torch.float32, {}, ValueError),
    ("batch_mismatch", (2, 8, 4, 32), (1, 8, 4, 32), torch.float32, {}, ValueError),
    ("causal_t_gt_s", (1, 9, 4, 32), (1, 8, 4, 32), torch.float32, {}, ValueError),
    ("window_zero", (1, 8, 4, 32), (1, 8, 4, 32), torch.float32, {"window": 0}, ValueError),
    ("three_dims", (8, 4, 32), (8, 4, 32), torch.float32, {}, ValueError),
]


@pytest.mark.parametrize("name,qs,ks,dtype,kw,err", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses(name, qs, ks, dtype, kw, err):
    before = ops.launches
    with pytest.raises(err):
        ops.flash_attention(
            torch.zeros(qs, dtype=dtype), torch.zeros(ks, dtype=dtype), torch.zeros(ks, dtype=dtype), **kw
        )
    assert ops.launches == before


def test_wrapper_refuses_strided_head_dim():
    q = torch.zeros(1, 8, 4, 64)[..., ::2]
    k = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, k)


def test_cpu_takes_plain_version_without_counting_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 32))
    before = ops.launches
    out = ops.flash_attention(q, k, v)
    assert ops.launches == before
    torch.testing.assert_close(out, ref.attention(q, k, v), rtol=0, atol=0)


ROUTES = [
    # (dtype, route): the serving path's bf16 (and fp16) on the tensor cores,
    # fp32 on the FMA kernel
    (torch.bfloat16, "mma"),
    (torch.float16, "mma"),
    (torch.float32, "fma"),
]


@pytest.mark.parametrize("dtype,want", ROUTES)
def test_route_is_chosen_by_dtype(dtype, want):
    assert ops.route(dtype) == want


def test_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        ops.route(torch.float64)


def _serving_qkv(B=1, T=512, H=32, hd=80, dtype=torch.bfloat16):
    """q/k/v as the serving path makes them: separate projections split into
    heads, [B, T, H, hd] each."""
    return [torch.zeros((B, T, H * hd), dtype=dtype).reshape(B, T, H, hd) for _ in range(3)]


def test_serving_layout_meets_the_cp_async_alignment():
    for name, t in zip("qkv", _serving_qkv()):
        check_cp_async(name, t.data_ptr(), t.shape, t.stride(), t.element_size())


MISALIGNED = [
    # (case, view, message): a pointer 2 bytes past an aligned one; a time
    # stride of 4 x 81 bf16 elements (648 bytes)
    ("pointer", lambda: torch.zeros((1, 8, 4, 81), dtype=torch.bfloat16)[..., 1:], "pointer"),
    ("stride", lambda: torch.zeros((1, 8, 4, 81), dtype=torch.bfloat16)[..., :80], "stride 324 of dim 1"),
]


@pytest.mark.parametrize("case,view,match", MISALIGNED, ids=[m[0] for m in MISALIGNED])
def test_misaligned_view_raises_naming_the_tensor(case, view, match):
    t = view()
    with pytest.raises(ValueError, match=f"^k: .*{match}"):
        check_cp_async("k", t.data_ptr(), t.shape, t.stride(), t.element_size())


GPU_CASES = [
    # (B, T, S, H, K, hd, dtype, causal, window, tol)
    (1, 333, 333, 32, 32, 80, torch.bfloat16, True, None, 2e-2),
    (1, 100, 333, 8, 8, 80, torch.float32, True, None, 2e-5),
    (2, 200, 200, 8, 2, 64, torch.float16, True, 64, 2e-2),
    (1, 130, 130, 4, 4, 128, torch.bfloat16, False, None, 2e-2),
    # the mma route's edges: a ragged T of 333 at hd 96, fp16 with a window,
    # T < S
    (1, 333, 333, 16, 16, 96, torch.bfloat16, True, None, 2e-2),
    (1, 333, 333, 8, 8, 80, torch.float16, True, 100, 2e-2),
    (1, 100, 333, 8, 8, 80, torch.bfloat16, True, None, 2e-2),
    # serve_adaptive's prefill: 16 tokens, under one query tile
    (1, 16, 16, 32, 32, 80, torch.bfloat16, True, None, 2e-2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,H,K,hd,dtype,causal,window,tol", GPU_CASES)
def test_kernel_matches_plain_on_card(B, T, S, H, K, hd, dtype, causal, window, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to("cuda", dtype) for a in _qkv(B, T, S, H, K, hd))
    assert ops.route(dtype) == ("fma" if dtype == torch.float32 else "mma")
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


TRAIN_CPU_CASES = [
    # (B, T, S, H, K, hd, window): T < S, GQA, a window, and the chunked
    # plain path from 2048 query tokens up
    (2, 24, 24, 4, 2, 16, None),
    (1, 10, 30, 4, 4, 16, 7),
    (1, 2100, 2100, 2, 1, 8, None),
]


@pytest.mark.parametrize("B,T,S,H,K,hd,window", TRAIN_CPU_CASES, ids=["gqa", "t_lt_s_window", "chunked"])
def test_train_entry_on_cpu_is_the_plain_training_attention(B, T, S, H, K, hd, window):
    """Forward and gradients equal autograd of ``ref.train_attention``
    exactly (the same operations on the CPU), and no launch is counted."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(B, T, S, H, K, hd, seed=3))
    go = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, H, hd)).astype(np.float32))
    before = ops.launches
    out = ops.flash_attention_train(q, k, v, window=window)
    grads = torch.autograd.grad(out, (q, k, v), go)
    assert ops.launches == before
    want = ref.train_attention(q, k, v, window=window)
    want_grads = torch.autograd.grad(want, (q, k, v), go)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if T >= ref.CHUNKED_ATTN_THRESHOLD:  # the chunked path is the same function
        torch.testing.assert_close(want, ref.attention(q, k, v, window=window), rtol=1e-5, atol=1e-6)


def test_train_entry_without_gradients_saves_nothing():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 8, 8, 2, 2, 16))
    with torch.no_grad():
        out = ops.flash_attention_train(q, k, v)
    assert out.grad_fn is None
    out = ops.flash_attention_train(*(t.detach() for t in (q, k, v)))
    assert out.grad_fn is None
    assert ops.flash_attention_train(q, k, v).grad_fn is not None


def test_train_entry_refuses_what_the_kernel_refuses():
    q = torch.zeros(1, 8, 4, 64)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_train(q, torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 4, 32))
    with pytest.raises(ValueError, match="causal attention needs T <= S"):
        ops.flash_attention_train(torch.zeros(1, 9, 2, 16), torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16))


GPU_TRAIN_CASES = [
    # (B, T, H, hd, dtype): one micro-batch of the pipeline phase, and fp32
    (1, 1024, 32, 80, torch.bfloat16),
    (2, 200, 8, 64, torch.float32),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,hd,dtype", GPU_TRAIN_CASES)
def test_train_entry_gradient_matches_plain_on_card(B, T, H, hd, dtype):
    """The kernel runs the forward (one launch); the gradient is autograd of
    the plain training attention's, from the same inputs and cotangent, so
    the two agree exactly.  The forward agrees at the kernel's tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = (torch.from_numpy(a).to("cuda", dtype).requires_grad_(True) for a in _qkv(B, T, T, H, H, hd))
    go = torch.from_numpy(np.random.default_rng(4).standard_normal((B, T, H, hd))).to("cuda", dtype)
    before = ops.launches
    out = ops.flash_attention_train(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), go)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.train_attention(q, k, v)
    want_grads = torch.autograd.grad(want, (q, k, v), go)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
