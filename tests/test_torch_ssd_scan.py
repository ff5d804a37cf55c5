"""The port's chunked SSD scan against ``repro``'s oracles and Pallas kernel.

On the CPU the wrapper takes the plain version, so these tests hold the
plain versions (``ref.ssd_chunked`` and ``ref.ssd_reference``) to
``repro.kernels.ssd_scan.ref.ssd_reference`` and to ``ssd_chunked_pallas``
in interpret mode over every row of ``SSD_CASES`` (a copy of
``tests/test_kernels.py::SSD_CASES``), at that row's tolerance.  They hold
the wrapper's gradient (the plain version's, recomputed in the backward) to
``jax.grad`` of ``repro``'s jnp ``ssd_chunked`` in fp32 at rtol 1e-4, and
to ``jax.grad`` of the sequential recurrence where ``repro``'s chunked
gradient is NaN.  The CUDA kernel itself is held to the plain version by the
``gpu``-marked test (and by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ref as jax_ref
from repro.kernels.ssd_scan.kernel import ssd_chunked_pallas
from repro_torch.kernels import check_cp_async
from repro_torch.kernels.ssd_scan import ops, ref

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

SSD_CASES = [
    # (B, T, H, P, N, chunk, dtype, tol)
    (2, 32, 4, 16, 8, 8, jnp.float32, 1e-4),
    (1, 64, 2, 32, 16, 16, jnp.float32, 1e-4),
    (2, 64, 4, 64, 128, 32, jnp.float32, 1e-3),  # production-ish N
    (2, 32, 4, 16, 8, 8, jnp.bfloat16, 5e-2),
    (1, 16, 8, 8, 4, 16, jnp.float32, 1e-4),  # chunk == T
]


def _inputs(B, T, H, P, N, seed=0):
    """x, dt (softplus of a normal), A (negative), B, C as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = (-np.abs(rng.standard_normal(H)) - 0.1).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrs, x_dtype):
    """jnp and torch copies; x in ``x_dtype`` (the same rounded values on both
    sides), the rest fp32, as in the reference's kernel tests."""
    x, *rest = arrs
    jx = jnp.asarray(x, x_dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_TORCH[x_dtype])
    return [jx, *map(jnp.asarray, rest)], [tx, *map(torch.from_numpy, rest)]


@pytest.mark.parametrize("B,T,H,P,N,chunk,dtype,tol", SSD_CASES)
def test_plain_matches_reference_and_pallas(B, T, H, P, N, chunk, dtype, tol):
    j, t = _both(_inputs(B, T, H, P, N), dtype)
    want = np.asarray(jax_ref.ssd_reference(*j), np.float32)
    pallas = np.asarray(ssd_chunked_pallas(*j, chunk=chunk, interpret=True), np.float32)
    for got in (ref.ssd_chunked(*t, chunk=chunk), ref.ssd_reference(*t)):
        assert got.dtype == t[0].dtype and got.shape == t[0].shape
        got = got.float().numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def _assert_grads_close(got, want, rtol):
    """Each gradient within ``rtol`` of the reference's, relative to the
    largest entry of that gradient (entries near zero carry only rounding)."""
    for name, g, w in zip(("x", "dt", "A", "Bm", "Cm"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=name)


def _port_grads(arrs, chunk, cotangent, grouped=False):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrs]
    Bm, Cm = (m[:, :, None, :] for m in ts[3:]) if grouped else ts[3:]
    y = ops.ssd_chunked(ts[0], ts[1], ts[2], Bm, Cm, chunk=chunk)
    return torch.autograd.grad(y, ts, torch.from_numpy(cotangent))


GRAD_CASES = [
    # (B, T, H, P, N, chunk, B/C as [B,T,1,N])
    (2, 32, 4, 16, 8, 8, False),
    (1, 64, 2, 32, 16, 16, True),
    (2, 32, 4, 32, 32, 8, False),  # mamba2-smoke's P, N, chunk
]


@pytest.mark.parametrize("B,T,H,P,N,chunk,grouped", GRAD_CASES)
def test_gradients_match_jax_grad_of_reference_chunked(B, T, H, P, N, chunk, grouped):
    arrs = _inputs(B, T, H, P, N, seed=1)
    ct = np.random.default_rng(2).standard_normal((B, T, H, P)).astype(np.float32)
    got = _port_grads(arrs, chunk, ct, grouped)
    want = jax.grad(
        lambda *a: jnp.sum(jax_ref.ssd_chunked(*a, chunk=chunk) * ct), argnums=(0, 1, 2, 3, 4)
    )(*map(jnp.asarray, arrs))
    _assert_grads_close(got, want, rtol=1e-4)


def test_gradients_stay_finite_where_the_reference_chunked_gradient_is_nan():
    """B 1, T 128, H 4, P 8, N 8, chunk 64, dt 0.1, A = (-1, -8, -24, -48):
    ``|sum dt*A|`` over a chunk reaches 307, so ``repro``'s ``ssd_chunked``
    overflows ``exp(seg)`` on the upper triangle (``ref.py:98-100``) and its
    ``jax.grad`` with respect to dt and A is NaN in heads 3 and 4, though
    its forward is right.  The port masks before ``exp``: its gradients are
    finite and equal ``jax.grad`` of the sequential recurrence."""
    B, T, H, P, N, chunk = 1, 128, 4, 8, 8, 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = np.full((B, T, H), 0.1, np.float32)
    A = np.array([-1.0, -8.0, -24.0, -48.0], np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    arrs = (x, dt, A, Bm, Cm)
    ct = rng.standard_normal((B, T, H, P)).astype(np.float32)

    def jax_grads(fn):
        return jax.grad(lambda *a: jnp.sum(fn(*a) * ct), argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrs))

    nan = jax_grads(lambda *a: jax_ref.ssd_chunked(*a, chunk=chunk))
    assert np.isnan(np.asarray(nan[1])[..., 2:]).any(), "the shape no longer reaches the overflow"
    assert np.isnan(np.asarray(nan[2])[2:]).all() and np.isfinite(np.asarray(nan[2])[:2]).all()
    got = _port_grads(arrs, chunk, ct)
    _assert_grads_close(got, jax_grads(jax_ref.ssd_reference), rtol=1e-4)


def test_cpu_takes_plain_version_without_counting_a_launch():
    _, t = _both(_inputs(2, 32, 4, 16, 8), jnp.float32)
    before = ops.launches
    out = ops.ssd_chunked(*t, chunk=8)
    assert ops.launches == before
    torch.testing.assert_close(out, ref.ssd_chunked(*t, chunk=8), rtol=0, atol=0)


def _zeros(B=1, T=16, H=2, P=8, N=4, G=None, dtype=torch.float32, bc_dtype=torch.float32):
    bc_shape = (B, T, N) if G is None else (B, T, G, N)
    return (
        torch.zeros((B, T, H, P), dtype=dtype),
        torch.zeros((B, T, H)),
        torch.zeros((H,)),
        torch.zeros(bc_shape, dtype=bc_dtype),
        torch.zeros(bc_shape, dtype=bc_dtype),
    )


REFUSALS = [
    # (name, inputs, chunk, error, message)
    ("t_not_multiple_of_chunk", _zeros(T=20), 8, ValueError, "multiple of chunk"),
    ("two_groups", _zeros(G=2), 8, ValueError, "G=2"),
    ("one_group_ok_but_chunk_zero", _zeros(G=1), 0, ValueError, "chunk"),
    ("float16_x", _zeros(dtype=torch.float16), 8, TypeError, "float16"),
    ("float64_bc", _zeros(bc_dtype=torch.float64), 8, TypeError, "float64"),
    ("dt_shape", (*_zeros()[:1], torch.zeros((1, 16, 3)), *_zeros()[2:]), 8, ValueError, "dt"),
]


@pytest.mark.parametrize("name,inputs,chunk,err,match", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_wrapper_refuses(name, inputs, chunk, err, match):
    before = ops.launches
    with pytest.raises(err, match=match):
        ops.ssd_chunked(*inputs, chunk=chunk)
    assert ops.launches == before


_F32, _BF16 = torch.float32, torch.bfloat16
ROUTES = [
    # (name, x dtype, B/C dtype, P, N, chunk, route)
    ("mamba2-780m_bf16", _BF16, _BF16, 64, 128, 64, "mma"),
    ("ssd_cases_2_bf16", _BF16, _BF16, 64, 128, 32, "mma"),
    ("mamba2-780m_fp32", _F32, _F32, 64, 128, 64, "fma"),
    ("mamba2-780m_mixed", _BF16, _F32, 64, 128, 64, "fma"),
    ("mamba2-smoke_bf16", _BF16, _BF16, 32, 32, 8, "fma"),
    ("mamba2-smoke_fp32", _F32, _F32, 32, 32, 8, "fma"),
    ("ssd_cases_3", _BF16, _F32, 16, 8, 8, "fma"),
    ("jamba_bf16", _BF16, _BF16, 64, 16, 64, "mma"),
    ("jamba_fp32", _F32, _F32, 64, 16, 64, "fma"),
]


@pytest.mark.parametrize("name,x_dtype,bc_dtype,P,N,chunk,want", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_is_chosen_by_dtype_and_shape(name, x_dtype, bc_dtype, P, N, chunk, want):
    assert ops.route(x_dtype, bc_dtype, P, N, chunk) == want


def test_p_slice_splits_mamba2_780m_heads_in_two():
    assert 64 % ops.P_SLICE == 0 and 64 // ops.P_SLICE == 2


def _conv_views(B=2, T=64, H=48, P=64, N=128, width=None, offset=0):
    """x/B/C as mamba_train passes them: views at element offsets 0, H*P and
    H*P + N of a bf16 conv output [B, T, H*P + 2N] (``width`` and ``offset``
    break the alignment on purpose)."""
    width = width or H * P + 2 * N
    conv = torch.zeros((B, T, width + offset), dtype=torch.bfloat16)[..., offset:]
    x = conv[..., : H * P].reshape(B, T, H, P)
    Bm = conv[..., H * P : H * P + N].reshape(B, T, 1, N)
    Cm = conv[..., H * P + N : H * P + 2 * N].reshape(B, T, 1, N)
    return {"x": x, "Bm": Bm, "Cm": Cm}


def test_mamba_layout_meets_the_cp_async_alignment():
    for kw in ({}, dict(H=128, N=16)):  # mamba2-780m's layout, jamba's (d_state 16)
        for name, t in _conv_views(**kw).items():
            check_cp_async(name, t.data_ptr(), t.shape, t.stride(), t.element_size())


MISALIGNED = [
    # (case, views, tensor, message): every view 2 bytes past an aligned
    # pointer; a conv row of 3329 elements (6658 bytes) between time steps
    ("pointer", dict(offset=1), "x", "pointer"),
    ("row_stride", dict(width=48 * 64 + 2 * 128 + 1), "x", "stride 3329 of dim 1"),
]


@pytest.mark.parametrize("case,kw,name,match", MISALIGNED, ids=[m[0] for m in MISALIGNED])
def test_misaligned_view_raises_naming_the_tensor(case, kw, name, match):
    t = _conv_views(**kw)[name]
    with pytest.raises(ValueError, match=f"^{name}: .*{match}"):
        check_cp_async(name, t.data_ptr(), t.shape, t.stride(), t.element_size())


def _tf32(t):
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 of the 23 mantissa bits."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mma_route_emulation(x, dt, A, Bm, Cm, chunk):
    """The arithmetic of the mma route of ``ssd_fwd.cu``, chunk by chunk:
    C B^T exact in fp32 (products of bf16 values), S = (C B^T) o L in fp32,
    then S w, C h^T and the state update with their fp32 operands rounded
    to TF32 (C and B are bf16, so exact in TF32) and fp32 sums; y in x's
    type."""
    x32, Bf, Cf = x.float(), Bm.float(), Cm.float()
    Bsz, T, H, P = x.shape
    Q = chunk
    y = torch.empty((Bsz, T, H, P))
    h = torch.zeros((Bsz, H, P, Bf.shape[-1]))
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        cum = torch.cumsum(dt[:, sl] * A, dim=1)  # [B, Q, H]
        w = dt[:, sl, :, None] * x32[:, sl]  # [B, Q, H, P]
        cb = Cf[:, sl] @ Bf[:, sl].transpose(1, 2)  # [B, Q, Q]
        seg = cum[:, :, None, :] - cum[:, None, :, :]
        S = cb[..., None] * torch.exp(seg.masked_fill(upper[None, :, :, None], float("-inf")))
        intra = torch.einsum("bijh,bjhp->bihp", _tf32(S), _tf32(w))
        inter = torch.einsum("bin,bhpn->bihp", Cf[:, sl], _tf32(h)) * torch.exp(cum)[..., None]
        y[:, sl] = intra + inter
        din = torch.exp(cum[:, -1:] - cum)[..., None]  # exp(cum_last - cum_j)
        h = h * torch.exp(cum[:, -1])[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", _tf32(w * din), Bf[:, sl]
        )
    return y.to(x.dtype)


def test_tf32_emulation_error_is_under_half_the_bf16_limit():
    """Predicts the mma route's error on the card.  At mamba2-780m's
    (P, N, Q) = (64, 128, 64), its 48 heads with A = -(1..48) and dt in the
    init range [0.001, 0.1] (``mamba_init``), T 256: the emulated route's y
    (bf16) is within half of ``chip_smoke.SSD_REL_TOL[bf16]`` = 3.9e-3 of
    the plain version's, in relative norm; so is its fp32 result, before
    the output rounding, which TF32 alone moves by ~3e-4."""
    B, T, H, P, N, Q = 1, 256, 48, 64, 128, 64
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, T, H, P)).astype(np.float32)).bfloat16()
    Bm = torch.from_numpy(rng.standard_normal((B, T, N)).astype(np.float32)).bfloat16()
    Cm = torch.from_numpy(rng.standard_normal((B, T, N)).astype(np.float32)).bfloat16()
    dt = torch.from_numpy((0.001 + 0.099 * rng.random((B, T, H))).astype(np.float32))
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    assert ops.route(x.dtype, Bm.dtype, P, N, Q) == "mma"
    limit = 3.9e-3 / 2
    for xs, bs, cs in ((x, Bm, Cm), (x.float(), Bm.float(), Cm.float())):
        got = _mma_route_emulation(xs, dt, A, bs, cs, Q).float()
        want = ref.ssd_chunked(xs, dt, A, bs, cs, chunk=Q).float()
        assert float((got - want).norm() / want.norm()) < limit


GPU_CASES = [
    # (B, T, H, P, N, chunk, x dtype, B/C dtype, rel-norm tolerance: see chip_smoke.SSD_REL_TOL)
    (4, 1024, 48, 64, 128, 64, torch.bfloat16, torch.bfloat16, 3.9e-3),  # mamba2-780m micro-batch
    (2, 128, 16, 32, 32, 8, torch.float32, torch.float32, 2e-5),  # mamba2-smoke
    (2, 32, 4, 16, 8, 8, torch.bfloat16, torch.float32, 3.9e-3),
    (1, 16, 8, 8, 4, 16, torch.float32, torch.float32, 2e-5),
    # the mma route's edges: two chunks (T 128), two P slices a head; the
    # (64, 128, 32) row; x bf16 with B/C fp32 at mamba2-780m's shape (fma route)
    (2, 128, 8, 64, 128, 64, torch.bfloat16, torch.bfloat16, 3.9e-3),
    (2, 64, 4, 64, 128, 32, torch.bfloat16, torch.bfloat16, 3.9e-3),
    (1, 128, 4, 64, 128, 64, torch.bfloat16, torch.float32, 3.9e-3),
    # jamba-v0.1-52b's Mamba layers: (P 64, N 16, Q 64) on both routes
    (1, 256, 8, 64, 16, 64, torch.bfloat16, torch.bfloat16, 3.9e-3),
    (1, 128, 4, 64, 16, 64, torch.float32, torch.float32, 2e-5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,chunk,x_dtype,bc_dtype,tol", GPU_CASES)
def test_kernel_matches_plain_on_card(B, T, H, P, N, chunk, x_dtype, bc_dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to("cuda") for a in _inputs(B, T, H, P, N))
    x, Bm, Cm = x.to(x_dtype), Bm.to(bc_dtype), Cm.to(bc_dtype)
    bf16 = x_dtype == bc_dtype == torch.bfloat16
    assert ops.route(x_dtype, bc_dtype, P, N, chunk) == ("mma" if bf16 and chunk % 16 == 0 else "fma")
    before = ops.launches
    out = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk).float()
    assert torch.isfinite(out).all()
    assert float((out.float() - want).norm() / want.norm()) <= tol
