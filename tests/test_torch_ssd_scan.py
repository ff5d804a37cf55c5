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


GPU_CASES = [
    # (B, T, H, P, N, chunk, x dtype, B/C dtype, rel-norm tolerance: see chip_smoke.SSD_REL_TOL)
    (4, 1024, 48, 64, 128, 64, torch.bfloat16, torch.bfloat16, 3.9e-3),  # mamba2-780m micro-batch
    (2, 128, 16, 32, 32, 8, torch.float32, torch.float32, 2e-5),  # mamba2-smoke
    (2, 32, 4, 16, 8, 8, torch.bfloat16, torch.float32, 3.9e-3),
    (1, 16, 8, 8, 4, 16, torch.float32, torch.float32, 2e-5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,P,N,chunk,x_dtype,bc_dtype,tol", GPU_CASES)
def test_kernel_matches_plain_on_card(B, T, H, P, N, chunk, x_dtype, bc_dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to("cuda") for a in _inputs(B, T, H, P, N))
    x, Bm, Cm = x.to(x_dtype), Bm.to(bc_dtype), Cm.to(bc_dtype)
    before = ops.launches
    out = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk).float()
    assert torch.isfinite(out).all()
    assert float((out.float() - want).norm() / want.norm()) <= tol
