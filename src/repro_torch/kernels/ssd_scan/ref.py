"""Plain PyTorch versions of the Mamba2 SSD scan: the kernel's oracle.

Port of ``repro/kernels/ssd_scan/ref.py``:

* :func:`ssd_reference` -- the sequential recurrence, a Python loop over
  time.  The ground truth.
* :func:`ssd_chunked` -- the chunked SSD algorithm (quadratic within a
  chunk, linear recurrence across chunks, a Python loop for the carry).
  This is what the kernel computes, what the CPU runs, and what the
  kernel's backward differentiates.

Two departures from the reference, neither of which changes the forward:

* ``seg = cum_i - cum_j`` is masked to ``-inf`` above the diagonal *before*
  ``exp``.  The reference takes ``exp(seg)`` on the whole square and zeroes
  the upper triangle afterwards; there ``seg > 0``, so once ``|sum dt*A|``
  over a chunk passes ~88 ``exp`` overflows to inf and the backward's
  ``0 * inf`` gives NaN gradients.
* The intra-chunk product is two steps, ``(C B^T) o L`` and then ``@ w``,
  so no ``[B, nc, Q, Q, H, P]`` tensor is built (3.2 GB a layer at
  mamba2-780m's training shape).

Shapes (one B/C group):
  x  [B, T, H, P];  dt [B, T, H] (positive);  A [H] (negative);
  Bm, Cm [B, T, N] or [B, T, 1, N];  returns y [B, T, H, P] in x's type.
All math is fp32.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_reference", "ssd_chunked", "ssd_chunked_flops"]


def _squeeze_group(M):
    if M.ndim == 4:
        if M.shape[2] != 1:
            raise ValueError(f"only one B/C group is supported, got G={M.shape[2]}")
        return M[:, :, 0, :]
    return M


def ssd_reference(x, dt, A, Bm, Cm):
    """h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T;  y_t = h_t C_t."""
    Bm = _squeeze_group(Bm).float()
    Cm = _squeeze_group(Cm).float()
    x32, dt32, A32 = x.float(), dt.float(), A.float()
    Bsz, T, H, P = x.shape
    h = torch.zeros((Bsz, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        decay = torch.exp(dt32[:, t] * A32)  # [B, H]
        h = h * decay[..., None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt32[:, t], x32[:, t], Bm[:, t]
        )
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 64):
    """Chunked SSD, equal to :func:`ssd_reference`.  Per chunk of length Q,
    with the inclusive in-chunk cumsum ``cum`` of ``a_t = dt_t A``:

      intra: y_i += sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) (dt_j x_j)
      inter: y_i += exp(cum_i) C_i . h_in
      carry: h_out = exp(cum_{Q-1}) h_in + sum_j exp(cum_{Q-1} - cum_j) (dt_j x_j) (x) B_j
    """
    Bm = _squeeze_group(Bm).float()
    Cm = _squeeze_group(Cm).float()
    x32, dt32, A32 = x.float(), dt.float(), A.float()
    Bsz, T, H, P = x.shape
    N = Bm.shape[-1]
    if T % chunk != 0:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    nc, Q = T // chunk, chunk

    xc = x32.reshape(Bsz, nc, Q, H, P)
    dtc = dt32.reshape(Bsz, nc, Q, H)
    bc = Bm.reshape(Bsz, nc, Q, N)
    cc = Cm.reshape(Bsz, nc, Q, N)

    cum = torch.cumsum(dtc * A32, dim=2)  # [B, nc, Q, H], inclusive
    w = dtc[..., None] * xc  # dt_j x_j  [B, nc, Q, H, P]

    # intra-chunk: ((C B^T) o L) @ w, with L masked before exp
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)  # [B, nc, Q, Q] (q = i, k = j)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # cum_i - cum_j  [B, nc, Q, Q, H]
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(seg.masked_fill(upper[:, :, None], float("-inf")))
    y = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * L, w)

    # inter-chunk carry: the state entering each chunk
    decay = torch.exp(cum[:, :, -1, :])  # [B, nc, H]
    inj_w = torch.exp(cum[:, :, -1:, :] - cum)  # [B, nc, Q, H]
    inj = torch.einsum("bcqhp,bcqn->bchpn", w * inj_w[..., None], bc)  # [B, nc, H, P, N]
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * decay[:, c, :, None, None] + inj[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B, nc, H, P, N]

    y = y + torch.einsum("bcqn,bchpn->bcqhp", cc, h_in) * torch.exp(cum)[..., None]
    return y.reshape(Bsz, T, H, P).to(x.dtype)


def ssd_chunked_flops(B: int, T: int, H: int, P: int, N: int, chunk: int) -> int:
    """FLOPs of :func:`ssd_chunked` as an operation counter counts its four
    products (2 per multiply-add) over the T / chunk chunks: ``C.B^T``
    (Q x Q x N), the intra-chunk ``@ w`` (H x Q x Q x P), the chunk's state
    injection and the carried state's read-out (H x P x N x Q each)."""
    Q = chunk
    return 2 * B * (T // Q) * Q * (Q * N + H * Q * P + 2 * H * P * N)
