"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060.

Port of ``repro/models/mamba.py``.  In the training forward the chunked
SSD runs through :func:`repro_torch.kernels.ssd_scan.ops.ssd_chunked`:
kernel K2 for a CUDA tensor, the plain version for a CPU tensor, and the
plain version's gradient in the backward.  That is the design ``repro``'s
module docstring documents (its ``mamba_train`` reaches the kernel only under
``use_kernel=True``, which no caller sets).  The casts follow the reference
line by line: in_proj and the conv in ``cfg.dtype``; softplus(dt) and A in
fp32; D cast to y's type; the gated rmsnorm in fp32, returned in y's type.

Structure (minimal official mamba2):
  in_proj -> (z, x, B, C, dt); causal depthwise conv over (x, B, C);
  dt = softplus(dt + bias); A = -exp(A_log);
  y = SSD(x, dt, A, B, C) + D * x;  y = rmsnorm(y * silu(z)); out_proj.

Serving carries an explicit ``[B, H, P, N]`` fp32 recurrent state and the
last ``conv_width - 1`` conv inputs, the SSM analogue of a KV cache
(:func:`init_ssm_cache`).  :func:`mamba_decode` is the one-token
recurrence; :func:`mamba_prefill` steps it over the prompt (``repro``'s
``lax.scan``), so the fused prefill leaves the state token stepping leaves,
bitwise.  The chunked SSD (and so K2) is not on this path: it does not
expose the final recurrent state the decode loop needs.  Both update the
cache in place, as the attention cache is.

**By heads.**  :func:`mamba_train`, :func:`mamba_decode` and
:func:`mamba_prefill_heads` take ``heads`` (first, count) and ``tp``, the
hooks of a split over the "model" axis
(``repro_torch.distributed.tensor_parallel.TensorParallel``): ``in_proj``'s
output arrives as the rank's column shard and ``tp.gather_cols`` joins it;
the conv, ``softplus(dt)``, A, D and the SSD run on those heads (their x
channels and the whole B and C); the gated rmsnorm's sum of squares over
the whole ``d_in`` goes through ``tp.reduce_both``; ``out_proj`` is the
heads' rows, its partial summed by ``tp.exit``.  A decode step's row and
conv window come whole from ``tp.decode_row`` and the window goes back
through ``tp.write_window``.  Without ``tp`` every hook is the identity and
the heads are all of them: the one-process forms, unchanged.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rmsnorm

__all__ = [
    "mamba_init", "mamba_train", "mamba_prefill", "mamba_prefill_heads", "mamba_decode", "init_ssm_cache",
]

#: tokens of :func:`mamba_prefill_heads`'s recurrence whose state increments
#: are formed at once (an fp32 [B, chunk, heads, P, N] buffer: 134 MB at
#: jamba's 64 heads a rank and 2 rows)
PREFILL_CHUNK = 256


def _dims(cfg: ModelConfig):
    d_in = cfg.d_model * cfg.ssm_expand
    H = d_in // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1  # single B/C group (standard mamba2 default)
    return d_in, H, P, N, G


def mamba_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    d_in, H, P, N, G = _dims(cfg)
    conv_dim = d_in + 2 * G * N
    proj_out = 2 * d_in + 2 * G * N + H
    dev, pdt = gen.device, cfg.param_dtype

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=pdt)

    u = torch.rand((H,), generator=gen, device=dev, dtype=torch.float32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "in_proj": normal(d, proj_out) * (1.0 / math.sqrt(d)),
        "conv_w": normal(cfg.ssm_conv_width, conv_dim) * (1.0 / math.sqrt(cfg.ssm_conv_width)),
        "conv_b": torch.zeros((conv_dim,), dtype=pdt, device=dev),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(pdt),  # inverse softplus
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32, device=dev)).to(pdt),
        "D": torch.ones((H,), dtype=pdt, device=dev),
        "norm_scale": torch.ones((d_in,), dtype=pdt, device=dev),
        "out_proj": normal(d_in, d) * (1.0 / math.sqrt(d_in)),
    }


class _One:
    """The hooks of one process: every collective the identity."""

    @staticmethod
    def enter(t):
        return t

    exit = gather_cols = reduce_both = enter

    @staticmethod
    def decode_row(part, window, conv_dim):
        return part, window

    @staticmethod
    def write_window(cache, window):
        cache["conv"].copy_(window)


_ONE = _One()


def _conv_cols(t, cfg: ModelConfig, heads):
    """The channels of ``t`` [..., conv_dim] that ``heads`` (first, count)
    use: their x channels, then B and C (``t`` itself for every head)."""
    d_in, H, P, _, _ = _dims(cfg)
    first, n = heads
    if n == H:
        return t
    return torch.cat([t[..., first * P:(first + n) * P], t[..., d_in:]], dim=-1)


def _proj_parts(zxbcdt, cfg: ModelConfig, heads):
    """``in_proj``'s whole output [..., proj] -> (the conv input of every
    channel, and of ``heads``: z, the conv input (:func:`_conv_cols`), dt)."""
    d_in, _, P, N, G = _dims(cfg)
    first, n = heads
    conv = zxbcdt[..., d_in:2 * d_in + 2 * G * N]
    dt0 = 2 * d_in + 2 * G * N + first
    return conv, zxbcdt[..., first * P:(first + n) * P], _conv_cols(conv, cfg, heads), zxbcdt[..., dt0:dt0 + n]


def _head_params(p, cfg: ModelConfig, heads):
    """The conv weight and bias of ``heads``' channels (in ``cfg.dtype``),
    and their ``dt_bias`` (fp32), A (fp32) and D."""
    first, n = heads
    hs = slice(first, first + n)
    w, b = (_conv_cols(p[k].to(cfg.dtype), cfg, heads) for k in ("conv_w", "conv_b"))
    return w, b, p["dt_bias"][hs].float(), -torch.exp(p["A_log"][hs].float()), p["D"][hs]


def _gated_norm(p, y, z, cfg: ModelConfig, heads, tp):
    """rmsnorm(y * silu(z)) of ``heads``' channels [..., count P]; under
    ``tp`` over the whole ``d_in``: each row's fp32 sum of squares summed
    by ``tp.reduce_both`` (rmsnorm's eps)."""
    if tp is None:
        return rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    d_in, _, P, _, _ = _dims(cfg)
    first, n = heads
    g = (y * F.silu(z)).float()
    ss = tp.reduce_both(g.square().sum(dim=-1, keepdim=True))
    return (g * torch.rsqrt(ss / d_in + 1e-6) * p["norm_scale"][first * P:(first + n) * P].float()).to(y.dtype)


def _causal_conv(seq, w, b):
    """Depthwise causal conv along time.  seq: [B, T, C]; w: [K, C]."""
    K, T = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + T, :] * w[i] for i in range(K))
    return out + b


def _check_state(cache, heads):
    if cache["state"].shape[1] != heads[1]:
        raise ValueError(f"an SSM state of {cache['state'].shape[1]} heads does not hold the heads {heads}")


def mamba_train(p, x, cfg: ModelConfig, heads=None, tp=None):
    """x: [B, T, d] -> [B, T, d] (full-sequence chunked SSD), on ``heads``
    under ``tp`` (the module docstring)."""
    B_, T, _ = x.shape
    _, H, P, N, G = _dims(cfg)
    heads = heads or (0, H)
    n, hooks, dt_f = heads[1], tp or _ONE, cfg.dtype
    zxbcdt = hooks.gather_cols(hooks.enter(x).to(dt_f) @ p["in_proj"].to(dt_f))
    _, z, conv_in, dtv = _proj_parts(zxbcdt, cfg, heads)
    w, b, dt_bias, A, D = _head_params(p, cfg, heads)
    conv_out = F.silu(_causal_conv(conv_in, w, b))
    xx, Bc, Cc = torch.split(conv_out, [n * P, G * N, G * N], dim=-1)
    dtv = F.softplus(dtv.float() + dt_bias)  # [B, T, n]

    # views of the conv output: the kernel reads them through strides
    xh = xx.reshape(B_, T, n, P)
    y = ssd_ops.ssd_chunked(xh, dtv, A, Bc.reshape(B_, T, G, N), Cc.reshape(B_, T, G, N), chunk=cfg.ssm_chunk)
    y = y + xh * D.to(y.dtype)[None, None, :, None]
    y = _gated_norm(p, y.reshape(B_, T, n * P), z, cfg, heads, tp)
    return hooks.exit(y @ p["out_proj"].to(y.dtype))


# -- decode (recurrent) -----------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, device=None):
    d_in, H, P, N, G = _dims(cfg)
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d_in + 2 * G * N), dtype=cfg.dtype, device=device),
    }


def mamba_prefill(p, x, cache, cfg: ModelConfig):
    """Prefill of the recurrent state: :func:`mamba_decode` stepped over the
    prompt.  x: [B, T, d] -> (y [B, T, d], cache), the cache in the state
    T decode steps leave it, bitwise.  Each step gets its token as a
    contiguous [B, 1, d] tensor, as decode does: a strided view would reach
    the in_proj GEMM with another leading dimension."""
    ys = [
        mamba_decode(p, x[:, t : t + 1].clone(memory_format=torch.contiguous_format), cache, cfg)[0]
        for t in range(x.shape[1])
    ]
    return torch.cat(ys, dim=1), cache


def _ssm_step(state, xh, Bh, Ch, dtv, A, D):
    """One step of the recurrence over the heads of ``state`` [B, H, P, N]
    (fp32): xh [B, H, P], Bh and Ch [B, N], dtv [B, H], A and D [H], all
    fp32.  Returns (y [B, H, P], the new state)."""
    decay = torch.exp(dtv * A)  # [B, H]
    state = state * decay[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dtv, xh, Bh)
    return torch.einsum("bhpn,bn->bhp", state, Ch) + xh * D[None, :, None], state


def mamba_prefill_heads(p, x, cache, cfg: ModelConfig, heads, tp=None):
    """Mamba2 over the prompt x [B, T, d] (from position 0) -> [B, T, d] on
    ``heads`` under ``tp``: ``in_proj``, the conv, the norm and ``out_proj``
    over the whole prompt at once, the recurrence stepped token by token,
    each :data:`PREFILL_CHUNK` tokens' state increments formed at once; with
    ``cache`` (``heads``' state, ``tp``'s shard of the conv window) filled.
    Equal to :func:`mamba_prefill` up to rounding, not bitwise."""
    B_, T, _ = x.shape
    _, _, P, N, G = _dims(cfg)
    n, K, hooks = heads[1], cfg.ssm_conv_width, tp or _ONE
    conv, z, conv_in, dtv = _proj_parts(hooks.gather_cols(x.to(cfg.dtype) @ p["in_proj"].to(cfg.dtype)), cfg, heads)
    w, b, dt_bias, A, D = _head_params(p, cfg, heads)
    conv_out = F.silu(_causal_conv(conv_in, w, b))
    xx, Bc, Cc = torch.split(conv_out, [n * P, G * N, G * N], dim=-1)
    dtv = F.softplus(dtv.float() + dt_bias)
    xh, Bh, Ch = xx.reshape(B_, T, n, P).float(), Bc.float(), Cc.float()
    # what no step depends on is computed for a chunk of tokens at once:
    # a step is then one multiply-add of the state and one product with C
    decay = torch.exp(dtv * A)  # [B, T, n]
    state = torch.zeros((B_, n, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((B_, T, n, P), dtype=torch.float32, device=x.device)
    for t0 in range(0, T, PREFILL_CHUNK):
        t1 = min(T, t0 + PREFILL_CHUNK)
        inc = torch.einsum("bth,bthp,btn->bthpn", dtv[:, t0:t1], xh[:, t0:t1], Bh[:, t0:t1])
        for t in range(t0, t1):
            state = state * decay[:, t, :, None, None] + inc[:, t - t0]
            y[:, t] = torch.einsum("bhpn,bn->bhp", state, Ch[:, t])
    y = (y + xh * D.float()[None, None, :, None]).reshape(B_, T, n * P).to(cfg.dtype)
    out = hooks.exit(_gated_norm(p, y, z, cfg, heads, tp) @ p["out_proj"].to(cfg.dtype))
    if cache is not None:
        _check_state(cache, heads)
        cache["state"].copy_(state)
        hooks.write_window(cache, F.pad(conv, (0, 0, K - 1, 0))[:, -(K - 1):])  # zeros before the prompt
    return out


def mamba_decode(p, x, cache, cfg: ModelConfig, heads=None, tp=None):
    """One-token recurrent step.  x: [B, 1, d] -> (y [B, 1, d], cache), on
    ``heads`` under ``tp`` (the module docstring)."""
    B_ = x.shape[0]
    d_in, H, P, N, G = _dims(cfg)
    heads = heads or (0, H)
    n, hooks, dt_f = heads[1], tp or _ONE, cfg.dtype
    _check_state(cache, heads)
    zxbcdt, win = hooks.decode_row(x[:, 0].to(dt_f) @ p["in_proj"].to(dt_f), cache["conv"], d_in + 2 * G * N)
    conv_in, z, _, dtv = _proj_parts(zxbcdt, cfg, heads)
    window = torch.cat([win, conv_in[:, None]], dim=1)  # [B, K, conv_dim]
    w, b, dt_bias, A, D = _head_params(p, cfg, heads)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", _conv_cols(window, cfg, heads), w) + b)
    xx, Bc, Cc = torch.split(conv_out, [n * P, G * N, G * N], dim=-1)
    dtv = F.softplus(dtv.float() + dt_bias)  # [B, n]
    # G = 1: B and C [B, N]
    y, state = _ssm_step(cache["state"], xx.reshape(B_, n, P).float(), Bc.float(), Cc.float(), dtv, A, D.float())
    y = y.reshape(B_, 1, n * P).to(dt_f)
    y = _gated_norm(p, y, z[:, None], cfg, heads, tp)
    y = hooks.exit(y @ p["out_proj"].to(y.dtype))
    cache["state"].copy_(state)
    hooks.write_window(cache, window[:, 1:])
    return y, cache
