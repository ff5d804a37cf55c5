"""Mamba2 (SSD, state-space duality) block, arXiv:2405.21060: the training forward.

Port of ``repro/models/mamba.py:29-104``.  The chunked SSD runs through
:func:`repro_torch.kernels.ssd_scan.ops.ssd_chunked`: kernel K2 for a CUDA
tensor, the plain version for a CPU tensor, and the plain version's
gradient in the backward.  That is the design ``repro``'s module docstring
documents (its ``mamba_train`` reaches the kernel only under
``use_kernel=True``, which no caller sets).  The casts follow the reference
line by line: in_proj and the conv in ``cfg.dtype``; softplus(dt) and A in
fp32; D cast to y's type; the gated rmsnorm in fp32, returned in y's type.

Structure (minimal official mamba2):
  in_proj -> (z, x, B, C, dt); causal depthwise conv over (x, B, C);
  dt = softplus(dt + bias); A = -exp(A_log);
  y = SSD(x, dt, A, B, C) + D * x;  y = rmsnorm(y * silu(z)); out_proj.

The recurrent decode path (``mamba_prefill``, ``mamba_decode``,
``init_ssm_cache``) comes with the SSM serving slice.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import rmsnorm

__all__ = ["mamba_init", "mamba_train"]


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


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, H, P, N, G = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def _causal_conv(seq, w, b):
    """Depthwise causal conv along time.  seq: [B, T, C]; w: [K, C]."""
    K, T = w.shape[0], seq.shape[1]
    pad = F.pad(seq, (0, 0, K - 1, 0))
    out = sum(pad[:, i : i + T, :] * w[i] for i in range(K))
    return out + b


def mamba_train(p, x, cfg: ModelConfig):
    """x: [B, T, d] -> [B, T, d] (full-sequence chunked SSD)."""
    B_, T, d = x.shape
    d_in, H, P, N, G = _dims(cfg)
    dt_f = cfg.dtype
    zxbcdt = x.to(dt_f) @ p["in_proj"].to(dt_f)
    z, xx, Bc, Cc, dtv = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xx, Bc, Cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"].to(dt_f), p["conv_b"].to(dt_f)))
    xx, Bc, Cc = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    dtv = F.softplus(dtv.float() + p["dt_bias"].float())  # [B, T, H]
    A = -torch.exp(p["A_log"].float())  # [H]

    # views of the conv output: the kernel reads them through strides
    xh = xx.reshape(B_, T, H, P)
    Bh = Bc.reshape(B_, T, G, N)
    Ch = Cc.reshape(B_, T, G, N)
    y = ssd_ops.ssd_chunked(xh, dtv, A, Bh, Ch, chunk=cfg.ssm_chunk)  # [B, T, H, P]
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, T, d_in)
    y = rmsnorm({"scale": p["norm_scale"]}, y * F.silu(z))
    return y @ p["out_proj"].to(y.dtype)
