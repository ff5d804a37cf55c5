"""Primitive layers: dense, norms, MLPs, embeddings, rotary position embeddings.

Port of ``repro/models/layers.py``.  Parameters are plain dictionaries of
tensors with the reference's names and shapes (a dense weight is
``[d_in, d_out]``), so the weight bridge maps them one to one.  Functions are
pure over tensors, as in the reference: parameters may be held in
``cfg.param_dtype`` and cast to ``cfg.dtype`` at use, or already cast once
(``api.cast_for_serving``), which gives the same numbers.

Initialisers draw from an explicit ``torch.Generator`` on the target device;
they cannot reproduce ``jax.random``, so parity tests bridge the reference's
weights instead.  The sharding anchor comes with the distributed path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig

__all__ = [
    "dense_init",
    "dense",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "norm_init",
    "norm_apply",
    "mlp_init",
    "mlp",
    "embedding_init",
    "embed",
    "unembed",
    "rope_frequencies",
    "apply_rope",
    "apply_mrope",
    "cross_entropy_loss",
]


def _normal(gen: torch.Generator, shape, cfg: ModelConfig) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=cfg.param_dtype)


# -- linear -----------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, cfg: ModelConfig, bias: bool = False):
    p = {"w": _normal(gen, (d_in, d_out), cfg) * (1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=cfg.param_dtype, device=gen.device)
    return p


def dense(p, x, cfg: ModelConfig):
    y = x.to(cfg.dtype) @ p["w"].to(cfg.dtype)
    if "b" in p:
        y = y + p["b"].to(cfg.dtype)
    return y


# -- norms --------------------------------------------------------------------


def _ones(d: int, cfg: ModelConfig, device) -> torch.Tensor:
    return torch.ones((d,), dtype=cfg.param_dtype, device=device)


def rmsnorm_init(d: int, cfg: ModelConfig, device=None):
    return {"scale": _ones(d, cfg, device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(d: int, cfg: ModelConfig, device=None):
    return {
        "scale": _ones(d, cfg, device),
        "bias": torch.zeros((d,), dtype=cfg.param_dtype, device=device),
    }


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)  # population variance, as jnp.var
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * p["scale"].float() + p["bias"].float()).to(dt)


def norm_init(d: int, cfg: ModelConfig, device=None):
    if cfg.norm == "layernorm":
        return layernorm_init(d, cfg, device)
    return rmsnorm_init(d, cfg, device)


def norm_apply(p, x, cfg: ModelConfig):
    return layernorm(p, x) if cfg.norm == "layernorm" else rmsnorm(p, x)


# -- MLP ----------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None):
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_act == "swiglu":
        return {
            "gate": dense_init(gen, cfg.d_model, d_ff, cfg),
            "up": dense_init(gen, cfg.d_model, d_ff, cfg),
            "down": dense_init(gen, d_ff, cfg.d_model, cfg),
        }
    return {
        "up": dense_init(gen, cfg.d_model, d_ff, cfg),
        "down": dense_init(gen, d_ff, cfg.d_model, cfg),
    }


def mlp(p, x, cfg: ModelConfig):
    if "gate" in p:
        h = F.silu(dense(p["gate"], x, cfg)) * dense(p["up"], x, cfg)
    else:
        h = F.gelu(dense(p["up"], x, cfg), approximate="tanh")  # jax.nn.gelu's default
    return dense(p["down"], h, cfg)


# -- embeddings ----------------------------------------------------------------


def embedding_init(gen: torch.Generator, cfg: ModelConfig):
    p = {"table": _normal(gen, (cfg.vocab_size, cfg.d_model), cfg) * 0.02}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, cfg.vocab_size), cfg) * 0.02
    return p


def embed(p, tokens, cfg: ModelConfig):
    return p["table"].to(cfg.dtype)[tokens]


def unembed(p, h, cfg: ModelConfig):
    if "head" in p:
        return h.to(cfg.dtype) @ p["head"].to(cfg.dtype)
    return h.to(cfg.dtype) @ p["table"].to(cfg.dtype).T


# -- rotary position embeddings -------------------------------------------------


def _inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    exponent = torch.arange(0, cfg.hd, 2, dtype=torch.float32, device=device) / cfg.hd
    return 1.0 / (cfg.rope_theta**exponent)


def rope_frequencies(cfg: ModelConfig, positions):
    """inv-freq outer positions -> (cos, sin) of shape [..., hd/2], fp32."""
    ang = positions.float()[..., None] * _inv_freq(cfg, positions.device)  # [..., T, hd/2]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    # x: [..., T, n_heads, hd]; cos/sin: [..., T, hd/2] -> broadcast over heads
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, cos, sin):
    return _rotate(x, cos, sin).to(x.dtype)


def apply_mrope(cfg: ModelConfig, x, positions3):
    """Qwen2-VL M-RoPE: three position streams (temporal, height, width).

    ``positions3``: [3, ..., T].  The head_dim/2 frequency slots are split
    into ``mrope_sections`` (t, h, w); each section takes its angle from its
    own stream (a slot past the sections' sum takes angle 0, as the
    reference's one-hot selection gives it).  Text-only inputs pass
    identical streams, which recovers 1-D RoPE."""
    half = cfg.hd // 2
    ang = positions3.float()[..., None] * _inv_freq(cfg, x.device)  # [3, ..., T, hd/2]
    sec = torch.cumsum(torch.tensor(cfg.mrope_sections, device=x.device), 0)
    idx = torch.searchsorted(sec, torch.arange(half, device=x.device), right=True)  # 0/1/2 per slot
    sel = F.one_hot(idx, 4)[:, :3].float()  # [hd/2, 3]; idx 3 selects no stream
    ang = torch.einsum("s...j,js->...j", ang, sel)
    return apply_rope(x, torch.cos(ang), torch.sin(ang))


# -- loss -------------------------------------------------------------------------


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0):
    """Mean token cross-entropy in fp32, optional z-loss, optional mask."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * logz.square()
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
