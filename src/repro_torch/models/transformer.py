"""Model assembly for the decoder-only families (dense and SSM): init,
training forward and loss, prefill and decode.

Port of ``repro/models/transformer.py``.  The reference
stacks the repeating block of layers into ``[n_blocks, ...]`` leaves for
``lax.scan``; PyTorch runs eagerly, so here the layers are a plain list in
model order (``params["layers"][i]`` is layer ``i``) and the weight bridge
unstacks.  :func:`structure` is kept because the bridge maps the reference's
``blocks`` keys through it.  The dense family has no irregular leading
layers, so the reference's ``prefix`` group is always empty here.

MoE layers and the encoder-decoder family come with later slices;
:func:`repro_torch.models.common.check_ported` refuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.common import LayerSpec, ModelConfig, layer_specs
from repro_torch.models.layers import (
    cross_entropy_loss,
    embed,
    embedding_init,
    mlp,
    mlp_init,
    norm_apply,
    norm_init,
    unembed,
)

__all__ = [
    "Structure",
    "structure",
    "init_layer",
    "apply_layer_train",
    "init_decoder",
    "decoder_forward",
    "decoder_loss",
    "init_layer_cache",
    "init_decode_cache",
    "apply_layer_prefill",
    "apply_layer_decode",
    "prefill_with_cache",
    "decode_step",
    "MOE_AUX_WEIGHT",
    "MOE_Z_WEIGHT",
]

MOE_AUX_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-4


@dataclasses.dataclass(frozen=True)
class Structure:
    pattern: tuple[LayerSpec, ...]  # repeating block
    n_blocks: int

    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.n_blocks


def structure(cfg: ModelConfig) -> Structure:
    """The shortest repeating block of layer kinds and windows, as the reference stacks it."""
    specs = layer_specs(cfg)
    sigs = [(s.kind, s.window) for s in specs]
    n = len(specs)
    for p in range(1, n + 1):
        if n % p == 0 and all(sigs[i] == sigs[i % p] for i in range(n)):
            return Structure(tuple(specs[:p]), n // p)
    return Structure(tuple(specs), 1)


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec):
    p: dict[str, Any] = {"ln1": norm_init(cfg.d_model, cfg, gen.device)}
    if spec.kind == "attn":
        p["attn"] = attn.attn_init(gen, cfg)
    else:
        p["mamba"] = mamba_mod.mamba_init(gen, cfg)
    if cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg.d_model, cfg, gen.device)
        p["mlp"] = mlp_init(gen, cfg)
    return p


def _ffn(p, x, cfg: ModelConfig):
    if "mlp" in p:
        return mlp(p["mlp"], norm_apply(p["ln2"], x, cfg), cfg)
    return torch.zeros_like(x)


def apply_layer_train(p, x, cfg: ModelConfig, spec: LayerSpec, *, plain_attention: bool = False):
    """Full-sequence training forward of one layer.  Returns (x, aux), aux
    the MoE load-balance and router-z terms (zeros: no ported layer routes).
    ``plain_attention`` is :func:`attn.attn_train`'s on-card comparison flag."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(p["ln1"], x, cfg)
    if spec.kind == "attn":
        h = attn.attn_train(p["attn"], h, cfg, window=spec.window, plain_attention=plain_attention)
    else:
        h = mamba_mod.mamba_train(p["mamba"], h, cfg)
    x = x + h
    return x + _ffn(p, x, cfg), (zero, zero)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int, device=None):
    if spec.kind == "attn":
        return {"kv": attn.init_kv_cache(cfg, batch, max_len, window=spec.window, device=device)}
    return {"ssm": mamba_mod.init_ssm_cache(cfg, batch, device=device)}


def apply_layer_prefill(p, x, cache, cfg: ModelConfig, spec: LayerSpec, *, plain_attention: bool = False):
    """Full-sequence layer forward that also fills the layer's decode cache."""
    if spec.kind == "attn":
        h = norm_apply(p["ln1"], x, cfg)
        h, _ = attn.attn_prefill(
            p["attn"], h, cache["kv"], cfg, window=spec.window, plain_attention=plain_attention
        )
    else:
        # the norm a token at a time too: on the card a row reduction over
        # [B, T, d] may sum in another order than over decode's [B, 1, d],
        # and the prefill must leave the state token stepping leaves, bitwise
        h = torch.cat([norm_apply(p["ln1"], x[:, t : t + 1], cfg) for t in range(x.shape[1])], dim=1)
        h, _ = mamba_mod.mamba_prefill(p["mamba"], h, cache["ssm"], cfg)
    x = x + h
    return x + _ffn(p, x, cfg), cache


def apply_layer_decode(p, x, cache, index, cfg: ModelConfig, spec: LayerSpec):
    h = norm_apply(p["ln1"], x, cfg)
    if spec.kind == "attn":
        h, _ = attn.attn_decode(p["attn"], h, cache["kv"], index, cfg, window=spec.window)
    else:
        h, _ = mamba_mod.mamba_decode(p["mamba"], h, cache["ssm"], cfg)
    x = x + h
    return x + _ffn(p, x, cfg), cache


# ---------------------------------------------------------------------------
# Decoder-only model
# ---------------------------------------------------------------------------


def init_decoder(gen: torch.Generator, cfg: ModelConfig):
    params: dict[str, Any] = {"embed": embedding_init(gen, cfg)}
    params["layers"] = [init_layer(gen, cfg, spec) for spec in layer_specs(cfg)]
    params["final_norm"] = norm_init(cfg.d_model, cfg, gen.device)
    return params


def decoder_forward(params, cfg: ModelConfig, tokens):
    """Full-sequence forward.  tokens [B, T] -> (logits [B, T, V], aux metrics)."""
    x = embed(params["embed"], tokens, cfg)
    aux_lb = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_z = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        x, (lb, z) = apply_layer_train(p, x, cfg, spec)
        aux_lb, aux_z = aux_lb + lb, aux_z + z
    x = norm_apply(params["final_norm"], x, cfg)
    logits = unembed(params["embed"], x, cfg)
    return logits, {"moe_load_balance": aux_lb, "moe_router_z": aux_z}


def decoder_loss(params, cfg: ModelConfig, tokens, labels):
    """(total loss, metrics): mean token cross-entropy plus the weighted MoE
    terms; metrics ``ce_loss``, ``moe_load_balance``, ``moe_router_z``."""
    logits, aux = decoder_forward(params, cfg, tokens)
    loss = cross_entropy_loss(logits, labels)
    total = loss + MOE_AUX_WEIGHT * aux["moe_load_balance"] + MOE_Z_WEIGHT * aux["moe_router_z"]
    return total, {"ce_loss": loss, **aux}


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return {
        "layers": [
            init_layer_cache(cfg, spec, batch, max_len, device) for spec in layer_specs(cfg)
        ]
    }


def prefill_with_cache(params, cfg: ModelConfig, cache, tokens, *, plain_attention: bool = False):
    """Fused serving prefill: one forward pass over the whole prompt fills
    every layer's decode cache (in place) and returns the last position's
    logits.  tokens [B, T].  Returns (logits [B, 1, V], cache); the next
    :func:`decode_step` runs at ``index = T``."""
    x = embed(params["embed"], tokens, cfg)
    for p, spec, c in zip(params["layers"], layer_specs(cfg), cache["layers"]):
        x, _ = apply_layer_prefill(p, x, c, cfg, spec, plain_attention=plain_attention)
    x = norm_apply(params["final_norm"], x[:, -1:, :], cfg)
    return unembed(params["embed"], x, cfg), cache


def decode_step(params, cfg: ModelConfig, cache, index, tokens):
    """One-token decode.  tokens [B, 1]; ``index`` [B] per-row positions (or
    one int).  Returns (logits [B, 1, V], cache), the cache updated in place."""
    x = embed(params["embed"], tokens, cfg)
    for p, spec, c in zip(params["layers"], layer_specs(cfg), cache["layers"]):
        x, _ = apply_layer_decode(p, x, c, index, cfg, spec)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache
