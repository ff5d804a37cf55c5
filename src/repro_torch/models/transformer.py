"""Model assembly: the decoder-only families (dense, MoE, SSM, the
Mamba2/attention hybrid and the vision-language decoder) and the
encoder-decoder: init, training forward and loss, prefill and decode.

Port of ``repro/models/transformer.py``.  The reference keeps a ``prefix``
of irregular leading layers (kimi-k2's first dense layer) unrolled and
stacks the repeating block of the rest into ``[n_blocks, ...]`` leaves for
``lax.scan``; PyTorch runs eagerly, so here the layers are a plain list in
model order (``params["layers"][i]`` is layer ``i``, the prefix first) and
the weight bridge unstacks.  :func:`structure` is kept because the bridge
maps the reference's ``prefix`` and ``blocks`` keys through it.

A hybrid layer holds the cache of its kind: ``kv`` for attention, ``ssm``
for Mamba2.  An MoE layer's FFN returns the router's load-balance and z
terms, which :func:`decoder_loss` weighs in as the reference does.  Decode
routes the batch as one MoE group (the reference's flat dispatch, as its
``api.decode_fn``) unless ``per_row_moe`` routes each row as its own group
(the serve engine's decode: the reference engine's per-slot ``vmap``).

A vision-language model is a decoder whose input is a sequence of
embeddings (``embeds`` [B, T, d], the stubbed frontend's output) with
three M-RoPE position streams (``mrope_positions`` [3, B, T]); it decodes
over tokens, as in the reference.

The encoder-decoder (the seamless-m4t backbone) keeps the reference's
layout, whose layers are not stacked: ``{"embed", "encoder": [layer, ...],
"enc_norm", "decoder": [layer, ...], "final_norm"}``, every decoder layer
with a cross attention (``xattn``) and its norm (``ln_x``).  The encoder
runs bidirectional attention over the frontend's frame embeddings
(``src_embeds`` [B, S, d]) with the dense config of
:func:`repro_torch.models.common.encoder_config`; the decoder runs causal
self-attention over the target tokens and cross attention over the
encoder's memory.  Decode takes the memory as an input each step (the
reference keeps it out of the cache, whose ``xkv`` stays ``None``; the
port's cache has no such entry).

**Training hooks of the distributed step** (:mod:`repro_torch.distributed.spmd`).
The training forwards take ``use`` and ``row_sum``.  ``use`` maps a part of
the parameter tree (the embedding table, the head, one layer, a norm) to
the tree the computation reads, just before that part runs: the
distributed step passes each rank's shards and gathers them there, so a
layer's full weights live only while it runs (and again in its
recompute).  ``row_sum`` is :func:`repro_torch.models.moe.moe_apply_grouped`'s
reduce over the ranks that hold the rest of a micro-batch.  With
``cfg.remat_blocks`` each layer runs under ``torch.utils.checkpoint``
(non-reentrant), the gather inside it; with ``cfg.act_sharding`` set the
MoE layers route each batch row as its own group, as the reference's do.
The reference's ``constrain_hidden`` anchor at each block boundary has no
counterpart: each rank's rows are its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import LayerSpec, ModelConfig, encoder_config, layer_specs
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
from repro_torch.tree import flatten

__all__ = [
    "Structure",
    "structure",
    "reference_layout",
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
    "init_encdec",
    "encdec_forward",
    "encdec_loss",
    "init_encdec_cache",
    "encdec_decode_step",
    "MOE_AUX_WEIGHT",
    "MOE_Z_WEIGHT",
]

MOE_AUX_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-4


@dataclasses.dataclass(frozen=True)
class Structure:
    prefix: tuple[LayerSpec, ...]  # irregular leading layers
    pattern: tuple[LayerSpec, ...]  # repeating block
    n_blocks: int

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.n_blocks


def _sig(s: LayerSpec) -> tuple:
    return (s.kind, s.moe, s.window)


def structure(cfg: ModelConfig) -> Structure:
    """The ``first_k_dense`` leading layers, then the shortest repeating
    block of layer kinds, FFN kinds and windows, as the reference stacks them."""
    specs = layer_specs(cfg)
    k = cfg.first_k_dense
    body = specs[k:]
    sigs = [_sig(s) for s in body]
    n = len(body)
    for p in range(1, n + 1):
        if n % p == 0 and all(sigs[i] == sigs[i % p] for i in range(n)):
            return Structure(tuple(specs[:k]), tuple(body[:p]), n // p)
    return Structure(tuple(specs[:k]), tuple(body), 1)


def reference_layout(cfg: ModelConfig, params) -> list:
    """How the reference lays out this model's leaves, for an optimizer that
    reads ranks or takes statistics over whole leaves (Adafactor; AdamW's
    decay rule): a list of ``(name, paths, stacked)``.  A prefix layer's
    leaf, the embedding and the final norm are their own unstacked groups;
    layer ``j`` of the pattern in every block is one group, stacked in
    block order.  ``name`` is the reference's path (``prefix/0/ln1/scale``,
    ``blocks/1/moe/experts/gate``, ``embed/table``), ``paths`` the port's
    (:func:`repro_torch.tree.flatten` of ``params``).  An encoder-decoder's
    layers are unstacked lists in the reference too (``encoder/<i>/...``,
    ``decoder/<i>/...``), so each of their leaves is its own group under
    its own path, in the order the reference flattens them (dict keys
    sorted, list entries in order)."""
    st = structure(cfg)
    groups: dict[str, tuple[list, bool]] = {}
    for key in flatten(params):
        parts = key.split("/")
        if parts[0] != "layers":
            groups[key] = ([key], False)
            continue
        i, rest = int(parts[1]), "/".join(parts[2:])
        if i < len(st.prefix):
            groups[f"prefix/{i}/{rest}"] = ([key], False)
        else:
            name = f"blocks/{(i - len(st.prefix)) % len(st.pattern)}/{rest}"
            groups.setdefault(name, ([], True))[0].append(key)
    out = [(name, paths, stacked) for name, (paths, stacked) in groups.items()]
    if cfg.family == "encdec":
        out.sort(key=lambda g: [(0, int(p)) if p.isdigit() else (1, p) for p in g[0].split("/")])
    return out


# ---------------------------------------------------------------------------
# One layer
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec, finish=None, cross: bool = False):
    """One layer's parameters; ``finish`` maps each expert bank of an MoE
    layer as soon as it is drawn (:func:`moe_mod.moe_init`); ``cross`` adds
    a cross attention and its norm (an encoder-decoder's decoder layer)."""
    p: dict[str, Any] = {"ln1": norm_init(cfg.d_model, cfg, gen.device)}
    if spec.kind == "attn":
        p["attn"] = attn.attn_init(gen, cfg)
    else:
        p["mamba"] = mamba_mod.mamba_init(gen, cfg)
    if cross:
        p["ln_x"] = norm_init(cfg.d_model, cfg, gen.device)
        p["xattn"] = attn.cross_attn_init(gen, cfg)
    if spec.moe:
        p["ln2"] = norm_init(cfg.d_model, cfg, gen.device)
        p["moe"] = moe_mod.moe_init(gen, cfg, finish)
    elif cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg.d_model, cfg, gen.device)
        p["mlp"] = mlp_init(gen, cfg)
    return p


def _ffn(p, x, cfg: ModelConfig, spec: LayerSpec, per_row_moe: bool = False, row_sum=None):
    """The FFN sublayer: (delta, (load_balance, router_z)), the terms zero
    for a dense FFN.  An MoE FFN routes the [B, T] tokens as one group, or
    with ``per_row_moe`` or under ``cfg.act_sharding`` each batch row as its
    own group (``row_sum``: the module docstring)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe:
        h = norm_apply(p["ln2"], x, cfg)
        if per_row_moe or cfg.act_sharding is not None:
            y, aux = moe_mod.moe_apply_grouped(p["moe"], h, cfg, row_sum=row_sum)
        else:
            B, T, d = h.shape
            y, aux = moe_mod.moe_apply(p["moe"], h.reshape(B * T, d), cfg)
            y = y.reshape(B, T, d)
        return y, (aux["load_balance"], aux["router_z"])
    if "mlp" in p:
        return mlp(p["mlp"], norm_apply(p["ln2"], x, cfg), cfg), (zero, zero)
    return torch.zeros_like(x), (zero, zero)


def apply_layer_train(
    p, x, cfg: ModelConfig, spec: LayerSpec, *, causal: bool = True, memory=None,
    positions=None, mrope_positions=None, plain_attention: bool = False, row_sum=None,
):
    """Full-sequence training forward of one layer.  Returns (x, aux), aux
    the MoE load-balance and router-z terms (zeros for a dense FFN).  A
    layer with a cross attention attends to ``memory`` after its
    self-attention.  ``plain_attention`` is :func:`attn.attn_train`'s
    on-card comparison flag; ``row_sum`` the MoE layer's (module docstring)."""
    h = norm_apply(p["ln1"], x, cfg)
    if spec.kind == "attn":
        h = attn.attn_train(
            p["attn"], h, cfg, window=spec.window, causal=causal, positions=positions,
            mrope_positions=mrope_positions, plain_attention=plain_attention,
        )
    else:
        h = mamba_mod.mamba_train(p["mamba"], h, cfg)
    x = x + h
    if memory is not None and "xattn" in p:
        h = attn.cross_attn(p["xattn"], norm_apply(p["ln_x"], x, cfg), memory, cfg, plain_attention=plain_attention)
        x = x + h
    delta, aux = _ffn(p, x, cfg, spec, row_sum=row_sum)
    return x + delta, aux


def _whole(part):
    return part


def _train_layers(layers, specs, x, cfg: ModelConfig, use=None, **kw):
    """Every layer's training forward in order -> (x, load_balance sum,
    router_z sum); each layer's parameters through ``use`` as it runs, and
    under a checkpoint with ``cfg.remat_blocks`` (the module docstring)."""
    use = use or _whole
    aux_lb = torch.zeros((), dtype=torch.float32, device=x.device)
    aux_z = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(layers, specs):

        def run(x, p=p, spec=spec):
            return apply_layer_train(use(p), x, cfg, spec, **kw)

        x, (lb, z) = checkpoint(run, x, use_reentrant=False) if cfg.remat_blocks else run(x)
        aux_lb, aux_z = aux_lb + lb, aux_z + z
    return x, aux_lb, aux_z


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
    delta, _ = _ffn(p, x, cfg, spec)
    return x + delta, cache


def apply_layer_decode(
    p, x, cache, index, cfg: ModelConfig, spec: LayerSpec, per_row_moe: bool = False, *, memory=None,
):
    h = norm_apply(p["ln1"], x, cfg)
    if spec.kind == "attn":
        h, _ = attn.attn_decode(p["attn"], h, cache["kv"], index, cfg, window=spec.window)
    else:
        h, _ = mamba_mod.mamba_decode(p["mamba"], h, cache["ssm"], cfg)
    x = x + h
    if memory is not None and "xattn" in p:
        x = x + attn.cross_attn_decode(p["xattn"], norm_apply(p["ln_x"], x, cfg), memory, cfg)
    delta, _ = _ffn(p, x, cfg, spec, per_row_moe)
    return x + delta, cache


# ---------------------------------------------------------------------------
# Decoder-only model
# ---------------------------------------------------------------------------


def init_decoder(gen: torch.Generator, cfg: ModelConfig, finish=None):
    """The decoder's parameters, drawn from ``gen`` in order: the embedding,
    the layers, the final norm.  ``finish`` (default: none) maps each of
    those parts as soon as it is drawn, before the next is, and each expert
    bank of an MoE layer as soon as it is drawn, so that a cast holds one
    part (or one bank) at a time in ``param_dtype``."""
    finish = finish or (lambda part: part)
    params: dict[str, Any] = {"embed": finish(embedding_init(gen, cfg))}
    params["layers"] = [finish(init_layer(gen, cfg, spec, finish)) for spec in layer_specs(cfg)]
    params["final_norm"] = finish(norm_init(cfg.d_model, cfg, gen.device))
    return params


def _hidden_from_inputs(params, cfg: ModelConfig, tokens, embeds, use=None):
    if embeds is not None:
        return embeds.to(cfg.dtype)
    return embed((use or _whole)({"table": params["embed"]["table"]}), tokens, cfg)


def _head(params, cfg: ModelConfig, x, aux_lb, aux_z, last_only: bool, use=None):
    use = use or _whole
    if last_only:
        x = x[:, -1:, :]
    x = norm_apply(use(params["final_norm"]), x, cfg)
    out = "head" if "head" in params["embed"] else "table"
    logits = unembed(use({out: params["embed"][out]}), x, cfg)
    return logits, {"moe_load_balance": aux_lb, "moe_router_z": aux_z}


def decoder_forward(
    params, cfg: ModelConfig, tokens=None, embeds=None, *, mrope_positions=None,
    last_only: bool = False, plain_attention: bool = False, use=None, row_sum=None,
):
    """Full-sequence forward over tokens [B, T] or embeddings [B, T, d]
    (with ``mrope_positions`` [3, B, T] for an M-RoPE config) -> (logits
    [B, T, V], aux metrics).  ``last_only`` unembeds the last position
    alone (logits [B, 1, V]), the prefill's contract; ``use`` and
    ``row_sum`` are the distributed step's (module docstring)."""
    x = _hidden_from_inputs(params, cfg, tokens, embeds, use)
    x, aux_lb, aux_z = _train_layers(
        params["layers"], layer_specs(cfg), x, cfg, use, mrope_positions=mrope_positions,
        plain_attention=plain_attention, row_sum=row_sum,
    )
    return _head(params, cfg, x, aux_lb, aux_z, last_only, use)


def _loss(logits, aux, labels):
    loss = cross_entropy_loss(logits, labels)
    total = loss + MOE_AUX_WEIGHT * aux["moe_load_balance"] + MOE_Z_WEIGHT * aux["moe_router_z"]
    return total, {"ce_loss": loss, **aux}


def decoder_loss(
    params, cfg: ModelConfig, tokens=None, labels=None, embeds=None, *, mrope_positions=None, use=None, row_sum=None,
):
    """(total loss, metrics): mean token cross-entropy plus the weighted MoE
    terms; metrics ``ce_loss``, ``moe_load_balance``, ``moe_router_z``."""
    logits, aux = decoder_forward(params, cfg, tokens, embeds, mrope_positions=mrope_positions, use=use, row_sum=row_sum)
    return _loss(logits, aux, labels)


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


def decode_step(params, cfg: ModelConfig, cache, index, tokens, *, per_row_moe: bool = False):
    """One-token decode.  tokens [B, 1]; ``index`` [B] per-row positions (or
    one int).  MoE layers route the B tokens as one group, or with
    ``per_row_moe`` each row as its own.  Returns (logits [B, 1, V], cache),
    the cache updated in place."""
    x = embed(params["embed"], tokens, cfg)
    for p, spec, c in zip(params["layers"], layer_specs(cfg), cache["layers"]):
        x, _ = apply_layer_decode(p, x, c, index, cfg, spec, per_row_moe)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t backbone)
# ---------------------------------------------------------------------------


def init_encdec(gen: torch.Generator, cfg: ModelConfig, finish=None):
    """The encoder-decoder's parameters, drawn from ``gen`` in order: the
    embedding, the encoder layers, the encoder's final norm, the decoder
    layers (each with its cross attention), the final norm; ``finish`` as
    :func:`init_decoder`'s."""
    finish = finish or (lambda part: part)
    enc = encoder_config(cfg)
    params: dict[str, Any] = {"embed": finish(embedding_init(gen, cfg))}
    params["encoder"] = [finish(init_layer(gen, enc, s)) for s in layer_specs(enc, cfg.encoder_layers)]
    params["enc_norm"] = finish(norm_init(cfg.d_model, cfg, gen.device))
    params["decoder"] = [finish(init_layer(gen, cfg, s, cross=True)) for s in layer_specs(cfg)]
    params["final_norm"] = finish(norm_init(cfg.d_model, cfg, gen.device))
    return params


def _encode(params, cfg: ModelConfig, src_embeds, plain_attention: bool = False, use=None):
    """The encoder's memory [B, S, d] from the frontend's frame embeddings:
    bidirectional layers, then the encoder's final norm."""
    enc = encoder_config(cfg)
    x, _, _ = _train_layers(
        params["encoder"], layer_specs(enc, cfg.encoder_layers), src_embeds.to(cfg.dtype), enc, use,
        causal=False, plain_attention=plain_attention,
    )
    return norm_apply((use or _whole)(params["enc_norm"]), x, cfg)


def encdec_forward(
    params, cfg: ModelConfig, src_embeds, tgt_tokens, last_only: bool = False, plain_attention: bool = False,
    use=None, row_sum=None,
):
    """(logits [B, T, V], aux) of the target tokens [B, T] over the source
    frames [B, S, d] (the modality frontend's output)."""
    memory = _encode(params, cfg, src_embeds, plain_attention, use)
    x = _hidden_from_inputs(params, cfg, tgt_tokens, None, use)
    x, aux_lb, aux_z = _train_layers(
        params["decoder"], layer_specs(cfg), x, cfg, use, memory=memory, plain_attention=plain_attention,
        row_sum=row_sum,
    )
    return _head(params, cfg, x, aux_lb, aux_z, last_only, use)


def encdec_loss(params, cfg: ModelConfig, src_embeds, tgt_tokens, labels, *, use=None, row_sum=None):
    logits, aux = encdec_forward(params, cfg, src_embeds, tgt_tokens, use=use, row_sum=row_sum)
    return _loss(logits, aux, labels)


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return {"decoder": [init_layer_cache(cfg, spec, batch, max_len, device) for spec in layer_specs(cfg)]}


def encdec_decode_step(params, cfg: ModelConfig, cache, index, tgt_tokens, memory):
    """One decoder token [B, 1] against the fixed encoder ``memory`` [B, S,
    d].  Returns (logits [B, 1, V], cache), the cache updated in place."""
    x = embed(params["embed"], tgt_tokens, cfg)
    for p, spec, c in zip(params["decoder"], layer_specs(cfg), cache["decoder"]):
        x, _ = apply_layer_decode(p, x, c, index, cfg, spec, memory=memory)
    x = norm_apply(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache
