"""Stage partitioning for pipeline parallelism.

Port of ``repro/pipeline/stage.py``.  A :class:`StagedModel` cuts a
decoder-only config (dense, MoE, SSM, hybrid or vision-language, without
irregular prefix layers; an encoder-decoder is refused, as in the
reference) into ``num_stages`` contiguous stages of equal layer count.  A
stage runs over tokens with 1-D positions, as the reference's stage body
does for every family.  Every stage holds the same parameter structure: its layers, and the
embedding and final norm, which are present on every stage but used only by
the first (``embed_tokens``) and the last (``head_loss``; the unembedding
is tied).  Their copies elsewhere get zero gradient, and the engine's
:func:`repro_torch.pipeline.engine.reduce_replicated` sums the copies'
gradients so that they stay equal.

The reference stacks every leaf over the stages and the layer repeats
(``[S, reps, ...]``) for ``shard_map`` and ``lax.scan``.  The port keeps a
list of ``num_stages`` trees, one per (virtual) stage::

    {"embed": {"table": ...}, "final_norm": {...}, "layers": [layer, ...]}

with ``layers`` in model order within the stage (``reps`` repeats of the
layer pattern).  ``repro_torch.bridge.staged_params_from_repro`` converts
the reference's stacked tree; parity runs carry its weights across.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import LayerSpec, ModelConfig
from repro_torch.models.layers import (
    cross_entropy_loss,
    embed,
    embedding_init,
    norm_apply,
    norm_init,
    unembed,
)
from repro_torch.tree import tree_map

__all__ = ["StagedModel"]


@dataclasses.dataclass(frozen=True)
class StagedModel:
    cfg: ModelConfig
    num_stages: int
    pattern: tuple[LayerSpec, ...]
    reps: int  # pattern repetitions per stage
    #: attention through its plain training version instead of the kernel
    #: (the on-card comparison; training never sets it)
    plain_attention: bool = False

    @classmethod
    def build(cls, cfg: ModelConfig, num_stages: int, plain_attention: bool = False) -> "StagedModel":
        if cfg.family == "encdec":
            raise ValueError("pipeline engine covers decoder-only families")
        st = tf.structure(cfg)
        if st.prefix:
            raise ValueError(
                f"{cfg.name}: irregular prefix layers not supported by the "
                "stage partitioner (fold into cfg or use the SPMD path)"
            )
        L = cfg.num_layers
        if L % num_stages:
            raise ValueError(f"layers {L} % stages {num_stages} != 0")
        per_stage = L // num_stages
        if per_stage % len(st.pattern):
            raise ValueError(
                f"layers/stage {per_stage} must tile the layer pattern "
                f"(len {len(st.pattern)})"
            )
        return cls(cfg, num_stages, st.pattern, per_stage // len(st.pattern), plain_attention)

    @property
    def layers_per_stage(self) -> int:
        return self.reps * len(self.pattern)

    def layer_specs(self) -> list[LayerSpec]:
        """The specs of one stage's layers, in order."""
        return list(self.pattern) * self.reps

    # -- params ---------------------------------------------------------------

    def init_all_stages(self, gen: torch.Generator) -> list[dict]:
        """Parameters of every stage, drawn from ``gen`` on its device in
        ``cfg.param_dtype``.  The embedding and final norm are drawn once and
        copied to every stage, as the reference draws them from one key."""
        return self.init_stages(gen, range(self.num_stages))

    def init_stages(self, gen: torch.Generator, owned) -> list[dict]:
        """The trees of the virtual stages ``owned``, in that order.  The
        draws are always the whole sequence (embedding, final norm, then
        every stage's layers); the layers of a stage not in ``owned`` are
        dropped as soon as they are drawn, so a rank never holds the whole
        model and every rank starts from the same weights."""
        cfg = self.cfg
        owned = [int(j) for j in owned]
        embed_p = embedding_init(gen, cfg)
        final_norm = norm_init(cfg.d_model, cfg, gen.device)
        layers = {}
        for j in range(self.num_stages):
            drawn = [tf.init_layer(gen, cfg, spec) for spec in self.layer_specs()]
            if j in owned:
                layers[j] = drawn
            del drawn
        return [
            {
                "embed": tree_map(torch.clone, embed_p),
                "final_norm": tree_map(torch.clone, final_norm),
                "layers": layers[j],
            }
            for j in owned
        ]

    # -- compute --------------------------------------------------------------

    def stage_hidden(self, params, x):
        """The stage body: hidden [b, T, d] -> hidden [b, T, d].  An MoE
        layer's aux losses are dropped, as the reference's stage body drops
        them."""
        for p, spec in zip(params["layers"], self.layer_specs()):
            x, _ = tf.apply_layer_train(p, x, self.cfg, spec, plain_attention=self.plain_attention)
        return x

    def embed_tokens(self, params, tokens):
        return embed(params["embed"], tokens, self.cfg)

    def head_loss(self, params, h, labels):
        """Last-stage epilogue: final norm + unembed + mean token CE."""
        h = norm_apply(params["final_norm"], h, self.cfg)
        return cross_entropy_loss(unembed(params["embed"], h, self.cfg), labels)

    def full_loss(self, all_params, tokens, labels):
        """The unpipelined forward over all stages: the numerics oracle the
        engine is held to."""
        x = self.embed_tokens(all_params[0], tokens)
        for p in all_params:
            x = self.stage_hidden(p, x)
        return self.head_loss(all_params[-1], x, labels)
