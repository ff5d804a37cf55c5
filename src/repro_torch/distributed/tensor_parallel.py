"""Tensor-parallel compute over the "model" axis: the products GSPMD derives
from ``repro``'s sharding rules, written out for one process a rank.

``repro`` pins each matrix's shard (:func:`~repro_torch.distributed.sharding._spec_for`)
and lets GSPMD split the products to follow them: a column-split matrix
yields the rank's slice of the output features, a row-split one a partial
sum that one all-reduce over "model" completes.  Here a
:class:`TensorParallel` does the same on each rank's shards, with no gather
over "model" of the leaves a product follows.  Each class of leaf, by its
path in the port's layout (``repro``'s rules, ``sharding.py``'s
``_COL_SPLIT``, ``_ROW_SPLIT`` and ``_EMBED``), and the way it is used:

* **Column products**: ``attn/wq``, ``attn/wk``, ``attn/wv``, ``mlp/gate``,
  ``mlp/up`` (and a shared expert's ``moe/shared/gate``, ``up``) and the
  cross attention's ``xattn/wq``, ``wk``, ``wv``, their
  output features over "model" (a bias split likewise).  The rank computes
  its own query heads and KV groups, or its slice of the MLP's inner width,
  on the whole hidden: :meth:`TensorParallel.enter` before them is the
  identity forward and sums the input's gradient over "model" backward.
* **Row products**: ``attn/wo``, ``mlp/down`` (``moe/shared/down``), ``xattn/wo``, their input
  features over "model".  The rank's partial sum goes through
  :meth:`TensorParallel.exit`, an all-reduce over "model" forward and the
  identity backward: one all-reduce per attention block and one per MLP
  block.
* **The embedding table and an untied head**, split over the vocabulary.
  The lookup is masked to the rank's rows of the table and all-reduced
  (:meth:`TensorParallel.embed`); logits are computed on the rank's vocab
  slice and all-gathered over "model" (:meth:`TensorParallel.unembed`; in
  training the gather's backward hands each rank its slice of the
  gradient, so the loss over the gathered logits is the unsplit one).
* **Heads that do not split whole.**  Where the "model" size divides
  ``K * hd`` but not ``K`` (K = 2 KV heads at tp 4), a shard of ``wk`` or
  ``wv`` is part of a head.  When the rank's query heads still fall in one
  KV group, those two leaves are gathered over "model" and the rank takes
  its group's columns (``"kv_gather"``: each rank's columns carry a share of
  the gradient, summed over "model" backward); when the query heads do not
  split whole either, the block's four leaves are gathered and every rank
  computes every head (``"gather"``).  No product runs on a split head
  (:func:`head_split`).
* **Expert parallelism** (:meth:`TensorParallel.moe`): an expert bank's E
  dim is over "model" (its d dim over the data axes, even without FSDP),
  so the rank computes its E/tp experts, the bank gathered over the data
  axes only.  Every rank along "model" routes all of its row group's tokens
  over all E experts (``moe.route``: C and ``keep`` are the whole
  layer's), keeps the entries routed to its own experts, and combines a
  partial [G, S, d]; the shared expert's row-product partial is added to it
  before the block's one all-reduce over "model" (``exit``), the input
  through ``enter`` first.  ``moe/router/w`` (d x E) is the one MoE leaf
  gathered over "model"; each rank's combine uses only its own experts'
  gates, so its gradient is summed over "model" (``"sum"``), and the
  load-balance and router z terms, which every rank of a column computes
  alike, carry 1/tp of their gradient there (:class:`_Share`) so that the
  sum counts them once.  Where E % tp != 0 the layer is gathered whole and
  every rank computes it (``"replicated"``).
* **Mamba2 by heads** (:meth:`TensorParallel.mamba_train`,
  :meth:`~TensorParallel.mamba_prefill`, :meth:`~TensorParallel.ssm_decode`):
  the rank owns heads ``[r H/tp, (r+1) H/tp)`` (:func:`ssm_heads`), its
  shard of the SSM state and those heads' ``d_in/tp`` rows of ``out_proj``.
  ``in_proj`` is a column product on the rank's contiguous shard of the
  ``[z | x | B | C | dt]`` columns, which is not aligned to heads, so its
  output is all-gathered over "model" (one all-gather; its backward
  reduce-scatters the gradient) and the rank takes its heads' z, x and dt
  columns and the whole B and C.  ``conv_w`` (K x conv_dim) is gathered over
  "model" and the rank uses its x channels and the B and C channels; the
  causal conv, ``softplus(dt)``, A, D and the SSD (K2 in training) run on
  its heads.  The gated rmsnorm needs the whole ``d_in``: one all-reduce of
  each row's fp32 sum of squares over "model" completes it (its backward
  is an all-reduce too: each rank's sum feeds its own heads).
  ``out_proj`` is a row product (``exit``).  ``conv_w``, ``conv_b``,
  ``dt_bias``, ``A_log``, ``D`` and ``norm_scale`` are used in part by each
  rank, so their gradients are summed over "model" (``"sum"``).  Where
  ``H % tp != 0`` (or ``in_proj``'s columns do not split) the layer's leaves
  are gathered over "model" and every rank computes every head, as
  :func:`head_split` does for attention heads.  The head-sliced forms
  themselves are ``models/mamba.py``'s (``heads`` and this class's hooks:
  :meth:`~TensorParallel.gather_cols`, :meth:`~TensorParallel.reduce_both`,
  :meth:`~TensorParallel.decode_row`, :meth:`~TensorParallel.write_window`,
  ``enter``, ``exit``); here only the collectives.
* **1-D leaves the rules replicate** (the norms, a row product's bias):
  used as held, no collective.

Decode with a KV cache split over "model" by sequence
(:func:`~repro_torch.distributed.sharding.cache_shardings`) runs the
flash-decode way (:meth:`TensorParallel.attn_decode`): the new token's q, k
and v are all-gathered over "model" in one buffer, the rank that owns the
slot writes k and v, each rank scores its own key range for every head
(``sdpa`` with its log-sum-exp), the partials are all-gathered over "model"
and each rank merges its own heads' by their log-sum-exps
(:func:`merge_partials`) for ``wo``: two all-gathers an attention layer.  A
cache split by KV heads instead (the length does not divide) holds the
rank's own groups, and the rank decodes its heads as one process does
(``attention.attn_decode``).  Mamba2's state stays split by heads: a decode
step all-gathers the rank's ``in_proj`` output row with its shard of the
conv window (channels over "model") in one buffer, steps its own heads'
state, and writes its shard of the window back.  The sharded prefill
(``mamba.mamba_prefill_heads``) runs ``in_proj``, the conv, the norm
and ``out_proj`` over the whole prompt at once (three collectives a layer)
and steps the recurrence token by token on the rank's heads, filling its
shard of a fresh cache; its attention (:meth:`TensorParallel.attn_prefill`)
writes the rank's shard of the KV cache.

:attr:`TensorParallel.counts` counts the collectives the products run
(``all_reduce``, ``all_gather``, ``reduce_scatter`` and their bytes) and
:attr:`TensorParallel.gathered` the leaf paths a serving ``use`` gathered
over "model" (the router, ``conv_w``, and the cases above that do not
split); :attr:`TensorParallel.routes` keeps each MoE call's ``idx`` and
``keep`` while ``keep_routes`` is set (every rank of a column must route
alike).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.distributed.sharding import spec_axes
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig, encoder_config
from repro_torch.models.layers import dense, embed, mlp, unembed

__all__ = [
    "MODEL",
    "HeadSplit",
    "head_split",
    "ssm_heads",
    "experts_of",
    "LeafUse",
    "leaf_use",
    "gather_spec",
    "merge_weight",
    "merge_partials",
    "TensorParallel",
    "DENSE_PARTS",
]

MODEL = "model"
#: path parts of the leaves a tensor-parallel product follows (the sharded
#: serving gathers none of these)
DENSE_PARTS = ("attn", "xattn", "mlp", "embed")


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How an attention block's heads fall on one rank: ``mode`` is
    ``"split"`` (whole query heads and KV groups a rank), ``"kv_gather"``
    (whole query heads, one KV group shared with other ranks) or
    ``"gather"`` (every head on every rank); ``cfg`` has the rank's head
    counts; ``q`` and ``kv`` are (first head, count) of its query and KV
    heads."""

    mode: str
    cfg: ModelConfig
    q: tuple[int, int]
    kv: tuple[int, int]


def head_split(cfg: ModelConfig, tp: int, rank: int) -> HeadSplit:
    """The rank's heads at "model" size ``tp`` (module docstring)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if H % tp == 0:
        hq, group = H // tp, H // K
        if K % tp == 0:
            kc = K // tp
            return HeadSplit("split", cfg.replace(num_heads=hq, num_kv_heads=kc, head_dim=hd),
                             (rank * hq, hq), (rank * kc, kc))
        if group % hq == 0:
            return HeadSplit("kv_gather", cfg.replace(num_heads=hq, num_kv_heads=1, head_dim=hd),
                             (rank * hq, hq), (rank * hq // group, 1))
    return HeadSplit("gather", cfg, (0, H), (0, K))


@dataclasses.dataclass(frozen=True)
class LeafUse:
    """How a leaf is used: gathered over "model" too (``model``), then
    narrowed to ``cols`` (start, length) of its last dim; ``grad`` says how
    its gradient reaches the rank's shard over "model": ``"local"`` (its own
    shard's), ``"replicated"`` (every rank's is the same: keep the rank's
    chunk) or ``"sum"`` (each rank's carries a share: summed)."""

    model: bool = False
    cols: tuple[int, int] | None = None
    grad: str = "local"


_LOCAL = LeafUse()
_REPLICATED = LeafUse(model=True, grad="replicated")


def ssm_heads(cfg: ModelConfig, tp: int, rank: int) -> tuple[int, int] | None:
    """(first, count) of the rank's Mamba2 heads at "model" size ``tp``, or
    None where the layer is gathered: one rank, ``H % tp != 0``, or
    ``in_proj``'s columns that do not split over "model"."""
    d_in, H, _, N, G = mamba_mod._dims(cfg)
    if tp > 1 and H % tp == 0 and (2 * d_in + 2 * G * N + H) % tp == 0:
        return rank * (H // tp), H // tp
    return None


def experts_of(cfg: ModelConfig, tp: int, rank: int) -> tuple[int, int] | None:
    """(first, count) of the rank's experts at "model" size ``tp``, or None
    where the MoE layer is gathered (one rank, or ``E % tp != 0``)."""
    E = cfg.num_experts
    if tp > 1 and E % tp == 0:
        return rank * (E // tp), E // tp
    return None


def leaf_use(path: str, spec, cfg: ModelConfig, tp: int, rank: int) -> LeafUse:
    """The :class:`LeafUse` of the leaf at ``path`` whose spec is ``spec``
    (the module docstring's classes); ``cfg`` is the model's (an encoder
    layer's heads are :func:`encoder_config`'s)."""
    parts = path.split("/")
    named = MODEL in {a for e in spec for a in spec_axes(e)}
    whole = _REPLICATED if named else _LOCAL
    if "moe" in parts:
        if experts_of(cfg, tp, rank) is None:
            return whole
        return LeafUse(model=named, grad="sum") if "router" in parts else _LOCAL
    if "mamba" in parts:
        if ssm_heads(cfg, tp, rank) is None:
            return whole
        if parts[-1] in ("in_proj", "out_proj"):
            return _LOCAL
        return LeafUse(model=named, grad="sum")  # conv_w gathered; the 1-D leaves sliced
    for block in ("attn", "xattn"):
        if block in parts:
            s = head_split(encoder_config(cfg) if parts[0] == "encoder" else cfg, tp, rank)
            if s.mode == "kv_gather" and parts[parts.index(block) + 1] in ("wk", "wv"):
                return LeafUse(model=named, cols=(s.kv[0] * cfg.hd, cfg.hd), grad="sum")
            return whole if s.mode == "gather" else _LOCAL
    if named and parts[0] == "embed" and spec_axes(spec[0 if parts[-1] == "table" else -1]) != (MODEL,):
        return _REPLICATED  # a table split over d, not the vocabulary (V < d)
    return _LOCAL


def gather_spec(spec, use: LeafUse, data: bool):
    """The entries of ``spec`` a use gathers: its data axes when ``data``
    (the FSDP half), and "model" when the use takes the whole leaf."""
    def keep(entry):
        axes = spec_axes(entry)
        if MODEL in axes:
            return entry if use.model else None
        return entry if data else None

    return P(*(keep(e) for e in spec))


def merge_weight(lse: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The weight [B, T, H] of the part whose log-sum-exp is ``lse`` among
    all parts' ``lses`` [n, B, T, H]: ``exp(lse - max) / sum exp(lses -
    max)``.  A part whose keys are all masked (its lse near -1e30) weighs 0."""
    m = lses.max(dim=0).values
    return torch.exp(lse - m) / torch.exp(lses - m).sum(dim=0)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over a whole key range from its parts' outputs ``outs``
    [n, B, T, H, hd] and log-sum-exps ``lses`` [n, B, T, H] (``sdpa``'s with
    ``return_lse``), summed in fp32 by :func:`merge_weight`, cast to
    ``outs``' type (:meth:`TensorParallel.attn_decode` merges the ranks'
    partials so)."""
    return sum(o.float() * merge_weight(lse, lses)[..., None] for o, lse in zip(outs, lses)).to(outs.dtype)


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over "model" backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _Exit(torch.autograd.Function):
    """All-reduce over "model" forward; identity backward."""

    @staticmethod
    def forward(ctx, y, tp):
        return tp.all_reduce(y.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    """The ranks' vocab slices concatenated forward; the rank's slice of
    the gradient backward (every rank's loss over them is the same)."""

    @staticmethod
    def forward(ctx, z, tp):
        ctx.tp, ctx.n = tp, z.shape[-1]
        return tp.all_gather(z, dim=z.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.rank * ctx.n, ctx.n).contiguous(), None


class _GatherCols(torch.autograd.Function):
    """The ranks' column shards of a product concatenated forward; backward,
    the rank's shard of the sum of every rank's gradient (each rank uses
    other columns of the whole): a reduce-scatter over "model"."""

    @staticmethod
    def forward(ctx, z, tp):
        ctx.tp = tp
        return tp.all_gather(z, dim=z.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter(g, g.ndim - 1), None


class _ReduceBoth(torch.autograd.Function):
    """All-reduce over "model" forward and backward: the sum feeds another
    part of the work on each rank (the gated norm's sum of squares)."""

    @staticmethod
    def forward(ctx, t, tp):
        ctx.tp = tp
        return tp.all_reduce(t.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone()), None


class _Share(torch.autograd.Function):
    """Identity forward; 1/tp of the gradient backward: a term every rank of
    a column computes alike, whose gradient is summed over "model"."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class TensorParallel:
    """One rank's tensor-parallel products over "model" on ``mesh`` (a
    :func:`~repro_torch.launch.mesh.make_local_mesh` with its rank group;
    "model" of size 1 makes every collective a no-op).  ``kv_len`` is the
    decode cache's length (the sharded serve step's), against which
    :meth:`attn_decode` tells a cache split by sequence."""

    def __init__(self, mesh, kv_len: int | None = None):
        self.mesh, self.kv_len = mesh, kv_len
        self.size = mesh.shape.get(MODEL, 1)
        self.rank = mesh.coord(MODEL) if MODEL in mesh.axis_names else 0
        self.counts: collections.Counter = collections.Counter()
        self.gathered: set = set()
        self.keep_routes, self.routes = False, []
        self._heads: dict = {}

    # -- collectives ---------------------------------------------------------

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over "model"."""
        if self.size > 1:
            self.counts["all_reduce"] += 1
            self.counts["all_reduce_bytes"] += t.numel() * t.element_size()
            self.mesh.group.all_reduce_over(t, (MODEL,))
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in "model" order."""
        if self.size == 1:
            return t
        self.counts["all_gather"] += 1
        self.counts["all_gather_bytes"] += t.numel() * t.element_size() * self.size
        return self.mesh.group.all_gather_over(t, (MODEL,), dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's chunk along ``dim`` of the ranks' ``t`` summed over "model"."""
        if self.size == 1:
            return t
        self.counts["reduce_scatter"] += 1
        self.counts["reduce_scatter_bytes"] += t.numel() * t.element_size()
        return self.mesh.group.reduce_scatter_over(t, (MODEL,), dim=dim)

    def enter(self, x):
        return _Enter.apply(x, self) if self.size > 1 else x

    def exit(self, y):
        return _Exit.apply(y, self) if self.size > 1 else y

    # -- plans ------------------------------------------------------------------

    def heads(self, cfg: ModelConfig) -> HeadSplit:
        if cfg not in self._heads:
            self._heads[cfg] = head_split(cfg, self.size, self.rank)
        return self._heads[cfg]

    def attention(self, cfg: ModelConfig):
        """(the rank's attention config, enter, exit) of a block of ``cfg``:
        the identities where every rank computes every head."""
        s = self.heads(cfg)
        if s.mode == "gather" or self.size == 1:
            return cfg, _same, _same
        return s.cfg, self.enter, self.exit

    def mlp(self, p, d_ff: int):
        """(enter, exit) of a dense MLP ``p`` (as used) whose inner width
        ``d_ff`` is split over "model", else the identities."""
        if p["up"]["w"].shape[-1] < d_ff:
            return self.enter, self.exit
        return _same, _same

    # -- the vocabulary ----------------------------------------------------------

    def embed(self, p, tokens, cfg: ModelConfig):
        """The lookup in a vocab-split table: each rank's rows, masked, summed."""
        table = p["table"]
        n = table.shape[0]
        if n == cfg.vocab_size:
            return embed(p, tokens, cfg)
        local = tokens - self.rank * n
        inside = (local >= 0) & (local < n)
        x = table.to(cfg.dtype)[local.clamp(0, n - 1)]
        return self.exit(torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device)))

    def unembed(self, p, h, cfg: ModelConfig):
        """Logits over the whole vocabulary from the rank's slice of the head
        (or the tied table), all-gathered over "model"."""
        w = p["head"].shape[-1] if "head" in p else p["table"].shape[0]
        if w == cfg.vocab_size:
            return unembed(p, h, cfg)
        return _GatherVocab.apply(unembed(p, self.enter(h), cfg), self)

    # -- decode --------------------------------------------------------------------

    def _all_heads(self, s: HeadSplit, cfg: ModelConfig, q, k, v):
        """The new token's ``q`` (or None), ``k`` and ``v`` [B, 1, heads, hd]
        for every head, from each rank's heads: one all-gather over "model"
        of their concatenation."""
        ts = [t for t in (q, k, v) if t is not None]
        if s.mode == "gather" or self.size == 1:
            return (q, k, v)
        widths = [t.shape[2] for t in ts]
        parts = self.all_gather(torch.cat(ts, dim=2)[None], dim=0).split(widths, dim=3)  # [n, B, 1, width, hd]

        def join(t):  # the ranks' heads in "model" order
            n, B, T, h, hd = t.shape
            return t.permute(1, 2, 0, 3, 4).reshape(B, T, n * h, hd)

        *qs, k, v = parts
        if s.mode == "kv_gather":  # rank r holds group (r * hq) // (H / K): keep one rank a group
            k, v = (t[:: self.size // cfg.num_kv_heads] for t in (k, v))
        return (join(qs[0]) if qs else None, join(k), join(v))

    def attn_decode(self, p, x, cache, index, cfg: ModelConfig, window: int | None = None):
        """One-token attention of the rank's rows x [B, 1, d] against its
        shard of the layer's KV cache (updated in place): the module
        docstring's flash-decode where the sequence is split."""
        s = self.heads(cfg)
        ck, cv = cache["k"], cache["v"]
        L = min(self.kv_len, window) if window else self.kv_len
        Ll, Kc = ck.shape[1], ck.shape[2]
        if Kc != cfg.num_kv_heads:  # the KV heads split: the cache holds the rank's groups
            if (Kc, Ll) != (s.kv[1], L):
                raise ValueError(f"a cache of {Kc} KV heads does not hold this rank's {s.kv}")
            y = attn.attn_decode(p, x, cache, index, s.cfg, window=window)[0]
            return y if s.mode == "gather" else self.exit(y)
        B = x.shape[0]
        index = torch.as_tensor(index, dtype=torch.long, device=x.device).expand(B)
        q, k, v = attn.decode_qkv(p, x, index, s.cfg)
        split = Ll < L  # the sequence split: every head over the rank's slots, merged
        q_all, k, v = self._all_heads(s, cfg, q if split else None, k, v)
        lo = self.rank * Ll if split else 0
        slot = index % L
        rows = torch.arange(B, device=x.device)
        # every row writes at its slot clamped into the shard; a row whose
        # slot is another rank's writes back what is there (no value is read
        # to pick the rows, so shapes alone run it)
        mine = ((slot >= lo) & (slot < lo + Ll))[:, None, None]
        at = (slot - lo).clamp(0, Ll - 1)
        ck[rows, at] = torch.where(mine, k[:, 0].to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(mine, v[:, 0].to(cv.dtype), cv[rows, at])
        valid = (lo + torch.arange(Ll, device=x.device))[None, :] < torch.clamp(index + 1, max=L)[:, None]
        mask = valid[:, None, None, None, :]
        if split:
            out = self._merge(*attn.sdpa(q_all, ck, cv, mask, return_lse=True), s.q)
        else:
            out = attn.sdpa(q, ck.narrow(2, s.kv[0], s.kv[1]), cv.narrow(2, s.kv[0], s.kv[1]), mask)
        y = dense(p["wo"], out.reshape(B, 1, -1), cfg)
        return y if s.mode == "gather" else self.exit(y)

    def _merge(self, out, lse, heads: tuple[int, int]):
        """The attention of ``heads`` (first, count) over every rank's key
        range from each rank's partial ``out`` and ``lse`` for every head:
        one all-gather over "model" of both, merged by
        :func:`merge_partials`."""
        if self.size > 1:
            parts = self.all_gather(torch.cat([out.float(), lse[..., None]], dim=-1)[None], dim=0)
            parts = parts.narrow(3, *heads)
            return merge_partials(parts[..., :-1], parts[..., -1]).to(out.dtype)
        return out.narrow(2, *heads)

    def attn_prefill(self, p, x, cache, cfg: ModelConfig, window: int | None = None):
        """The prompt's causal attention x [B, T, d] (from position 0) on the
        rank's heads through K1; with ``cache`` (the rank's shard of the
        layer's KV cache, under ``kv_len``) its k and v written where decode
        reads them: every head's, all-gathered over "model" in one buffer,
        where the shard holds every head (the sequence split, or neither),
        the rank's own where the cache splits by KV heads."""
        s = self.heads(cfg)
        c, enter, exit_ = self.attention(cfg)
        q, k, v = attn._project_qkv(p, enter(x), c, torch.arange(x.shape[1], device=x.device)[None, :])
        out = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        y = exit_(dense(p["wo"], attn._merge_heads(out), cfg))
        if cache is None:
            return y
        ck, cv = cache["k"], cache["v"]
        L = min(self.kv_len, window) if window else self.kv_len
        Ll, Kc = ck.shape[1], ck.shape[2]
        lo = 0
        if Kc != cfg.num_kv_heads:
            if (Kc, Ll) != (s.kv[1], L):
                raise ValueError(f"a cache of {Kc} KV heads does not hold this rank's {s.kv}")
        else:
            _, k, v = self._all_heads(s, cfg, None, k, v)
            lo = self.rank * Ll if Ll < L else 0
        T = x.shape[1]
        t = np.arange(max(T - L, 0), T)  # the tokens a ring buffer keeps
        t = t[(t % L >= lo) & (t % L < lo + Ll)]  # those in this rank's slots
        src, dst = (torch.as_tensor(i, device=x.device) for i in (t, t % L - lo))
        ck[:, dst] = k[:, src].to(ck.dtype)
        cv[:, dst] = v[:, src].to(cv.dtype)
        return y

    # -- expert-parallel MoE -----------------------------------------------------------

    def moe(self, p, h, cfg: ModelConfig, grouped: bool, row_sum=None):
        """The MoE FFN of the normed hidden ``h`` [B, T, d] -> (y [B, T, d],
        aux): each batch row routed as its own group with ``grouped``
        (``row_sum`` then sums the expert counts over the rows' ranks), else
        the B * T tokens as one; on the rank's experts (the module
        docstring), or every expert where they do not split."""
        B, T, d = h.shape
        x = h if grouped else h.reshape(1, B * T, d)
        rs = row_sum if grouped else None
        ex = experts_of(cfg, self.size, self.rank)
        if ex is None:
            y, aux = moe_mod._moe(p, x, cfg, None, rs, on_route=self._route)
            return y.reshape(B, T, d), aux
        shared = p.get("shared")
        split = shared is not None and shared["up"]["w"].shape[-1] < cfg.expert_ff * cfg.n_shared_experts
        y, aux = moe_mod._moe(p, self.enter(x), cfg, None, rs, experts=ex, shared=split, on_route=self._route)
        y = self.exit(y)
        if shared is not None and not split:  # whole on every rank: after the sum, on the input as held
            y = y + mlp(shared, x, cfg)
        for k in ("load_balance", "router_z"):
            aux[k] = _Share.apply(aux[k], self.size)
        return y.reshape(B, T, d), aux

    def _route(self, r):
        if self.keep_routes:
            self.routes.append((r["idx"].detach().clone(), r["keep"].detach().clone()))

    # -- Mamba2 by heads ---------------------------------------------------------------
    # the hooks of models/mamba.py's head-sliced forms, then the layer's entry points

    def gather_cols(self, t):
        """``in_proj``'s column shards joined over "model"; backward, the
        rank's shard of the summed gradient (a reduce-scatter)."""
        return _GatherCols.apply(t, self)

    def reduce_both(self, t):
        """The gated norm's sum of squares summed over "model", forward and
        backward."""
        return _ReduceBoth.apply(t, self)

    def decode_row(self, part, window, conv_dim: int):
        """A decode step's whole ``in_proj`` row [B, proj] and conv window
        [B, K - 1, conv_dim] from the rank's column shard ``part`` and its
        shard of the window (channels over "model", or whole): one
        all-gather over "model" of both."""
        B = part.shape[0]
        K1, width = window.shape[1:]
        split = width < conv_dim
        both = self.all_gather(torch.cat([part, window.reshape(B, -1)] if split else [part], dim=-1)[None], 0)
        full = both[..., : part.shape[-1]].permute(1, 0, 2).reshape(B, -1)
        if split:
            window = both[..., part.shape[-1]:].reshape(self.size, B, K1, width).permute(1, 2, 0, 3)
            window = window.reshape(B, K1, self.size * width)
        return full, window

    def write_window(self, cache, window):
        """The rank's shard (channels over "model") of the whole conv window
        [B, K - 1, conv_dim] written to its cache."""
        t = cache["conv"]
        t.copy_(window.narrow(2, self.rank * t.shape[2], t.shape[2]) if t.shape[2] < window.shape[2] else window)

    def mamba_train(self, p, x, cfg: ModelConfig):
        """Mamba2's training forward x [B, T, d] -> [B, T, d] on the rank's
        heads, the chunked SSD through K2 (the module docstring)."""
        heads = ssm_heads(cfg, self.size, self.rank)
        return mamba_mod.mamba_train(p, x, cfg, heads, self if heads else None)

    def mamba_prefill(self, p, x, cache, cfg: ModelConfig):
        """Mamba2 over the prompt x [B, T, d] (from position 0) -> [B, T, d]
        on the rank's heads (``mamba.mamba_prefill_heads``), with ``cache``
        (the rank's shard of the layer's SSM cache) filled."""
        heads = ssm_heads(cfg, self.size, self.rank)
        if heads is None:
            if cache is None:  # a fresh state of every head
                return mamba_mod.mamba_prefill(p, x, mamba_mod.init_ssm_cache(cfg, x.shape[0], x.device), cfg)[0]
            return self._gathered_ssm(cache, cfg, lambda full: mamba_mod.mamba_prefill(p, x, full, cfg)[0])
        return mamba_mod.mamba_prefill_heads(p, x, cache, cfg, heads, self)

    def ssm_decode(self, p, x, cache, cfg: ModelConfig):
        """Mamba2's one-token step x [B, 1, d] on the rank's heads of the
        state (updated in place; :meth:`decode_row`, :meth:`write_window`).
        Where the heads do not split, the state and window are gathered (the
        module docstring)."""
        heads = ssm_heads(cfg, self.size, self.rank)
        if heads is None:
            return self._gathered_ssm(cache, cfg, lambda full: mamba_mod.mamba_decode(p, x, full, cfg)[0])
        return mamba_mod.mamba_decode(p, x, cache, cfg, heads, self)[0]

    def _gathered_ssm(self, cache, cfg: ModelConfig, fn):
        """``fn`` of the SSM state and conv window gathered over "model"; the
        rank's shard of each written back."""
        d_in, H, _, N, G = mamba_mod._dims(cfg)
        full = {}
        for name, dim, n in (("state", 1, H), ("conv", 2, d_in + 2 * G * N)):
            t = cache[name]
            full[name] = self.all_gather(t, dim) if t.shape[dim] < n else t
        y = fn(full)
        for name, dim in (("state", 1), ("conv", 2)):
            t = cache[name]
            if full[name] is not t:
                t.copy_(full[name].narrow(dim, self.rank * t.shape[dim], t.shape[dim]))
        return y


def _same(x):
    return x
