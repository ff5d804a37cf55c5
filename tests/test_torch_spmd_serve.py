"""The sharded prefill and decode step (``repro_torch.distributed.spmd``'s
``make_spmd_prefill`` and ``make_spmd_serve_step``) and the tensor-parallel
products they run (``repro_torch.distributed.tensor_parallel``) against
``repro``.

Four gloo ranks on the CPU, spawned once for the module through
``ranks.spawn(..., axes={"data": 2, "model": 2})``, run every case (the
``PREFILL_CACHE`` cases also prefill into a fresh cache of their own); beside
them, ``repro``'s ``make_spmd_prefill`` and ``make_spmd_serve_step`` run the
same cases in a subprocess on a (2, 2) CPU mesh of four host devices, its
axes typed ``Auto`` and each call under ``jax.set_mesh``, as
``tests/test_torch_spmd.py`` runs the train step.  Both sides start from
``repro``'s init carried by the bridge, and the decode cache from ``repro``'s
own ``prefill_with_cache`` of the same prompt (unsharded, in this process),
cut to each rank's shard with ``local_shard``.  Each case: the prompt's
last-token logits, then 3 teacher-forced decode steps from index T (their
logits) and the cache gathered after them, all in fp32 at 1e-4 of the
largest entry (``tests/test_torch_spmd.py``'s limit).

Cases: qwen1.5-4b smoke (MHA, QKV bias); qwen2.5-14b smoke (GQA 8 over 2);
gemma3-12b smoke with a 94-token prompt and ``kv_len`` 128, so that the
64-slot ring buffer of its windowed layer, split 32 a rank over "model",
has wrapped and its decode slots 30, 31, 32 cross from the first rank's
range to the second's; jamba smoke at capacity factor E (Mamba2 by heads
over "model", its state split by heads; the MoE layer expert-parallel, two
experts a rank; ``repro``'s grouped dispatch loses a kept token where one is
dropped, ROADMAP.md queue 3); qwen2.5-14b at B 1 (the rows not split: the ranks along "data" repeat
them); qwen2.5-14b at ``kv_len`` 49, which "model" does not divide, so
``cache_shardings`` splits the KV heads instead of the sequence; and
qwen2.5-14b on a (1, 4) mesh (a second spawn, and ``repro`` on a (1, 4)
mesh), where the 2 KV heads do not split whole over "model" (``wk`` and
``wv`` gathered, each rank on its whole heads): at ``kv_len`` 48 the cache's
sequence splits, at 50 neither it nor the heads do (the cache whole on
every rank).

The unit tests need no ranks: the log-sum-exp merge of split key ranges
against ``sdpa`` over the whole range; a column product then a row product
against ``dense`` on the full leaves; the vocab-split lookup and logits;
and a head split that is not whole (qwen2.5 smoke's 2 KV heads at tp 4),
which gathers ``wk`` and ``wv`` and computes on whole heads.  There each
"rank" runs with a stand-in group whose all-reduce and all-gather return
the rank's own piece, and the test sums or joins the pieces.

The whole file ran in 59 s alone on this sandbox (one pytest process) and in 96 s beside the
rest of the suite (``-n 6 --dist loadfile``).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs import get_arch as jax_get_arch
from repro.models import api as jax_api
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import rank_checks
from repro_torch.distributed.sharding import local_shard, param_pspecs
from repro_torch.distributed.tensor_parallel import (
    DENSE_PARTS,
    TensorParallel,
    head_split,
    leaf_use,
    merge_partials,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn
from repro_torch.models import api
from repro_torch.models.common import layer_specs
from repro_torch.models.layers import dense, embed, unembed
from repro_torch.pipeline import ranks
from repro_torch.tree import flatten

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-4
STEPS = 3

#: (id, arch, B, T, kv_len, config changes)
CASES = [
    ("qwen1.5-mha-bias", "qwen1.5-4b", 4, 24, 48, {}),
    ("qwen2.5-gqa", "qwen2.5-14b", 4, 24, 48, {}),
    ("gemma3-ring", "gemma3-12b", 4, 94, 128, {}),
    ("jamba-hybrid", "jamba-v0.1-52b", 4, 24, 48, {"capacity_factor": "E"}),
    ("qwen2.5-b1", "qwen2.5-14b", 1, 24, 48, {}),
    ("qwen2.5-kv-heads", "qwen2.5-14b", 4, 24, 49, {}),
    ("qwen2.5-tp4", "qwen2.5-14b", 4, 24, 48, {}),
    ("qwen2.5-tp4-kv-whole", "qwen2.5-14b", 4, 24, 50, {}),
]
#: cases on another ("data", "model") mesh than (2, 2): K = 2 KV heads at tp 4
MESH = {"qwen2.5-tp4": (1, 4), "qwen2.5-tp4-kv-whole": (1, 4)}
#: cases whose ranks also run the prefill into a fresh cache of their own:
#: a windowed layer's ring buffer that wraps on a sequence split, and a
#: cache split by KV heads
PREFILL_CACHE = ("gemma3-ring", "qwen2.5-kv-heads")
IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work (the suite's other
    workers share the CPU).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _changes(arch, changes):
    cfg = get_arch(arch).smoke
    return {k: float(cfg.num_experts) if v == "E" else v for k, v in changes.items()}


def _cfgs(arch, changes):
    kw = _changes(arch, changes)
    return (jax_get_arch(arch).smoke.replace(dtype=jnp.float32, **kw),
            get_arch(arch).smoke.replace(dtype=torch.float32, **kw))


@functools.lru_cache
def _inputs(cid):
    """(repro's flat init, the prompt [B, T], the decode tokens [STEPS, B,
    1], repro's flat cache after its prefill_with_cache of the prompt)."""
    _, arch, B, T, kv_len, changes = BY_ID[cid]
    jcfg, cfg = _cfgs(arch, changes)
    jparams = jax_api.init_params(jax.random.PRNGKey(IDS.index(cid)), jcfg)
    rng = np.random.default_rng(IDS.index(cid))
    prompt = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    decode = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    cache = jax_api.init_cache(jcfg, B, kv_len)
    _, cache = jax_api.prefill_with_cache(jparams, jcfg, cache, {"tokens": jnp.asarray(prompt)})
    return _flat(jparams), prompt, decode, _flat(cache)


_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import _path_str
    from repro.configs import get_arch
    from repro.distributed.spmd import make_spmd_prefill, make_spmd_serve_step
    from repro.models import api

    inp, cases = np.load(sys.argv[1]), json.loads(sys.argv[3])

    def tree(prefix, shapes):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(inp[f"{prefix}/{_path_str(p)}"]) for p, _ in leaves])

    out = {}
    for cid, arch, B, T, kv_len, changes, steps, shape in cases:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        cfg = get_arch(arch).smoke.replace(dtype=jnp.float32, **changes)
        params = tree(f"{cid}/params", jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg)))
        cache = tree(f"{cid}/cache", api.cache_specs(cfg, B, kv_len))
        prompt, decode = inp[f"{cid}/prompt"], inp[f"{cid}/decode"]
        prefill, _ = make_spmd_prefill(cfg, mesh, {"tokens": jax.ShapeDtypeStruct(prompt.shape, jnp.int32)})
        step, _ = make_spmd_serve_step(cfg, mesh, {"tokens": jax.ShapeDtypeStruct(decode[0].shape, jnp.int32)},
                                       kv_len)
        with jax.set_mesh(mesh):
            out[f"{cid}/logits/0"] = np.asarray(prefill(params, {"tokens": prompt}))
            for i in range(steps):
                logits, cache = step(params, cache, jnp.int32(T + i), {"tokens": decode[i]})
                out[f"{cid}/logits/{i + 1}"] = np.asarray(logits)
        for p, v in jax.tree_util.tree_flatten_with_path(cache)[0]:
            out[f"{cid}/cache/{_path_str(p)}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def repro_serving(tmp_path_factory):
    """``repro``'s sharded prefill and decode on every case, started in a
    subprocess (it runs while the ranks do); calling the value waits and
    returns ``{case: (logits per call, flat cache after the steps)}``."""
    tmp = tmp_path_factory.mktemp("repro_spmd_serve")
    arrays, cases = {}, []
    for cid, arch, B, T, kv_len, changes in CASES:
        params, prompt, decode, cache = _inputs(cid)
        arrays.update({f"{cid}/params/{k}": v for k, v in params.items()})
        arrays.update({f"{cid}/cache/{k}": v for k, v in cache.items()})
        arrays[f"{cid}/prompt"], arrays[f"{cid}/decode"] = prompt, decode
        cases.append((cid, arch, B, T, kv_len, _changes(arch, changes), STEPS, MESH.get(cid, (2, 2))))
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPRO_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    @functools.lru_cache
    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(tmp / "out.npz")
        out = {}
        for cid in IDS:
            logits = [got[f"{cid}/logits/{i}"] for i in range(STEPS + 1)]
            cache = {k[len(cid) + 7:]: got[k] for k in got.files if k.startswith(f"{cid}/cache/")}
            out[cid] = logits, cache
        return out

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(repro_serving):
    """Every case on four gloo ranks: one spawn a mesh, (2, 2) and (1, 4)."""
    per_mesh = {}
    for cid, arch, B, T, kv_len, changes in CASES:
        params, prompt, decode, cache = _inputs(cid)
        per_mesh.setdefault(MESH.get(cid, (2, 2)), []).append((cid, dict(
            cfg=_cfgs(arch, changes)[1], params=params, prompt=prompt, decode=decode, kv_len=kv_len, cache=cache,
            prefill_cache=cid in PREFILL_CACHE)))
    out = {}
    for (data, model), items in per_mesh.items():
        per_rank = ranks.spawn(rank_checks.spmd_serve_cases, 4, args=([c for _, c in items],), device="cpu",
                               timeout=600, axes={"data": data, "model": model})
        out.update({cid: [r[i] for r in per_rank] for i, (cid, _) in enumerate(items)})
    return out


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.abs(want).max(initial=0.0), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("cid", IDS)
def test_prefill_and_decode_match_repro(world, repro_serving, cid):
    """The last-token logits, each decode step's logits and the cache
    gathered after the steps equal ``repro``'s sharded prefill and decode."""
    r0 = world[cid][0]
    want_logits, want_cache = repro_serving()[cid]
    assert len(r0["logits"]) == len(want_logits)
    for i, (got, want) in enumerate(zip(r0["logits"], want_logits)):
        _close(got, want, name=f"logits of call {i}")
    cfg = _cfgs(*BY_ID[cid][1::4])[1]
    want = {k: v.numpy() for k, v in flatten(bridge.cache_from_repro(want_cache, cfg, device="cpu")).items()}
    assert sorted(r0["cache"]) == sorted(want)
    for k, v in want.items():
        _close(r0["cache"][k], v, name=k)


@pytest.mark.parametrize("cid", PREFILL_CACHE)
def test_the_prefill_fills_its_cache_as_repro_prefill_with_cache_does(world, cid):
    """The cache the sharded prefill fills, gathered, equals ``repro``'s
    ``prefill_with_cache`` of the same prompt: gemma3's windowed layer keeps
    the last 64 of the 94 tokens in its ring buffer, split 32 slots a rank
    (each rank's slots shifted to its range), and qwen2.5 at ``kv_len`` 49
    writes each rank's own KV heads."""
    got = world[cid][0]["prefill_cache"]
    cfg = _cfgs(*BY_ID[cid][1::4])[1]
    want = {k: v.numpy() for k, v in flatten(bridge.cache_from_repro(_inputs(cid)[3], cfg, device="cpu")).items()}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        _close(got[k], v, name=k)


def _blocks(cfg) -> int:
    """The attention, dense-MLP and MoE blocks of ``cfg``: one all-reduce
    each (an MoE block's the routed and shared partials' one sum)."""
    specs = layer_specs(cfg)
    return sum(s.kind == "attn" for s in specs) + sum(s.moe or cfg.d_ff > 0 for s in specs)


def _mambas(cfg) -> int:
    """The Mamba2 layers of ``cfg``: each call runs one all-gather (the
    in_proj output, with a decode step's conv window) and two all-reduces
    (the gated norm's sum of squares, out_proj's row product) in each."""
    return sum(s.kind == "mamba" for s in layer_specs(cfg))


def _decode_gathers(cfg, kv_len: int, tp: int) -> int:
    """The all-gathers over "model" of a decode step's attention and Mamba2
    layers: two an attention layer whose cache the sequence splits (the new
    token's q, k and v in one buffer, then the partials and their
    log-sum-exps), none where its KV heads split, one where neither does
    (the new k and v of every head, written to every rank's whole cache);
    one a Mamba2 layer (its in_proj output row and conv window)."""
    n = _mambas(cfg)
    for s in layer_specs(cfg):
        L = min(kv_len, s.window) if s.window else kv_len
        if s.kind == "mamba":
            continue
        if L % tp == 0:
            n += 2
        elif cfg.num_kv_heads % tp:
            n += 1
    return n


@pytest.mark.parametrize("cid", IDS)
def test_no_rank_gathers_a_dense_leaf(world, cid):
    """No rank gathers an attention or MLP leaf, the embedding or the head
    over "model" during a call, but for ``wk`` and ``wv`` where a rank's
    shard of them is part of a head (the tp 4 cases); of the MoE and Mamba2
    layers only the router and ``conv_w`` (no expert bank, shared-expert
    leaf, ``in_proj``, ``out_proj`` or SSM state); every call runs one
    all-reduce per attention, dense-MLP and MoE block, one for the embedding
    and two per Mamba2 layer, and one all-gather for the logits and one per
    Mamba2 layer; a decode step the all-gathers of :func:`_decode_gathers`;
    every rank agrees on the counts, and the CPU launched no K1."""
    cfg = _cfgs(*BY_ID[cid][1::4])[1]
    kv_len = BY_ID[cid][4]
    tp = MESH.get(cid, (2, 2))[1]
    per_rank = world[cid]
    for r in per_rank:
        dense_leaves = [p for p in r["gathered"] if set(p.split("/")) & set(DENSE_PARTS)]
        if cfg.num_kv_heads % tp:
            assert dense_leaves and {p.split("/")[3] for p in dense_leaves} == {"wk", "wv"}, dense_leaves
        else:
            assert not dense_leaves, dense_leaves
        others = {"/".join(p.split("/")[2:]) for p in r["gathered"] if p not in dense_leaves}
        assert others <= {"moe/router/w", "mamba/conv_w"}, others
        assert all(c["all_reduce"] == 1 + _blocks(cfg) + 2 * _mambas(cfg) for c in r["counts"])
        assert r["counts"][0]["all_gather"] == 1 + _mambas(cfg)
        assert all(c["all_gather"] == 1 + _decode_gathers(cfg, kv_len, tp) for c in r["counts"][1:])
        assert r["k1"] == 0
    assert len({json.dumps(r["counts"], sort_keys=True) for r in per_rank}) == 1
    if cfg.family == "hybrid":
        assert {"/".join(p.split("/")[2:]) for p in per_rank[0]["gathered"]} == {"moe/router/w", "mamba/conv_w"}


def test_rows_and_cache_split_as_repro_lays_them_out(world):
    """The rows over "data" at B 4 and not split at B 1 (``act_anchor_for``);
    the KV cache's sequence over "model", or its heads where the length
    does not divide (``cache_shardings``)."""
    assert world["qwen2.5-gqa"][0]["row_axes"] == ("data",)
    assert world["qwen2.5-b1"][0]["row_axes"] == ()
    assert world["qwen2.5-gqa"][0]["cache_shapes"]["layers/0/kv/k"] == (2, 24, 2, 32)
    assert world["qwen2.5-b1"][0]["cache_shapes"]["layers/0/kv/k"] == (1, 24, 2, 32)
    assert world["qwen2.5-kv-heads"][0]["cache_shapes"]["layers/0/kv/k"] == (2, 49, 1, 32)
    assert world["gemma3-ring"][0]["cache_shapes"]["layers/0/kv/k"] == (2, 32, 2, 64)
    assert world["qwen2.5-tp4"][0]["cache_shapes"]["layers/0/kv/k"] == (4, 12, 2, 32)
    assert world["qwen2.5-tp4-kv-whole"][0]["cache_shapes"]["layers/0/kv/k"] == (4, 50, 2, 32)


# -- without ranks -------------------------------------------------------------------


@pytest.mark.parametrize("last", [0, 1, 3])
def test_lse_merge_of_split_key_ranges_equals_sdpa(last):
    """Four key ranges of 8 slots, the valid slots ending in range ``last``
    (the new token's: the first, a middle or the last): each range's
    ``sdpa`` with its log-sum-exp, merged, equals ``sdpa`` over all 32
    slots under the same mask (later ranges wholly masked weigh 0)."""
    g = torch.Generator().manual_seed(last)
    B, H, K, hd, L, n = 2, 8, 2, 16, 32, 4
    q = torch.randn(B, 1, H, hd, generator=g)
    k, v = torch.randn(B, L, K, hd, generator=g), torch.randn(B, L, K, hd, generator=g)
    index = torch.tensor([last * 8 + 3, last * 8 + 5])
    valid = torch.arange(L)[None, :] < (index + 1)[:, None]
    want = attn.sdpa(q, k, v, valid[:, None, None, None, :])
    parts = [attn.sdpa(q, k[:, r * 8:(r + 1) * 8], v[:, r * 8:(r + 1) * 8],
                       valid[:, None, None, None, r * 8:(r + 1) * 8], return_lse=True) for r in range(n)]
    got = merge_partials(torch.stack([o for o, _ in parts]), torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(attn.sdpa(q, k, v, valid[:, None, None, None, :], return_lse=True)[0], want,
                               rtol=0, atol=0)


class _Solo:
    """A stand-in rank group: a collective returns this rank's own piece
    (the test sums or joins the ranks' pieces itself)."""

    def all_reduce_over(self, t, axes):
        return t

    def all_gather_over(self, t, axes, dim=0):
        return t


def _rank_mesh(tp: int, r: int) -> Mesh:
    return Mesh(("data", "model"), (1, tp), (0, r), _Solo())


def _shards(tree, tp: int, r: int):
    """The rank's shards of ``tree`` under the serving rules at (1, tp)."""
    mesh = _rank_mesh(tp, r)
    specs = flatten(param_pspecs(tree, mesh, fsdp=False))
    out = {}
    for k, t in flatten(tree).items():
        out[k] = local_shard(t, specs[k], mesh)
    return out, specs


def test_column_then_row_product_equals_dense():
    """qwen1.5-4b smoke's attention projections (QKV bias) at tp 2: each
    rank's column product on its shard of ``wq`` and its bias, then its row
    product on its shard of ``wo``; the ranks' partial sums add up to
    ``dense`` on the full leaves.  The same for the SwiGLU MLP's gate, up and
    down."""
    cfg = get_arch("qwen1.5-4b").smoke.replace(dtype=torch.float32)
    params = api.init_params(cfg, 0, "cpu")
    layer = params["layers"][0]
    layer["attn"]["wq"]["b"] = torch.randn(cfg.q_dim, generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(2))
    want_attn = dense(layer["attn"]["wo"], dense(layer["attn"]["wq"], x, cfg), cfg)
    from repro_torch.models.layers import mlp

    want_mlp = mlp(layer["mlp"], x, cfg)
    got_attn = got_mlp = 0
    for r in range(2):
        shards, specs = _shards({"attn": layer["attn"], "mlp": layer["mlp"]}, 2, r)
        assert specs["attn/wq/b"] == ("model",) and specs["attn/wo/w"] == ("model", None)
        assert shards["attn/wq/w"].shape[1] == cfg.q_dim // 2 and shards["attn/wq/b"].shape == (cfg.q_dim // 2,)
        col = dense({"w": shards["attn/wq/w"], "b": shards["attn/wq/b"]}, x, cfg)
        got_attn = got_attn + dense({"w": shards["attn/wo/w"]}, col, cfg)
        got_mlp = got_mlp + mlp({k: {"w": shards[f"mlp/{k}/w"]} for k in ("gate", "up", "down")}, x, cfg)
    torch.testing.assert_close(got_attn, want_attn, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_mlp, want_mlp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tied", [False, True])
def test_vocab_split_lookup_and_logits_equal_the_full(tied):
    """qwen2.5-14b smoke's table and head (and, tied, gemma3's table) split
    over the vocabulary at tp 2: the ranks' masked lookups add up to the
    full lookup, and their logits slices joined in rank order are the full
    logits."""
    arch = "gemma3-12b" if tied else "qwen2.5-14b"
    cfg = get_arch(arch).smoke.replace(dtype=torch.float32)
    params = api.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 7), generator=torch.Generator().manual_seed(0))
    h = torch.randn(3, 1, cfg.d_model, generator=torch.Generator().manual_seed(1))
    looked, logits = 0, []
    for r in range(2):
        shards, _ = _shards({"embed": params["embed"]}, 2, r)
        tp = TensorParallel(_rank_mesh(2, r))
        part = {k.split("/")[1]: v for k, v in shards.items()}
        assert part["table"].shape[0] == cfg.vocab_size // 2
        looked = looked + tp.embed({"table": part["table"]}, tokens, cfg)
        logits.append(tp.unembed(part, h, cfg))
    torch.testing.assert_close(looked, embed(params["embed"], tokens, cfg), rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(logits, dim=-1), unembed(params["embed"], h, cfg), rtol=1e-5, atol=1e-5)


def test_a_head_split_that_is_not_whole_falls_back_to_a_gather():
    """qwen2.5-14b smoke (8 query heads over 2 KV heads of 32) at tp 4: a
    rank's shard of ``wk`` or ``wv`` is 16 columns, half a head, so both are
    gathered over "model" and each rank takes its group's 32 columns
    (``kv_gather``, the gradient summed back); each rank's attention then
    runs on whole heads and the ranks' partial sums equal the full
    attention.  qwen1.5 smoke's 4 heads at tp 8 do not split at all: every
    leaf of the block is gathered (``gather``)."""
    cfg = get_arch("qwen2.5-14b").smoke.replace(dtype=torch.float32)
    params = api.init_params(cfg, 0, "cpu")
    p = params["layers"][0]["attn"]
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want = attn.attn_train(p, x, cfg)
    got = 0
    for r in range(4):
        s = head_split(cfg, 4, r)
        assert s.mode == "kv_gather" and s.q == (2 * r, 2) and s.kv == (r // 2, 1)
        shards, specs = _shards({"layers": [{"attn": p}]}, 4, r)
        used = {}
        for k, t in shards.items():
            use = leaf_use(k, specs[k], cfg, 4, r)
            name = k.split("/")[3]
            if name in ("wk", "wv"):
                assert use.model and use.cols == ((r // 2) * cfg.hd, cfg.hd) and use.grad == "sum"
                assert t.shape[-1] == cfg.kv_dim // 4  # half a head: never computed on
                t = flatten({"layers": [{"attn": p}]})[k].narrow(-1, *use.cols)  # the gathered leaf's group
            else:
                assert not use.model
            used.setdefault(name, {})[k.split("/")[-1]] = t
        c, _, _ = TensorParallel(_rank_mesh(4, r)).attention(cfg)
        assert (c.num_heads, c.num_kv_heads, c.hd) == (2, 1, cfg.hd)
        got = got + attn.attn_train(used, x, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    mha = get_arch("qwen1.5-4b").smoke
    assert head_split(mha, 8, 3).mode == "gather"
    spec = param_pspecs({"layers": [{"attn": {"wq": {"w": torch.empty(mha.d_model, mha.q_dim)}}}]},
                        _rank_mesh(8, 3), fsdp=False)["layers"][0]["attn"]["wq"]["w"]
    assert leaf_use("layers/0/attn/wq/w", spec, mha, 8, 3).model
