"""Expert-parallel MoE and Mamba2 by heads over "model"
(``repro_torch.distributed.tensor_parallel``'s ``TensorParallel.moe``,
``mamba_train``, ``mamba_prefill`` and ``ssm_decode``) in the sharded train
step, prefill and decode, against ``repro``.

Four gloo ranks on the CPU, spawned once a mesh through ``ranks.spawn(...,
axes={"data": D, "model": T})`` (``rank_checks.spmd_mixed_cases``: the
train cases, then the serving cases), run every case; beside them,
``repro``'s ``make_spmd_train_step``, ``make_spmd_prefill`` and
``make_spmd_serve_step`` run the same cases in a subprocess on CPU meshes of
four host devices, their axes typed ``Auto`` and each call under
``jax.set_mesh`` (``tests/test_torch_spmd.py``'s way).  Both sides start
from ``repro``'s init carried by the bridge, everything in fp32 at 1e-4 of
the largest entry, and the MoE at capacity factor E where ``repro`` is the
reference (its grouped dispatch loses a kept token where one is dropped,
ROADMAP.md queue 3).

Cases: jamba smoke (a Mamba2 layer with a dense MLP, then attention with an MoE)
under ``tp_fsdp`` with AdamW (eps 1e-3), two steps of B 8 x T 32 in M = 2,
on a (2, 2) mesh (8 of 16 Mamba2 heads and 2 of 4 experts a rank) and on a
(1, 4) mesh (4 heads and one expert a rank); the same on (2, 2) at capacity
factor 1.25, where entries are dropped, held to the port's one-process
``make_train_step`` under the anchored config (each row routed as its own
group); llama4-maverick smoke serving on (2, 2) (top-1, a shared expert,
MoE every other layer) and jamba smoke serving on (1, 4): the prefill's
last-token logits, 3 decode steps from ``repro``'s ``prefill_with_cache``
cache cut to each rank's shard, the cache after them, and the cache the
sharded prefill itself fills (SSM state by heads, conv window and KV
shards) against ``repro``'s ``prefill_with_cache``.

Without ranks, a thread a rank (``_Threads``: each collective waits for
every thread's tensor): one MoE and one Mamba2 layer at tp 2 and 4, their
outputs and gradients against the one-process layer, each rank's matmul
FLOPs against the layer's, a prefill's and a decode step's collectives
and state; and
``leaf_use`` where the heads or experts do not split.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.checkpoint.io import _path_str
from repro.configs import get_arch as jax_get_arch
from repro.models import api as jax_api
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import rank_checks
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.distributed.spmd import act_anchor_for, state_specs_for
from repro_torch.distributed.tensor_parallel import TensorParallel, experts_of, leaf_use, ssm_heads
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import api
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import layer_specs
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.training import create_train_state, make_train_step
from repro_torch.tree import flatten

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-4
B, T, M, STEPS, DECODE = 8, 32, 2, 2, 3
ADAMW = {"eps": 1e-3}
JAMBA, LLAMA4 = "jamba-v0.1-52b", "llama4-maverick-400b-a17b"

#: (id, arch, ("data", "model") mesh, capacity factor: "E" or a number)
TRAIN = [
    ("jamba-tp_fsdp", JAMBA, (2, 2), "E"),
    ("jamba-tp_fsdp-tp4", JAMBA, (1, 4), "E"),
    ("jamba-drops", JAMBA, (2, 2), 1.25),
]
#: (id, arch, mesh, B, T, kv_len), at capacity factor E
SERVE = [
    ("llama4-serve", LLAMA4, (2, 2), 4, 24, 48),
    ("jamba-serve-tp4", JAMBA, (1, 4), 4, 24, 48),
]
HELD_TO_REPRO = [c[0] for c in TRAIN if c[3] == "E"]
TRAIN_BY_ID = {c[0]: c for c in TRAIN}
SERVE_BY_ID = {c[0]: c for c in SERVE}
SEED = {cid: i for i, cid in enumerate([c[0] for c in TRAIN] + [c[0] for c in SERVE])}


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


def _capacity(arch, cf) -> float:
    return float(get_arch(arch).smoke.num_experts) if cf == "E" else cf


def _cfgs(arch, cf="E"):
    c = _capacity(arch, cf)
    return (jax_get_arch(arch).smoke.replace(dtype=jnp.float32, capacity_factor=c),
            get_arch(arch).smoke.replace(dtype=torch.float32, capacity_factor=c))


@functools.lru_cache
def _train_inputs(cid):
    """(repro's flat init as numpy, the numpy batch) of a train case."""
    _, arch, _, cf = TRAIN_BY_ID[cid]
    jcfg, cfg = _cfgs(arch, cf)
    params = _flat(jax_api.init_params(jax.random.PRNGKey(SEED[cid]), jcfg))
    rng = np.random.default_rng(SEED[cid])
    batch = {k: rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32) for k in ("tokens", "labels")}
    return params, batch


@functools.lru_cache
def _serve_inputs(cid):
    """(repro's flat init, the prompt [B, T], the decode tokens [DECODE, B,
    1], repro's flat cache after its prefill_with_cache of the prompt)."""
    _, arch, _, b, t, kv_len = SERVE_BY_ID[cid]
    jcfg, cfg = _cfgs(arch)
    jparams = jax_api.init_params(jax.random.PRNGKey(SEED[cid]), jcfg)
    rng = np.random.default_rng(SEED[cid])
    prompt = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    decode = rng.integers(0, cfg.vocab_size, (DECODE, b, 1)).astype(np.int32)
    _, cache = jax_api.prefill_with_cache(jparams, jcfg, jax_api.init_cache(jcfg, b, kv_len),
                                          {"tokens": jnp.asarray(prompt)})
    return _flat(jparams), prompt, decode, _flat(cache)


_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import _path_str
    from repro.configs import get_arch
    from repro.distributed.spmd import make_spmd_prefill, make_spmd_serve_step, make_spmd_train_step
    from repro.models import api
    from repro.optim import make_optimizer, schedules
    from repro.training import create_train_state

    inp, (train, serve) = np.load(sys.argv[1]), json.loads(sys.argv[3])

    def mesh_of(shape):
        return jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def tree(prefix, shapes):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(inp[f"{prefix}/{_path_str(p)}"]) for p, _ in leaves])

    out = {}
    for cid, arch, shape, cf, M, steps in train:
        mesh = mesh_of(shape)
        cfg = get_arch(arch).smoke.replace(dtype=jnp.float32, capacity_factor=cf)
        params = tree(f"{cid}/params", jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg)))
        batch = {k: jnp.asarray(inp[f"{cid}/batch/{k}"]) for k in ("tokens", "labels")}
        opt = make_optimizer("adamw", schedules.constant_schedule(1e-3), eps=1e-3)
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
        step, _ = make_spmd_train_step(cfg, mesh, specs, opt, num_microbatches=M)
        state = create_train_state(params, opt)
        for i in range(steps):
            with jax.set_mesh(mesh):
                state, m = step(state, batch)
            for k, v in m.items():
                out[f"{cid}/metrics/{i}/{k}"] = np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(state)[0]:
            out[f"{cid}/state/{_path_str(p)}"] = np.asarray(v)
    for cid, arch, shape, cf, B, T, kv_len, steps in serve:
        mesh = mesh_of(shape)
        cfg = get_arch(arch).smoke.replace(dtype=jnp.float32, capacity_factor=cf)
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
def repro_side(tmp_path_factory):
    """``repro``'s sharded step, prefill and decode on the cases it is held
    to, started in a subprocess (it runs while the ranks do); calling the
    value waits and returns ``{case: (metrics per step, flat state)}`` for a
    train case and ``{case: (logits per call, flat cache after the
    steps)}`` for a serving case."""
    tmp = tmp_path_factory.mktemp("repro_spmd_ep")
    arrays, train, serve = {}, [], []
    for cid in HELD_TO_REPRO:
        _, arch, shape, cf = TRAIN_BY_ID[cid]
        params, batch = _train_inputs(cid)
        arrays.update({f"{cid}/params/{k}": v for k, v in params.items()})
        arrays.update({f"{cid}/batch/{k}": v for k, v in batch.items()})
        train.append((cid, arch, shape, _capacity(arch, cf), M, STEPS))
    for cid, arch, shape, b, t, kv_len in SERVE:
        params, prompt, decode, cache = _serve_inputs(cid)
        arrays.update({f"{cid}/params/{k}": v for k, v in params.items()})
        arrays.update({f"{cid}/cache/{k}": v for k, v in cache.items()})
        arrays[f"{cid}/prompt"], arrays[f"{cid}/decode"] = prompt, decode
        serve.append((cid, arch, shape, _capacity(arch, "E"), b, t, kv_len, DECODE))
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPRO_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps([train, serve])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    @functools.lru_cache
    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(tmp / "out.npz")

        def under(prefix):
            return {k[len(prefix):]: got[k] for k in got.files if k.startswith(prefix)}

        out = {}
        for cid in HELD_TO_REPRO:
            metrics = [{k: float(v) for k, v in under(f"{cid}/metrics/{i}/").items()} for i in range(STEPS)]
            out[cid] = metrics, under(f"{cid}/state/")
        for cid in SERVE_BY_ID:
            out[cid] = [got[f"{cid}/logits/{i}"] for i in range(DECODE + 1)], under(f"{cid}/cache/")
        return out

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(repro_side):
    """Every case on four gloo ranks, one spawn a mesh: ``{case: [each
    rank's result]}``."""
    per_mesh = {}
    for cid, arch, shape, cf in TRAIN:
        params, batch = _train_inputs(cid)
        per_mesh.setdefault(shape, ([], []))[0].append((cid, dict(
            cfg=_cfgs(arch, cf)[1], strategy="tp_fsdp", M=M, steps=STEPS, batch=batch, optimizer="adamw",
            hyper=ADAMW, lr=1e-3, params=params)))
    for cid, arch, shape, b, t, kv_len in SERVE:
        params, prompt, decode, cache = _serve_inputs(cid)
        per_mesh.setdefault(shape, ([], []))[1].append((cid, dict(
            cfg=_cfgs(arch)[1], params=params, prompt=prompt, decode=decode, kv_len=kv_len, cache=cache,
            prefill_cache=True)))
    out = {}
    for (data, model), (train, serve) in per_mesh.items():
        per_rank = ranks.spawn(rank_checks.spmd_mixed_cases, 4, args=([c for _, c in train], [c for _, c in serve]),
                               device="cpu", timeout=600, axes={"data": data, "model": model})
        for which, items in enumerate((train, serve)):
            out.update({cid: [r[which][i] for r in per_rank] for i, (cid, _) in enumerate(items)})
    return out


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(np.abs(want).max(initial=0.0), 1e-30),
                               err_msg=name)


def _compare(metrics, state, want_metrics, want_state):
    assert len(metrics) == len(want_metrics)
    for got, want in zip(metrics, want_metrics):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], name=k)
    want_state = {k: v for k, v in want_state.items() if not k.endswith("step")}
    assert sorted(state) == sorted(want_state)
    for k, want in want_state.items():
        _close(state[k], want, name=k)


def _port_cache(flat_repro_cache, cfg) -> dict:
    return {k: v.numpy() for k, v in flatten(bridge.cache_from_repro(flat_repro_cache, cfg, device="cpu")).items()}


@pytest.mark.parametrize("cid", HELD_TO_REPRO)
def test_tp_fsdp_step_matches_repro(world, repro_side, cid):
    """jamba under ``tp_fsdp``, its MoE expert-parallel and its Mamba2 by
    heads: the loss, clip norm and learning rate at both steps, and every
    parameter and AdamW moment after them, equal ``repro``'s."""
    r0 = world[cid][0]
    assert all(r["shapes_agree"] for r in world[cid])
    assert len({tuple(m["loss"] for m in r["metrics"]) for r in world[cid]}) == 1
    _compare(r0["metrics"], r0["state"], *repro_side()[cid])


def test_dropped_entries_match_the_one_process_grouped_step(world):
    """At capacity factor 1.25 some entries are dropped (every rank of a
    column drops the same ones, from the whole routing): the sharded step
    equals the port's one-process ``make_train_step`` under the config the
    step anchors (each row routed as its own group, the flat form's drops)."""
    cid = "jamba-drops"
    _, arch, shape, cf = TRAIN_BY_ID[cid]
    assert any(not keep.all() for _, keep in world[cid][0]["routes"])
    cfg = act_anchor_for(_cfgs(arch, cf)[1], make_local_mesh(*shape), B, M)
    params, batch = _train_inputs(cid)
    full = bridge.params_from_repro(params, cfg, device="cpu")
    opt = make_optimizer("adamw", constant_schedule(1e-3), **ADAMW)
    step = make_train_step(lambda p, b: api.loss_fn(p, cfg, b), opt, num_microbatches=M)
    state = create_train_state(full, opt)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    r0 = world[cid][0]
    _compare(r0["metrics"], r0["state"], metrics, rank_checks.repro_state(state, cfg))


@pytest.mark.parametrize("cid", list(SERVE_BY_ID))
def test_prefill_decode_and_filled_cache_match_repro(world, repro_side, cid):
    """The prefill's last-token logits, each decode step's logits and the
    cache after the steps equal ``repro``'s sharded prefill and decode; the
    cache the sharded prefill fills (the SSM state on each rank's heads, the
    conv window and KV shards) equals ``repro``'s ``prefill_with_cache``."""
    r0 = world[cid][0]
    want_logits, want_cache = repro_side()[cid]
    assert len(r0["logits"]) == len(want_logits)
    for i, (got, want) in enumerate(zip(r0["logits"], want_logits)):
        _close(got, want, name=f"logits of call {i}")
    cfg = _cfgs(SERVE_BY_ID[cid][1])[1]
    for got, want in ((r0["cache"], _port_cache(want_cache, cfg)),
                      (r0["prefill_cache"], _port_cache(_serve_inputs(cid)[3], cfg))):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            _close(got[k], v, name=k)


def _split_blocks(cfg, tp) -> tuple[int, int]:
    """(the blocks a serving call all-reduces once: attention, dense MLP,
    MoE; the Mamba2 layers, two all-reduces and one all-gather each)."""
    specs = layer_specs(cfg)
    assert experts_of(cfg, tp, 0) is not None and (cfg.family != "hybrid" or ssm_heads(cfg, tp, 0) is not None)
    return (sum(s.kind == "attn" for s in specs) + sum(s.moe or cfg.d_ff > 0 for s in specs),
            sum(s.kind == "mamba" for s in specs))


@pytest.mark.parametrize("cid", [c[0] for c in TRAIN] + list(SERVE_BY_ID))
def test_no_rank_gathers_an_expert_bank_or_a_mamba_product_over_model(world, cid):
    """Under ``tp_fsdp`` and in serving, the MoE and Mamba2 leaves a rank
    uses gathered over "model" are the router and ``conv_w`` alone (no
    expert bank, shared-expert leaf, ``in_proj``, ``out_proj`` or SSM
    state); a serving call runs one all-reduce per MoE block (with the
    attention and dense-MLP blocks', the embedding's and two per Mamba2
    layer) and one all-gather per Mamba2 layer beside the logits'."""
    case = TRAIN_BY_ID.get(cid) or SERVE_BY_ID[cid]
    cfg, tp = _cfgs(case[1])[1], case[2][1]
    for r in world[cid]:
        layer = {"/".join(p.split("/")[2:]) for p in r["gathered"] if {"moe", "mamba"} & set(p.split("/"))}
        assert layer == {"moe/router/w"} | ({"mamba/conv_w"} if cfg.family == "hybrid" else set()), layer
        if cid in SERVE_BY_ID:
            blocks, mambas = _split_blocks(cfg, tp)
            assert all(c["all_reduce"] == 1 + blocks + 2 * mambas for c in r["counts"])
            assert r["counts"][0]["all_gather"] == 1 + mambas
            assert r["k1"] == 0


@pytest.mark.parametrize("cid", [c[0] for c in TRAIN] + list(SERVE_BY_ID))
def test_every_rank_of_a_column_routes_alike(world, cid):
    """Each MoE call's ``idx`` and ``keep`` are equal on every rank along
    "model" (a split decision would silently drop tokens): the ranks of a
    column hold the same rows and the router whole."""
    shape = (TRAIN_BY_ID.get(cid) or SERVE_BY_ID[cid])[2]
    per_rank = world[cid]
    for d in range(shape[0]):
        column = [per_rank[d * shape[1] + m]["routes"] for m in range(shape[1])]
        assert column[0] and all(len(c) == len(column[0]) for c in column)
        for calls in zip(*column):
            for idx, keep in calls[1:]:
                np.testing.assert_array_equal(idx, calls[0][0])
                np.testing.assert_array_equal(keep, calls[0][1])


# -- a thread a rank ------------------------------------------------------------------


class _Threads:
    """``n`` ranks along "model" as threads of this process: each collective
    waits until every thread has put its tensor, then combines them in rank
    order."""

    def __init__(self, n: int, timeout: float = 120.0):
        self.n, self.timeout = n, timeout
        self.barrier, self.slots = threading.Barrier(n, timeout=timeout), [None] * n

    def run(self, fn) -> list:
        """``fn(tp, rank)`` on every rank, each with its
        :class:`TensorParallel` on a (1, n) mesh; their results in rank order."""
        out, errors = [None] * self.n, []

        def one(r):
            try:
                out[r] = fn(TensorParallel(Mesh(("data", "model"), (1, self.n), (0, r), _ThreadRank(self, r))), r)
            except Exception as e:  # re-raised below; the other threads released from the barrier
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=one, args=(r,), daemon=True) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.timeout)
        assert not any(t.is_alive() for t in threads), "a rank's thread did not finish"
        if errors:
            raise errors[0]
        return out


class _ThreadRank:
    def __init__(self, hub: _Threads, r: int):
        self.hub, self.r = hub, r

    def _all(self, t):
        self.hub.slots[self.r] = t.detach().clone()
        self.hub.barrier.wait()
        got = list(self.hub.slots)
        self.hub.barrier.wait()
        return got

    def all_reduce_over(self, t, axes):
        got = self._all(t)
        return t.copy_(functools.reduce(torch.add, got))

    def all_gather_over(self, t, axes, dim=0):
        return torch.cat(self._all(t), dim=dim)

    def reduce_scatter_over(self, t, axes, dim=0, dtype=None):
        total = functools.reduce(torch.add, self._all(t.to(dtype or t.dtype)))
        n = total.shape[dim] // self.hub.n
        return total.narrow(dim, self.r * n, n)


def _leaves(tree):
    return {k: v.detach().clone().requires_grad_(True) for k, v in flatten(tree).items()}


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        *parents, last = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _rank_shard(path, t, tp, r):
    """The rank's shard of a MoE or Mamba2 leaf under the serving rules at
    (1, tp), before any gather (the router and conv_w as gathered)."""
    cuts = {"experts": 0, "in_proj": 1, "out_proj": 0}
    name = next((k for k in cuts if k in path.split("/")), None)
    if name is None and "shared" in path.split("/"):
        name, cuts["shared"] = "shared", 0 if path.endswith("down/w") else 1
    if name is None:
        return t
    n = t.shape[cuts[name]] // tp
    return t.narrow(cuts[name], r * n, n)


def _layer_case(kind, tp):
    """(one-process output, its gradients by path and for x, each rank's
    (output, gradients by path, x's gradient, counts, matmul FLOPs), the
    one-process FLOPs) of a MoE (llama4, a shared expert, grouped by row at
    capacity factor 1.25) or Mamba2 (jamba) layer on x [2, 16, d]."""
    arch = LLAMA4 if kind == "moe" else JAMBA
    cfg = get_arch(arch).smoke.replace(dtype=torch.float32, capacity_factor=1.25)
    g = torch.Generator().manual_seed(7)
    p = moe_mod.moe_init(g, cfg) if kind == "moe" else mamba_mod.mamba_init(g, cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    gy = torch.randn(x.shape, generator=g)

    def loss(y, aux):
        return (y * gy).sum() + (aux["load_balance"] + aux["router_z"] if aux else 0)

    def whole():
        leaves, xx = _leaves(p), x.clone().requires_grad_(True)
        with FlopCounterMode(display=False) as counter:
            if kind == "moe":
                y, aux = moe_mod.moe_apply_grouped(_unflat(leaves), xx, cfg)
            else:
                y, aux = mamba_mod.mamba_train(_unflat(leaves), xx, cfg), None
            loss(y, aux).backward()
        return y.detach(), {k: v.grad for k, v in leaves.items()}, xx.grad, counter.get_total_flops()

    def rank(tp_, r):
        leaves = {k: _rank_shard(k, v, tp, r).detach().clone().requires_grad_(True) for k, v in flatten(p).items()}
        xx = x.clone().requires_grad_(True)
        tp_.keep_routes = True
        with FlopCounterMode(display=False) as counter:
            if kind == "moe":
                y, aux = tp_.moe(_unflat(leaves), xx, cfg, grouped=True)
            else:
                y, aux = tp_.mamba_train(_unflat(leaves), xx, cfg), None
            loss(y, aux).backward()
        return y.detach(), {k: v.grad for k, v in leaves.items()}, xx.grad, dict(tp_.counts), counter.get_total_flops()

    return cfg, whole(), _Threads(tp).run(rank)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["moe", "mamba"])
def test_layer_split_over_model_equals_the_whole_layer(kind, tp):
    """A MoE layer on each rank's experts and a Mamba2 layer on each rank's
    heads: every rank's output and input gradient equal the one-process
    layer's; the ranks' gradients of their shards joined (of a leaf used in
    part, summed) equal its gradients; the MoE block runs one all-reduce
    over "model" forward and one backward (its input's gradient), the
    Mamba2 layer one all-gather (in_proj's output) and two all-reduces (the
    norm's sum of squares, out_proj) forward, and a reduce-scatter and two
    all-reduces backward."""
    _, (y, grads, gx, _), ranks_out = _layer_case(kind, tp)
    for got_y, _, got_gx, counts, _ in ranks_out:
        torch.testing.assert_close(got_y, y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_gx, gx, rtol=1e-5, atol=1e-5)
        if kind == "moe":
            assert (counts["all_reduce"], counts.get("all_gather", 0)) == (2, 0), counts
        else:
            assert (counts["all_gather"], counts["all_reduce"], counts["reduce_scatter"]) == (1, 4, 1), counts
    for path, want in grads.items():
        parts = [o[1][path] for o in ranks_out]
        if parts[0].shape == want.shape:
            got = functools.reduce(torch.add, parts)
        else:
            got = torch.cat(parts, dim=next(d for d in range(want.ndim) if parts[0].shape[d] != want.shape[d]))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()), msg=path)


def _router_flops(cfg) -> int:
    """The matmul FLOPs of a [32, d] x [d, E] router product, forward and
    both backward products: what every rank of a column computes alike."""
    w = torch.zeros(cfg.d_model, cfg.num_experts, requires_grad=True)
    x = torch.zeros(32, cfg.d_model, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        (x @ w).sum().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["moe", "mamba"])
def test_each_rank_does_its_share_of_the_layer(kind, tp):
    """Each rank's matmul FLOPs (forward and backward) are 1/tp of the
    one-process layer's on the same rows, but for what every rank of a
    column computes alike: the MoE router's product (exactly), and in the
    SSD the heads' shared C B^T (under 1% of the layer at jamba smoke)."""
    cfg, (*_, flops), ranks_out = _layer_case(kind, tp)
    per_rank = {o[4] for o in ranks_out}
    assert len(per_rank) == 1
    got = per_rank.pop()
    if kind == "moe":
        router = _router_flops(cfg)
        assert got * tp == flops + (tp - 1) * router, (got, flops, router)
    else:
        assert flops / tp <= got <= flops / tp * 1.01, (got, flops)


def test_a_decode_step_gathers_no_state():
    """jamba smoke's Mamba2 decode step at tp 2 from each rank's shard of a
    fresh cache: one all-gather of the rank's in_proj row and conv window
    (its bytes exactly those), two all-reduces; the state and window after
    three steps equal one process's."""
    cfg = get_arch(JAMBA).smoke.replace(dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    p = mamba_mod.mamba_init(g, cfg)
    xs = [torch.randn(2, 1, cfg.d_model, generator=g) for _ in range(3)]
    cache = mamba_mod.init_ssm_cache(cfg, 2)
    want = [mamba_mod.mamba_decode(p, x, cache, cfg)[0] for x in xs]
    d_in, H, P, N, _ = mamba_mod._dims(cfg)
    tp = 2

    def rank(tp_, r):
        q = {k: _rank_shard(k, v, tp, r) for k, v in p.items()}
        fresh = mamba_mod.init_ssm_cache(cfg, 2)
        c = {"state": fresh["state"].narrow(1, r * H // tp, H // tp).clone(),
             "conv": fresh["conv"].narrow(2, r * (d_in + 2 * N) // tp, (d_in + 2 * N) // tp).clone()}
        ys = [tp_.ssm_decode(q, x, c, cfg) for x in xs]
        return ys, c, dict(tp_.counts)

    outs = _Threads(tp).run(rank)
    row = (2 * d_in + 2 * N + H) // tp + (cfg.ssm_conv_width - 1) * (d_in + 2 * N) // tp
    for ys, _, counts in outs:
        for got, w in zip(ys, want):
            torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)
        assert counts["all_gather"] == 3 and counts["all_reduce"] == 6
        assert counts["all_gather_bytes"] == 3 * 2 * row * 4 * tp
    torch.testing.assert_close(torch.cat([o[1]["state"] for o in outs], 1), cache["state"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([o[1]["conv"] for o in outs], 2), cache["conv"], rtol=1e-6, atol=1e-6)


def test_prefill_steps_each_ranks_heads_as_one_process_does(monkeypatch):
    """jamba smoke's Mamba2 prefill of 20 tokens at tp 2, its state
    increments formed 8 tokens at a time (chunk edges inside the prompt):
    every rank's output equals one process's ``mamba_prefill`` (the token
    stepping), and the ranks' shards of the state and conv window it fills
    join to that prefill's cache; three collectives a call."""
    monkeypatch.setattr(mamba_mod, "PREFILL_CHUNK", 8)
    cfg = get_arch(JAMBA).smoke.replace(dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    p = mamba_mod.mamba_init(g, cfg)
    x = torch.randn(2, 20, cfg.d_model, generator=g)
    cache = mamba_mod.init_ssm_cache(cfg, 2)
    want, _ = mamba_mod.mamba_prefill(p, x, cache, cfg)
    d_in, H, _, N, _ = mamba_mod._dims(cfg)
    tp = 2

    def rank(tp_, r):
        q = {k: _rank_shard(k, v, tp, r) for k, v in p.items()}
        fresh = mamba_mod.init_ssm_cache(cfg, 2)
        c = {"state": fresh["state"].narrow(1, r * H // tp, H // tp).clone(),
             "conv": fresh["conv"].narrow(2, r * (d_in + 2 * N) // tp, (d_in + 2 * N) // tp).clone()}
        return tp_.mamba_prefill(q, x, c, cfg), c, dict(tp_.counts)

    outs = _Threads(tp).run(rank)
    for y, _, counts in outs:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        assert (counts["all_gather"], counts["all_reduce"]) == (1, 2)
    torch.testing.assert_close(torch.cat([o[1]["state"] for o in outs], 1), cache["state"], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(torch.cat([o[1]["conv"] for o in outs], 2), cache["conv"], rtol=1e-6, atol=1e-6)


def test_layers_that_do_not_split_are_gathered_whole():
    """Through ``leaf_use`` alone: jamba smoke's 16 Mamba2 heads at tp 32 and
    its 4 experts at tp 8 do not split, so every leaf of those layers whose
    spec names "model" is gathered over it and every rank computes the whole
    layer (its gradient ``"replicated"``); at tp 2 the expert banks,
    ``in_proj``, ``out_proj`` and the shared expert are used as held, the
    router and ``conv_w`` gathered with their gradients summed, and the 1-D
    Mamba2 leaves summed."""
    cfg = get_arch(JAMBA).smoke
    params = state_specs_for(cfg, make_optimizer()).params
    for tp, whole in ((32, {"mamba", "moe"}), (8, {"moe"}), (2, set())):
        specs = flatten(param_pspecs(params, Mesh(("data", "model"), (1, tp)), fsdp=False))
        assert (ssm_heads(cfg, tp, 1) is None) == ("mamba" in whole)
        assert (experts_of(cfg, tp, 1) is None) == ("moe" in whole)
        layer = {k: s for k, s in specs.items() if k.startswith("layers/")}
        for path, spec in layer.items():
            kind = "moe" if "/moe/" in path else "mamba" if "/mamba/" in path else None
            if kind is None:
                continue
            use = leaf_use(path, spec, cfg, tp, 1)
            named = "model" in {a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))}
            name = path.split("/")[-2 if path.endswith("/w") else -1]
            if kind in whole:
                assert (use.model, use.grad) == ((True, "replicated") if named else (False, "local")), path
            elif name in ("router", "conv_w"):
                assert use.model == named and use.grad == "sum", path
            elif name in ("in_proj", "out_proj", "gate", "up", "down"):
                assert (use.model, use.grad) == (False, "local"), path
            else:
                assert (use.model, use.grad) == (False, "sum"), path
        # the gather is real: the rules split some leaf of each layer over "model"
        assert all(any("model" in str(s) for k, s in layer.items() if f"/{kind}/" in k) for kind in whole)
