"""The sharded train step (``repro_torch.distributed.spmd``) against ``repro``'s
``make_spmd_train_step``.

Four gloo ranks on the CPU, spawned once for the module through
``ranks.spawn(..., axes={"data": 2, "model": 2})``, run every case; beside
them, ``repro``'s step runs the same cases in a subprocess on a (2, 2) CPU
mesh of four host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``).
Its axes are typed ``Auto``: on jax 0.9.0 ``jax.make_mesh``'s default
(``Explicit``) axes make ``with_sharding_constraint`` refuse the step's
specs.  Both sides start from ``repro``'s own init, carried by the bridge,
and take one numpy batch (B 8 x T 32 in M = 2 micro-batches, so that each
micro-batch's four rows split over all four ranks under ``zero3``), two
steps.

Cases: qwen1.5-4b smoke under ``tp_fsdp``, ``zero3`` and ``tp_fsdp`` with
``gather_params_once``; kimi-k2 smoke (MoE, Adafactor) under ``tp_fsdp``,
both MoE archs at capacity factor E so that no entry is dropped
(``repro``'s grouped dispatch loses a kept token where one is, ROADMAP.md
queue 3; the last test holds that apart); jamba smoke (hybrid, the plain
SSD on the CPU) under ``zero3`` at B 4 (rows over "data"): at B 8 ``repro``'s zero3 anchors
the rows on ("data", "model") and its MoE pins then name "model" twice
(``DuplicateSpecError``, ROADMAP.md queue 3); and qwen2.5-14b smoke under
``tp_fsdp`` on a (1, 4) mesh (a second spawn, and ``repro`` on a (1, 4)
mesh), whose 2 KV heads do not split whole over "model": ``wk`` and ``wv``
are gathered and each rank trains its whole heads.  Everything in fp32.

Tolerance: 1e-4 of the largest entry of each compared tensor, the limit of
``tests/test_torch_archs.py`` and ``tests/test_torch_hybrid.py``, on the
losses, clip norms, learning rates and every state leaf after two steps.
AdamW runs at ``eps = 1e-3``: at its default 1e-8 an element whose gradient
is zero up to rounding (the key bias: softmax is invariant to it) moves by
lr times the sign of that rounding, so two correct runs part by 2 lr there;
at 1e-3 the update of such an element is linear in its gradient.
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
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro.checkpoint.io import _path_str
from repro.configs import get_arch as jax_get_arch
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.distributed import rank_checks
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.distributed.spmd import act_anchor_for, state_specs_for
from repro_torch.distributed.tensor_parallel import head_split, leaf_use
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import api, moe
from repro_torch.models.transformer import reference_layout
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.training import create_train_state, make_train_step
from repro_torch.training.steps import _microbatches
from repro_torch.tree import flatten, tree_map

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-4
B, T, M, STEPS = 8, 32, 2, 2
#: cases at another batch size (the module docstring)
BATCH = {"jamba-zero3": 4}
ADAMW = {"eps": 1e-3}

#: (id, arch, strategy, optimizer, its hyper-parameters, gather_params_once, config changes)
CASES = [
    ("qwen-tp_fsdp", "qwen1.5-4b", "tp_fsdp", "adamw", ADAMW, False, {}),
    ("qwen-zero3", "qwen1.5-4b", "zero3", "adamw", ADAMW, False, {}),
    ("qwen-gather_once", "qwen1.5-4b", "tp_fsdp", "adamw", ADAMW, True, {}),
    ("kimi-tp_fsdp", "kimi-k2-1t-a32b", "tp_fsdp", "adafactor", {}, False, {"capacity_factor": "E"}),
    ("jamba-zero3", "jamba-v0.1-52b", "zero3", "adamw", ADAMW, False, {"capacity_factor": "E"}),
    ("qwen2.5-tp4", "qwen2.5-14b", "tp_fsdp", "adamw", ADAMW, False, {}),
]
#: cases on another ("data", "model") mesh than (2, 2): K = 2 KV heads at tp 4
MESH = {"qwen2.5-tp4": (1, 4)}
IDS = [c[0] for c in CASES]
BY_ID = {c[0]: c for c in CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite's other
    workers share the CPU, and spinning thread pools oversubscribe it.
    Restored after."""
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
    """(repro's flat init as numpy, the numpy batch) of a case."""
    _, arch, *_, changes = BY_ID[cid]
    jcfg, tcfg = _cfgs(arch, changes)
    params = _flat(jax_api.init_params(jax.random.PRNGKey(IDS.index(cid)), jcfg))
    rng = np.random.default_rng(IDS.index(cid))
    rows = BATCH.get(cid, B)
    batch = {k: rng.integers(0, tcfg.vocab_size, (rows, T)).astype(np.int32) for k in ("tokens", "labels")}
    return params, batch


_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import _path_str
    from repro.configs import get_arch
    from repro.distributed.spmd import make_spmd_train_step
    from repro.models import api
    from repro.optim import make_optimizer, schedules
    from repro.training import create_train_state

    inp, cases = np.load(sys.argv[1]), json.loads(sys.argv[3])
    out = {}
    for cid, arch, strategy, opt_name, hyper, once, changes, M, steps, shape in cases:
        # jax 0.9's make_mesh types its axes Explicit, under which the step's
        # with_sharding_constraint refuses its specs
        mesh = jax.make_mesh(tuple(shape), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        cfg = get_arch(arch).smoke.replace(dtype=jnp.float32, **changes)
        shapes = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(inp[f"{cid}/params/{_path_str(p)}"]) for p, _ in leaves])
        batch = {k: jnp.asarray(inp[f"{cid}/batch/{k}"]) for k in ("tokens", "labels")}
        opt = make_optimizer(opt_name, schedules.constant_schedule(1e-3), **hyper)
        specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
        step, _ = make_spmd_train_step(cfg, mesh, specs, opt, num_microbatches=M, strategy=strategy,
                                       gather_params_once=once)
        state = create_train_state(params, opt)
        for i in range(steps):
            with jax.set_mesh(mesh):  # the anchor's bare PartitionSpecs need a mesh in context
                state, m = step(state, batch)
            for k, v in m.items():
                out[f"{cid}/metrics/{i}/{k}"] = np.asarray(v)
        for p, v in jax.tree_util.tree_flatten_with_path(state)[0]:
            out[f"{cid}/state/{_path_str(p)}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def repro_step(tmp_path_factory):
    """``repro``'s step on every case, started in a subprocess (it runs while
    the ranks do); calling the value waits and returns ``{case: (metrics per
    step, flat state)}``."""
    tmp = tmp_path_factory.mktemp("repro_spmd")
    arrays, cases = {}, []
    for cid, arch, strategy, opt, hyper, once, changes in CASES:
        params, batch = _inputs(cid)
        arrays.update({f"{cid}/params/{k}": v for k, v in params.items()})
        arrays.update({f"{cid}/batch/{k}": v for k, v in batch.items()})
        cases.append((cid, arch, strategy, opt, hyper, once, _changes(arch, changes), M, STEPS, MESH.get(cid, (2, 2))))
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
            metrics = [{k.split("/")[-1]: float(got[k]) for k in got.files if k.startswith(f"{cid}/metrics/{i}/")}
                       for i in range(STEPS)]
            state = {k[len(cid) + 7:]: got[k] for k in got.files if k.startswith(f"{cid}/state/")}
            out[cid] = metrics, state
        return out

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(repro_step):
    """Every case on four gloo ranks: one spawn a mesh, (2, 2) and (1, 4)."""
    per_mesh = {}
    for cid, arch, strategy, opt, hyper, once, changes in CASES:
        params, batch = _inputs(cid)
        per_mesh.setdefault(MESH.get(cid, (2, 2)), []).append((cid, dict(
            cfg=_cfgs(arch, changes)[1], strategy=strategy, M=M, steps=STEPS, batch=batch, optimizer=opt,
            hyper=hyper, lr=1e-3, gather_params_once=once, params=params)))
    out = {}
    for (data, model), items in per_mesh.items():
        per_rank = ranks.spawn(rank_checks.spmd_cases, 4, args=([c for _, c in items],), device="cpu",
                               timeout=600, axes={"data": data, "model": model})
        out.update({cid: [r[i] for r in per_rank] for i, (cid, _) in enumerate(items)})
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


@pytest.mark.parametrize("cid", IDS)
def test_sharded_step_matches_repro(world, repro_step, cid):
    """Loss, clip norm and learning rate at both steps, and every state leaf
    (parameters, AdamW's moments or Adafactor's statistics) after them."""
    r0 = world[cid][0]
    _compare(r0["metrics"], r0["state"], *repro_step()[cid])


@pytest.mark.parametrize("cid", IDS)
def test_every_rank_holds_its_shard_and_agrees(world, cid):
    """Each rank's local shard shapes are the rules' shard shapes, every rank
    reports the same loss, and no rank launched K1 (the CPU runs the plain
    attention)."""
    per_rank = world[cid]
    assert all(r["shapes_agree"] for r in per_rank)
    assert len({tuple(m["loss"] for m in r["metrics"]) for r in per_rank}) == 1
    assert all(r["launches"] == 0 for r in per_rank)


def test_a_head_split_that_is_not_whole_gathers_wk_and_wv():
    """The (1, 4) case's heads (qwen2.5-14b smoke, 8 query heads over 2 KV
    heads): a rank's shard of ``wk`` and ``wv`` is half a head, so those two
    are gathered over "model" and each rank computes on its whole heads
    (``"kv_gather"``), their gradients summed back over "model"; the case's
    step is held to ``repro``'s above."""
    cfg = _cfgs("qwen2.5-14b", {})[1]
    mesh = make_local_mesh(*MESH["qwen2.5-tp4"])
    specs = param_pspecs(state_specs_for(cfg, make_optimizer()).params, mesh, fsdp=True)
    for r in range(4):
        assert head_split(cfg, 4, r).mode == "kv_gather"
        for name in ("wq", "wk", "wv", "wo"):
            path = f"layers/0/attn/{name}/w"
            use = leaf_use(path, flatten(specs)[path], cfg, 4, r)
            assert (use.model, use.grad) == ((True, "sum") if name in ("wk", "wv") else (False, "local"))


def test_rows_split_as_repro_anchors_them(world):
    """tp_fsdp splits each micro-batch's rows over "data" (its anchor);
    zero3 over every axis (four rows a micro-batch), as ``_zero3_dp_axes``."""
    assert world["qwen-tp_fsdp"][0]["row_axes"] == ("data",)
    assert world["qwen-zero3"][0]["row_axes"] == ("data", "model")
    assert world["jamba-zero3"][0]["row_axes"] == ("data",)


@pytest.mark.parametrize("cid", ["qwen-tp_fsdp", "qwen-zero3", "kimi-tp_fsdp"])
def test_sharded_step_matches_one_process_step(world, cid):
    """The ranks against the port's own one-process ``make_train_step`` under
    the config the step anchors (the MoE routed by row, layers
    rematerialised under zero3), from the same weights and batch."""
    _, arch, strategy, opt_name, hyper, _, changes = BY_ID[cid]
    cfg = _cfgs(arch, changes)[1]
    if strategy == "zero3":
        cfg = cfg.replace(act_sharding=(("data", "model"), None, None), remat_blocks=True)
    else:
        cfg = act_anchor_for(cfg, make_local_mesh(2, 2), B, M)
    params, batch = _inputs(cid)
    full = bridge.params_from_repro(params, cfg, device="cpu")
    layout = reference_layout(cfg, full) if opt_name == "adafactor" else None
    opt = make_optimizer(opt_name, constant_schedule(1e-3), layout=layout, **hyper)
    step = make_train_step(lambda p, b: api.loss_fn(p, cfg, b), opt, num_microbatches=M)
    state = create_train_state(full, opt)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    r0 = world[cid][0]
    _compare(r0["metrics"], r0["state"], metrics, rank_checks.repro_state(state, cfg))


def _row_group_flops(cid, groups: int) -> int:
    """Matmul FLOPs of one step's forwards and backwards in one process on the
    first of ``groups`` row groups of each micro-batch, under the config and
    remat the sharded step runs (the whole loss checkpointed under
    ``tp_fsdp``, each layer under ``zero3``): what a rank computes when its
    peers along "model" repeat its rows' work."""
    _, arch, strategy, *_, changes = BY_ID[cid]
    cfg = _cfgs(arch, changes)[1]
    if strategy == "zero3":
        cfg = cfg.replace(act_sharding=(("data", "model"), None, None), remat_blocks=True)
    else:
        cfg = act_anchor_for(cfg, make_local_mesh(2, 2), B, M)
    params, batch = _inputs(cid)
    leaves = tree_map(lambda t: t.requires_grad_(True), bridge.params_from_repro(params, cfg, device="cpu"))
    with FlopCounterMode(display=False) as counter:
        for mb in _microbatches({k: torch.from_numpy(v) for k, v in batch.items()}, M):
            rows = {k: v[: v.shape[0] // groups] for k, v in mb.items()}

            def loss(rows=rows):
                return api.loss_fn(leaves, cfg, rows)[0]

            (checkpoint(loss, use_reentrant=False) if strategy == "tp_fsdp" else loss()).backward()
    return counter.get_total_flops()


def test_tp_fsdp_ranks_along_model_split_the_work(world):
    """qwen1.5-4b smoke: under ``tp_fsdp`` each rank's matmul FLOPs in a step
    are half of what its row group costs unsplit (the tensor-parallel
    products split every matmul of a dense model over the two ranks along
    "model"; no leaf of it is gathered whole), where before the ranks
    along "model" each did the whole; under ``zero3`` each rank's count is
    its own row's, unchanged."""
    tp = [r["flops"] for r in world["qwen-tp_fsdp"]]
    z3 = [r["flops"] for r in world["qwen-zero3"]]
    unsplit = _row_group_flops("qwen-tp_fsdp", 2)
    assert len(set(tp)) == 1 and len(set(z3)) == 1
    assert 0.5 <= tp[0] / unsplit <= 0.5 + 1e-3, (tp[0], unsplit)
    assert z3[0] == _row_group_flops("qwen-zero3", 4), (z3[0],)


def test_grouped_load_balance_over_split_rows_equals_the_whole():
    """Two ranks' halves of a micro-batch, each with the other's expert counts
    summed in (the ``row_sum`` the ranks do with an all-reduce): the mean of
    their load-balance terms, and its gradient with respect to the router and
    the tokens, equal the term over the whole micro-batch."""
    cfg = get_arch("kimi-k2-1t-a32b").smoke.replace(dtype=torch.float32)
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    router = p["router"]["w"].detach().requires_grad_(True)
    x = torch.randn(4, 8, cfg.d_model, generator=torch.Generator().manual_seed(1), requires_grad=True)
    q = {**p, "router": {"w": router}}
    whole = moe.moe_apply_grouped(q, x, cfg)[1]["load_balance"]
    g_whole = torch.autograd.grad(whole, (router, x))
    halves = x.split(2)
    counts = [torch.bincount(moe.route(q, h.detach(), cfg)["idx"].reshape(-1), minlength=cfg.num_experts).float()
              for h in halves]
    shares = [moe.moe_apply_grouped(q, h, cfg, row_sum=lambda c, i=i: c + counts[1 - i])[1]["load_balance"]
              for i, h in enumerate(halves)]
    mean = (shares[0] + shares[1]) / 2
    g_mean = torch.autograd.grad(mean, (router, x))
    torch.testing.assert_close(mean, whole, rtol=1e-6, atol=1e-7)
    for got, want in zip(g_mean, g_whole):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-9)
    # the mean of the halves' own terms (no counts summed) is not the term
    plain = [moe.moe_apply_grouped(q, h, cfg)[1]["load_balance"] for h in halves]
    assert abs(float(((plain[0] + plain[1]) / 2 - whole).detach())) > 1e-4


def test_repro_grouped_dispatch_loses_a_kept_token_where_one_is_dropped():
    """jamba smoke, G 3 x S 6, weights of key 3 (ROADMAP.md queue 3): the port's grouped
    MoE equals ``repro``'s flat ``moe_apply`` on each group, and ``repro``'s own
    grouped form does not, in the group that drops an entry (its
    ``slots_one`` writes the dropped entry over expert 0's first slot)."""
    jcfg, cfg = _cfgs("jamba-v0.1-52b", {})
    jp = jax_moe.moe_init(jax.random.PRNGKey(3), jcfg)
    flat = {k: v.copy() for k, v in _flat(jp).items()}  # writable, for torch.from_numpy
    tp = {"router": {"w": torch.from_numpy(flat["router/w"])},
          "experts": {k: torch.from_numpy(flat[f"experts/{k}"]) for k in ("gate", "up", "down")}}
    if "shared/up/w" in flat:
        tp["shared"] = {k: {"w": torch.from_numpy(flat[f"shared/{k}/w"])} for k in ("gate", "up", "down")}
    x = np.random.default_rng(0).standard_normal((3, 6, cfg.d_model)).astype(np.float32)
    y_port, _ = moe.moe_apply_grouped(tp, torch.from_numpy(x), cfg)
    y_flat = np.stack([np.asarray(jax_moe.moe_apply(jp, jnp.asarray(g), jcfg)[0]) for g in x])
    y_repro = np.asarray(jax_moe.moe_apply_grouped(jp, jnp.asarray(x), jcfg)[0])
    keep = moe.route(tp, torch.from_numpy(x), cfg)["keep"]
    assert not bool(keep.all()), "the case must drop an entry"
    np.testing.assert_allclose(y_port.numpy(), y_flat, rtol=1e-5, atol=1e-5)
    dropping = [g for g in range(3) if not bool(keep[g].all())]
    assert dropping and all(np.abs(y_repro[g] - y_flat[g]).max() > 1e-3 for g in dropping)
    np.testing.assert_allclose(np.delete(y_repro, dropping, 0), np.delete(y_flat, dropping, 0), rtol=1e-5, atol=1e-5)
