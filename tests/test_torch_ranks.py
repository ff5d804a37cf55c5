"""The multi-rank pipeline engine (one process per stage) against ``repro``.

Ranks run on the CPU under gloo, through ``repro_torch.pipeline.ranks.spawn``.
Each world is spawned once per module and runs its whole list of cases
inside the ranks (as ``tests/test_pipeline_engine.py``'s ``_SPMD_SCRIPT``
does for ``repro``'s engine); the parametrised tests read the per-case
results.  Weights are drawn with numpy and carried to both packages by the
bridge; tokens and labels are made with numpy from a seed.

The config is ``repro``'s spmd-test one (dense, d_model 48, 4 heads, 2
key/value heads, d_ff 96, vocabulary 128, fp32), with 4 layers (8 where
``v = 2``), b = 2 and T = 16, at S = 4 ranks.  M is 8, not that test's 4:
the parity lists' interleaved rows at k = 2 need the group count a
multiple of S (M / k = 4 at S = 4).  The lists' per-stage vectors were
written for S = 2; at S = 4 each is repeated, ``(a, b) -> (a, b, a, b)``.

Tolerances: loss relative 1e-5, gradients absolute 5e-6 (``repro``'s spmd
limits, ``tests/test_pipeline_engine.py:332-339``), against
``jax.value_and_grad`` of ``repro``'s unpipelined ``full_loss``, against
``repro``'s own ``make_pipeline_step`` and against the port's one-process
engine.  Three optimizer steps: 1e-5 of each tensor's largest entry (the
limit of ``tests/test_torch_pipeline.py``'s optimizer tests).
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

from repro.core.kinds import ScheduleSpec as JaxSpec
from repro.core.schedule import make_plan as jax_make_plan
from repro.models.common import ModelConfig as JaxConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jax_schedules
from repro.pipeline.engine import reference_pipeline_grads as jax_reference_pipeline_grads
from repro.pipeline.stage import StagedModel as JaxStaged
from repro.training import create_train_state as jax_create_train_state
from repro_torch import bridge
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.launch import train
from repro_torch.models.common import ModelConfig
from repro_torch.optim import make_optimizer, schedules
from repro_torch.pipeline import StagedModel, rank_checks, ranks, reduce_replicated, reference_pipeline_grads
from repro_torch.pipeline.engine import _NUM_CH, _channel_tables
from repro_torch.training import create_train_state, make_pipeline_train_step
from test_torch_pipeline import GPT_SMALL, _close, _draw, _flat, _jax_tree_like
from test_torch_pipeline import _data as _tiny_data
from test_torch_pipeline import _staged as _tiny_staged
from test_torch_schedule import FAMILY_PARITY_CASES, SAVED_RESIDUAL_PARITY_CASES

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SPMD = dict(name="tiny", family="dense", d_model=48, num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=128)
S, B, T = 4, 2, 16
REPLICATED = ("embed", "final_norm")


def _lift(x):
    """A per-stage vector of the S = 2 lists, repeated to S = 4."""
    return x * 2 if isinstance(x, tuple) else x


def _spec(kind, k, v, w, pol=None):
    kw = dict(kind=kind, k=k, num_virtual=v, extra_warmup=_lift(w))
    if pol is not None:
        kw["zb_policy"] = _lift(pol)
    return kw


#: (id, ScheduleSpec keywords, S, D, M): the family and saved-residual lists
#: at S = 4; the two plans held to repro's own engine (M = 4, where its
#: shard_map program compiles in ~75 s here); the data-axis plans at S = 2 x D = 2
FAMILY = [(f"{kind}-k{k}-v{v}-w{w}", _spec(kind, k, v, w), S, 1, 8) for kind, k, v, w in FAMILY_PARITY_CASES]
SAVED_RESIDUAL = [
    (f"sr-{kind}-k{k}-v{v}-w{w}-{pol}", _spec(kind, k, v, w, pol), S, 1, 8)
    for kind, k, v, w, pol in SAVED_RESIDUAL_PARITY_CASES
]
AGAINST_REPRO = [("repro-kfkb-k2", dict(kind="kfkb", k=2), S, 1, 4), ("repro-zbv", dict(kind="zbv"), S, 1, 4)]
DATA_AXIS = [("data-kfkb-k2", dict(kind="kfkb", k=2), 2, 2, 8), ("data-zb_h1-k2", dict(kind="zb_h1", k=2), 2, 2, 8)]
WORLD_S4 = FAMILY + SAVED_RESIDUAL + AGAINST_REPRO
CASES = {c[0]: c for c in WORLD_S4 + DATA_AXIS}


def _cfgs(L):
    return (
        JaxConfig(**SPMD, num_layers=L, dtype=jnp.float32, param_dtype=jnp.float32),
        ModelConfig(**SPMD, num_layers=L, dtype=torch.float32, param_dtype=torch.float32),
    )


@functools.lru_cache
def _weights(V, L):
    """``repro``'s staged model and numpy-drawn weights (replicated groups
    equal on every stage), as JAX arrays and as the flat numpy tree."""
    jstaged = JaxStaged.build(_cfgs(L)[0], V)
    jparams = _draw(jstaged.init_all_stages, V, stacked=True)
    return jstaged, jparams, _flat(jparams)


@functools.lru_cache
def _data(M):
    rng = np.random.default_rng(0)
    return rng.integers(0, SPMD["vocab_size"], (M, B, T)), rng.integers(0, SPMD["vocab_size"], (M, B, T))


def _case(cid):
    """The case dict the ranks run, its virtual stages and its layers (two
    a virtual stage at S = 2, one at S = 4; four per rank either way)."""
    _, kw, S_, _, M = CASES[cid]
    V = make_plan(S_, M, spec=ScheduleSpec(**kw)).total_virtual_stages
    L = 4 * V // S_
    tokens, labels = _data(M)
    return dict(cfg=_cfgs(L)[1], spec=kw, M=M, tokens=tokens, labels=labels, params=_weights(V, L)[2]), V, L


def _summed(grads: dict) -> dict:
    """Each replicated leaf's copies summed and written into every copy, as
    ``repro``'s engine leaves them."""
    return {
        k: np.broadcast_to(g.sum(axis=0), g.shape) if k.split("/")[0] in REPLICATED else g
        for k, g in grads.items()
    }


@functools.lru_cache
def _oracle(V, L, M):
    """``jax.value_and_grad`` of ``repro``'s mean unpipelined ``full_loss``,
    the replicated copies' gradients summed."""
    jstaged, jparams, _ = _weights(V, L)
    tokens, labels = (jnp.asarray(a, jnp.int32) for a in _data(M))

    def mean_loss(p):  # vmapped over the micro-batches: one traced copy of the model
        return jax.vmap(jstaged.full_loss, in_axes=(None, 0, 0))(p, tokens, labels).mean()

    loss, grads = jax.jit(jax.value_and_grad(mean_loss))(jparams)
    return float(loss), _summed(_flat(grads))


def _check(got_loss, got_grads, want_loss, want_grads):
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got_grads) == sorted(want_grads)
    for key, want in want_grads.items():
        np.testing.assert_allclose(got_grads[key], want, atol=5e-6, err_msg=key)


# -- repro's own engine, in a subprocess with four host devices ------------------------

_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import _path_str
    from repro.core.kinds import ScheduleSpec
    from repro.core.schedule import make_plan
    from repro.models.common import ModelConfig
    from repro.pipeline.engine import make_pipeline_step
    from repro.pipeline.stage import StagedModel

    inp, cases = np.load(sys.argv[1]), json.loads(sys.argv[3])
    # jax 0.9's make_mesh types its axes Explicit, under which the engine's
    # placement gather for v > 1 (engine.py:847) cannot resolve its sharding
    mesh = jax.make_mesh((4,), ("stage",), axis_types=(jax.sharding.AxisType.Auto,))
    out = {}
    for name, kw, cfg_kw, M in cases:
        cfg = ModelConfig(**cfg_kw, dtype=jnp.float32, param_dtype=jnp.float32)
        plan = make_plan(4, M, spec=ScheduleSpec(**kw))
        staged = StagedModel.build(cfg, plan.total_virtual_stages)
        shapes = jax.eval_shape(staged.init_all_stages, jax.random.PRNGKey(0))
        leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        params = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(inp[name + "/params/" + _path_str(p)]) for p, _ in leaves])
        tokens, labels = (jnp.asarray(inp[name + "/" + k], jnp.int32) for k in ("tokens", "labels"))
        loss, grads = jax.jit(make_pipeline_step(staged, plan, mesh))(params, tokens, labels)
        out[name + "/loss"] = np.asarray(loss)
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[name + "/grads/" + _path_str(p)] = np.asarray(g)
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def repro_engine(tmp_path_factory):
    """Starts ``repro``'s ``make_pipeline_step`` on the AGAINST_REPRO cases
    in a subprocess (it runs while the ranks do); calling the fixture's
    value waits for it and returns ``{case: (loss, flat grads)}``."""
    tmp = tmp_path_factory.mktemp("repro_engine")
    arrays, cases = {}, []
    for cid, kw, _, _, M in AGAINST_REPRO:
        case, V, L = _case(cid)
        arrays.update({f"{cid}/params/{k}": a for k, a in case["params"].items()})
        arrays[f"{cid}/tokens"], arrays[f"{cid}/labels"] = case["tokens"], case["labels"]
        cases.append((cid, kw, dict(SPMD, num_layers=L), M))
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPRO_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps(cases)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    @functools.lru_cache
    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(tmp / "out.npz")
        return {
            cid: (float(got[f"{cid}/loss"]),
                  {k[len(cid) + 7:]: got[k] for k in got.files if k.startswith(f"{cid}/grads/")})
            for cid, *_ in AGAINST_REPRO
        }

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _spawn_cases(cids, S_, D):
    cases = [_case(cid)[0] for cid in cids]
    per_rank = ranks.spawn(rank_checks.engine_matrix, S_, D, args=(cases,), device="cpu", timeout=600)
    return {cid: [r[i] for r in per_rank] for i, cid in enumerate(cids)}


@pytest.fixture(scope="module")
def world_s4(repro_engine):
    """Every S = 4 case through the engine on four gloo ranks (one spawn)."""
    return _spawn_cases([c[0] for c in WORLD_S4], S, 1)


@pytest.fixture(scope="module")
def world_data_axis():
    """The data-axis cases on S = 2 x D = 2 gloo ranks (one spawn)."""
    return _spawn_cases([c[0] for c in DATA_AXIS], 2, 2)


def _results(world, cid):
    """(rank 0's loss, its gathered gradients) of a case; every rank agrees on the loss."""
    per_rank = world[cid]
    assert len({r["loss"] for r in per_rank}) == 1, [r["loss"] for r in per_rank]
    return per_rank[0]["loss"], per_rank[0]["grads"]


# -- the engine against the oracle, repro's engine and the one-process engine ----------


@pytest.mark.parametrize("cid", [c[0] for c in FAMILY])
def test_ranks_family_match_full_loss(world_s4, cid):
    _, V, L = _case(cid)
    _check(*_results(world_s4, cid), *_oracle(V, L, CASES[cid][4]))


@pytest.mark.parametrize("cid", [c[0] for c in SAVED_RESIDUAL])
def test_ranks_saved_residual_match_full_loss(world_s4, cid):
    _, V, L = _case(cid)
    _check(*_results(world_s4, cid), *_oracle(V, L, CASES[cid][4]))


@pytest.mark.parametrize("cid", [c[0] for c in FAMILY + SAVED_RESIDUAL])
def test_ranks_match_the_one_process_engine(world_s4, cid):
    case, V, _ = _case(cid)
    plan = make_plan(S, case["M"], spec=ScheduleSpec(**case["spec"]))
    staged = StagedModel.build(case["cfg"], V)
    params = bridge.staged_params_from_repro(case["params"], staged, device="cpu")
    tokens, labels = (torch.from_numpy(case[k]) for k in ("tokens", "labels"))
    loss, grads = reference_pipeline_grads(staged, params, tokens, labels, plan)
    want = bridge.staged_params_to_repro(reduce_replicated(grads), staged)
    _check(*_results(world_s4, cid), float(loss), want)


@pytest.mark.parametrize("cid", [c[0] for c in AGAINST_REPRO])
def test_ranks_match_repro_make_pipeline_step(world_s4, repro_engine, cid):
    """``repro``'s shard_map engine under kfkb k = 2 and ZB-V (which sends
    on both ring directions and keeps its turn on the LOOP channel)."""
    _, V, L = _case(cid)
    _check(*_results(world_s4, cid), *repro_engine()[cid])
    _check(*_results(world_s4, cid), *_oracle(V, L, CASES[cid][4]))


@pytest.mark.parametrize("cid", [c[0] for c in WORLD_S4])
def test_in_flight_queues_fill_to_the_channel_capacities(world_s4, cid):
    """Every rank posts a receive at the end of the tick its payload
    arrives and pops it in its task: each channel queue stays within the
    tables' capacity, and the deepest one over the ranks reaches it
    exactly on every channel that carries traffic."""
    case, _, _ = _case(cid)
    plan = make_plan(S, case["M"], spec=ScheduleSpec(**case["spec"]))
    send_f, send_b, *_, caps_f, caps_b = _channel_tables(plan, plan.lower().grid)
    per_rank = world_s4[cid]
    for kind, sends, caps in (("f", send_f, caps_f), ("b", send_b, caps_b)):
        for ch in range(_NUM_CH):
            depths = [r["max_in_flight"][kind][ch] for r in per_rank]
            assert all(r["caps"][kind][ch] == caps[ch] for r in per_rank)
            assert max(depths) == (caps[ch] if sends[ch].any() else 0), (kind, ch, depths, caps[ch])


@pytest.mark.parametrize("cid", [c[0] for c in DATA_AXIS])
def test_data_axis_matches_full_loss(world_data_axis, cid):
    """S = 2 stages x D = 2 replicas, each replica on half of every
    micro-batch; the gradients and the loss averaged over the replicas."""
    _, V, L = _case(cid)
    _check(*_results(world_data_axis, cid), *_oracle(V, L, CASES[cid][4]))
    for r in world_data_axis[cid]:
        assert (r["rank"] == 0) == ("grads" in r)


# -- three optimizer steps ------------------------------------------------------------


def test_three_pipeline_train_steps_match_reference_and_repro():
    """``pipeline_train_step`` on two ranks (kfkb k = 2, lr 3e-4, clip 1)
    against the port's one-process ``make_pipeline_train_step`` and against
    ``repro``'s reference engine with the replicated copies' gradients
    summed (as its ``make_pipeline_step`` sums them) and its optimizer.  A
    clip norm reduced over the wrong ranks, or a rank's 1-D leaves left
    undecayed, moves a parameter by more than the limit."""
    S_, lr = 2, 3e-4
    jstaged, jparams, staged, params = _tiny_staged(S_, **GPT_SMALL)
    steps = [_tiny_data(20 + i) for i in range(3)]
    case = dict(cfg=staged.cfg, spec=dict(kind="kfkb", k=2), M=steps[0][0].shape[0], tokens=steps[0][0],
                labels=steps[0][1], params=bridge.staged_params_to_repro(params, staged))
    got = ranks.spawn(rank_checks.train_steps, S_, args=(case, lr, steps), device="cpu", timeout=300)[0]
    # rank_params and gather_to_rank0 round-trip the weights bitwise
    assert sorted(got["initial"]) == sorted(case["params"])
    for key, want in case["params"].items():
        assert np.array_equal(got["initial"][key], want), key

    plan = make_plan(S_, case["M"], spec=ScheduleSpec(kind="kfkb", k=2))
    opt = make_optimizer("adamw", schedules.constant_schedule(lr))
    state = create_train_state(params, opt)
    step = make_pipeline_train_step(staged, plan, opt)
    jplan = jax_make_plan(S_, case["M"], spec=JaxSpec(kind="kfkb", k=2))
    jopt = jax_make_optimizer("adamw", jax_schedules.constant_schedule(lr))
    jstate = jax_create_train_state(jparams, jopt)
    grads_fn = jax.jit(lambda p, t, l: jax_reference_pipeline_grads(jstaged, p, t, l, jplan))
    update = jax.jit(jopt.update)
    jp, jo = jstate.params, jstate.opt_state
    for i, ((tokens, labels), r) in enumerate(zip(steps, got["steps"])):
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(labels))
        jloss, jgrads = grads_fn(jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(labels, jnp.int32))
        jp, jo, jm = update(jp, _jax_tree_like(jp, _summed(_flat(jgrads))), jo)
        _close(r["loss"], float(m["loss"]), 1e-5, f"loss, step {i}")
        _close(r["loss"], jloss, 1e-5, f"loss vs repro, step {i}")
        _close(r["grad_norm"], float(m["grad_norm"]), 1e-5, f"clip norm, step {i}")
        _close(r["grad_norm"], jm["grad_norm"], 1e-5, f"clip norm vs repro, step {i}")
        ref, want = bridge.staged_params_to_repro(state.params, staged), _flat(jp)
        for key in want:
            _close(r["params"][key], ref[key], 1e-5, f"step {i}: {key}")
            _close(r["params"][key], want[key], 1e-5, f"step {i} vs repro: {key}")


# -- units ----------------------------------------------------------------------------


@pytest.mark.parametrize("owned", [[0], [2, 1], [3, 0], [1, 2, 3]])
def test_init_stages_equals_init_all_stages(owned):
    staged = StagedModel.build(_cfgs(8)[1], 4)
    full = staged.init_all_stages(torch.Generator().manual_seed(5))
    mine = staged.init_stages(torch.Generator().manual_seed(5), owned)
    assert len(mine) == len(owned)
    for tree, j in zip(mine, owned):
        a, b = bridge.flatten(tree), bridge.flatten(full[j])
        assert sorted(a) == sorted(b)
        for key in a:
            assert torch.equal(a[key], b[key]), (j, key)


def _fail_on_rank_1(group):
    """Rank 1 raises while rank 0 waits in a receive that never comes."""
    if group.rank == 1:
        raise ValueError("rank 1 gives up")
    (h,) = group.exchange([], [((4,), torch.float32, 1, 0)])
    h.wait()


def test_spawn_raises_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        ranks.spawn(_fail_on_rank_1, 2, device="cpu", timeout=120)


def test_ranks_launcher_on_cpu_trains_and_starts_where_the_one_process_engine_does(tmp_path):
    """``--mode pipeline`` on two gloo ranks; its first loss is the
    one-process engine's on the same seed (each rank draws its own stages)."""
    out = tmp_path / "ranks.json"
    args = dict(layers=4, stages=2, k=2, steps=3, batch=8, seq=32, microbatches=4, lr=3e-4, warmup=1)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "pipeline", "--gpt", "GPT-Medium",
           "--device", "cpu", "--log-every", "1", "--out", str(out)]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = json.loads(out.read_text())
    assert (s["engine"], s["ranks"], s["transport"], s["device_count"], s["device"]) == ("ranks", 2, "gloo", 0, "cpu")
    assert [r["rank"] for r in s["per_rank"]] == [0, 1] and s["flash_launches"] == 0
    assert len(s["losses"]) == 3 and np.isfinite(s["losses"] + s["grad_norms"]).all()
    assert s["losses"][-1] < s["losses"][0]
    cfg = train.GPT_CONFIGS["GPT-Medium"].replace(num_layers=4, vocab_size=1024, dtype=torch.float32)
    ref = train.run_pipeline(
        cfg, 2, ScheduleSpec(kind="kfkb", k=2, micro_batch_size=2), steps=1, batch=8, seq=32, microbatches=4,
        lr=3e-4, warmup=1, device="cpu", engine="reference",
    )
    assert s["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-5)
    assert s["grad_norms"][0] == pytest.approx(ref["grad_norms"][0], rel=1e-5)


def test_ranks_launcher_profiles_one_more_step_on_rank_0(tmp_path):
    """``--mode pipeline --profile`` on two gloo ranks: every rank steps
    twice more and rank 0 reports its timed and traced step."""
    out = tmp_path / "profiled.json"
    args = dict(layers=2, stages=2, k=2, steps=3, batch=8, seq=32, microbatches=4, lr=3e-4, warmup=1)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "pipeline", "--gpt", "GPT-Medium",
           "--device", "cpu", "--profile", "--out", str(out)]
    for k, v in args.items():
        cmd += [f"--{k}", str(v)]
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "profiled step: wall" in proc.stdout
    s = json.loads(out.read_text())
    p = s["profile"]
    assert s["engine"] == "ranks" and len(s["losses"]) == 3
    assert p["wall_ms"] > 0 and p["device_ms"] == 0 and p["flash_ms"] == 0  # the CPU has no device kernels
    assert p["device_busy_share"] == 0 and isinstance(p["top"], list)
