"""``PlanRuntime``'s ``spmd`` backend (one process per stage) against ``repro``.

Ranks run on the CPU under gloo, through ``repro_torch.pipeline.ranks.spawn``,
one world per module fixture (``rank_checks.runtime_checks`` runs every
item of a world inside the ranks).  Weights come from ``repro``'s init,
carried across by the bridge; tokens and labels are made with numpy from a
seed.  The config is ``tests/test_torch_runtime.py``'s ``TINY`` (dense,
d_model 16, fp32) with 8 layers at S = 4 (one layer a virtual stage where
v = 2) and 4 at S = 2 x D = 2; M = 4 micro-batches of b = 2 x T = 8.

* (a) The walk kfkb k = 1 -> zb_h1 -> interleaved_zb (v = 2) -> zbv ->
  kfkb on four ranks: every iteration's loss, state (parameters, AdamW
  ``m`` and ``v``) and gradients, gathered to rank 0, against ``repro``'s
  semantics from the state the ranks had before the step (``_Oracle``):
  the gradients of its unpipelined ``full_loss`` with each replicated
  group's replaced by the sum over its copies (what its ``shard_map``
  engine's psum does), its ``restack_train_state`` where v changed, and its
  optimizer; atol 5e-6, ``repro``'s limit for the switch walk (fp32; the
  two differ by summation order).  ``repro``'s ``reference_pipeline_grads``
  computes the same per-copy gradients (``tests/test_pipeline_engine.py``);
  jitted at S = 4 it takes ~95 s to build for these four plans, so the
  oracle takes ``full_loss``'s, and (b) holds the ranks to ``repro``'s
  pipelined engine.
* (b) ``repro``'s own ``PlanRuntime(backend="spmd")`` in a subprocess with
  four host devices and an ``AxisType.Auto`` mesh, over the segments it can
  run under jax 0.9 (kfkb -> zb_h1 -> interleaved_zb; ROADMAP queue 3),
  from the same initial state and data: every iteration's loss and
  gradients within 5e-6 (its states follow its own trajectory, which parts
  from the ranks' in one entry at AdamW's first step; see ``_Oracle``).
* (c) Every rank's copy of ``embed`` / ``final_norm`` (and of their
  moments) stays bitwise equal to every other rank's, in the flat layout
  after each iteration (what lets a restack clone a rank's own copy instead
  of moving one).
* (d) The data axis, S = 2 x D = 2, walking kfkb -> interleaved_zb -> kfkb
  against the data-axis oracle of ``tests/test_torch_ranks.py``
  (``jax.value_and_grad`` of ``full_loss``, the copies summed), with
  ``repro``'s optimizer and restack.
* (e) The tiny Fig-10 scenario on four ranks meets ``repro``'s gates, and
  its trail is the decision layer's alone.
* (f) ``train_adaptive --backend spmd`` on the CPU.
* (g) ``restack_across_ranks`` A -> B -> A returns every rank's state
  bitwise for every pair of the Fig-10 plans and zbv, and the state in
  the middle equals the one-process restack of the whole state.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.core import ScheduleSpec as JSpec
from repro.core import make_plan as jmake_plan
from repro.models.common import ModelConfig as JConfig
from repro.pipeline.stage import StagedModel as JStaged
from repro.runtime import restack_train_state as jrestack
from repro.training import TrainState as JTrainState
from repro.training import create_train_state as jcreate_train_state
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.core.schedule import Placement
from repro_torch.launch import train_adaptive
from repro_torch.models.common import ModelConfig
from repro_torch.optim import make_optimizer
from repro_torch.pipeline import rank_checks, ranks
from repro_torch.runtime import PlanRuntime
from repro_torch.runtime.executor import _dtype_sizes, _layer_homes, _pack, _rounds, _unpack
from test_torch_runtime import TINY, _flat, _jopt

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REPLICATED = ("embed", "final_norm")
M, b, T = 4, 2, 8
B = M * b
LR = 1e-3

#: the walks: (ScheduleSpec keywords, iterations under the plan)
WALK = [
    (dict(kind="kfkb", k=1), 2),
    (dict(kind="zb_h1"), 1),
    (dict(kind="interleaved_zb", num_virtual=2), 2),
    (dict(kind="zbv"), 1),
    (dict(kind="kfkb", k=1), 1),
]
#: the segments repro's spmd runtime runs under jax 0.9 (the switch back to
#: v = 1 fails there; ROADMAP queue 3)
REPRO_SEGMENTS = WALK[:3]
DATA_WALK = [(dict(kind="kfkb", k=1), 1), (dict(kind="interleaved_zb", num_virtual=2), 1), (dict(kind="kfkb", k=1), 1)]
#: the Fig-10 candidates and zbv
PAIR_PLANS = [
    dict(kind="kfkb", k=1), dict(kind="kfkb", k=2), dict(kind="zb_h1"), dict(kind="zb_h2", extra_warmup=2),
    dict(kind="interleaved_zb", num_virtual=2), dict(kind="zbv"),
]
PAIRS = [(a, c) for a in range(len(PAIR_PLANS)) for c in range(len(PAIR_PLANS)) if a != c]


def _cfgs(L):
    return (
        JConfig(**{**TINY, "num_layers": L}, dtype=jnp.float32, param_dtype=jnp.float32),
        ModelConfig(**{**TINY, "num_layers": L}, dtype=torch.float32, param_dtype=torch.float32),
    )


def _walk_iterations(walk) -> int:
    return sum(n for _, n in walk)


@functools.lru_cache
def _data(n):
    """One ``[B, T]`` batch of tokens and labels an iteration (numpy)."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        out.append(tuple(rng.integers(0, TINY["vocab_size"], (B, T)) for _ in range(2)))
    return out


@functools.lru_cache
def _initial(S, L):
    """``repro``'s initial flat training state (zero moments) as numpy."""
    jstaged = JStaged.build(_cfgs(L)[0], S)
    return _flat(jcreate_train_state(jstaged.init_all_stages(jax.random.PRNGKey(0)), _jopt()))


def _walk_case(S, L, walk):
    return dict(cfg=_cfgs(L)[1], M=M, b=b, T=T, lr=LR, walk=walk, data=_data(_walk_iterations(walk)),
                state=_initial(S, L))


def _summed(grads):
    """Each replicated group's gradient summed over its copies, in every copy."""
    return {
        k: jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x.sum(0), x.shape), g) if k in REPLICATED else g
        for k, g in grads.items()
    }


class _Oracle:
    """``repro``'s semantics, one step at a time, for a walk at S stages and
    L layers: :meth:`prepare` builds (and warms) the jitted programs of each
    layout while the ranks run; :meth:`steps` then holds each iteration of
    the ranks' walk from the state the ranks had before it.

    Per iteration it gives ``(loss, state, grads)``: ``repro``'s loss and
    gradients (``jax.value_and_grad`` of the mean unpipelined ``full_loss``,
    each replicated group's gradient summed over its copies) at the ranks'
    state before the step, restacked by ``repro``'s ``restack_train_state``
    where v changed, and ``repro``'s optimizer applied to that state with the
    RANKS' gradients; both compared in the flat layout (the replicated
    copies are equal, so a collapse loses nothing).  Each step is held on its own because two correct
    fp32 trajectories part where AdamW's first step divides a gradient of
    about ``eps`` (1e-8) by its own magnitude: here one ``wk`` entry has a
    gradient of -9.84e-9 on the ranks and -1.11e-8 in ``repro`` (a
    summation-order difference of 1.3e-9), which moves the parameter by
    1.8e-5 (lr 1e-3)."""

    def __init__(self, S: int, L: int):
        self.S, self.jcfg, self.jopt = S, _cfgs(L)[0], _jopt()
        self.initial = jcreate_train_state(JStaged.build(self.jcfg, S).init_all_stages(jax.random.PRNGKey(0)), self.jopt)
        self.grads, self.update = {}, jax.jit(self.jopt.update)

    def prepare(self, walk):
        tok = jnp.zeros((M, b, T), jnp.int32)
        for kw, _ in walk:
            v = jmake_plan(self.S, M, spec=JSpec(micro_batch_size=b, **kw)).num_virtual
            if v in self.grads:
                continue
            like = jrestack(self.initial, self.S, 1, v)
            self.grads[v] = jax.jit(_full_loss_grads(JStaged.build(self.jcfg, self.S * v)))
            jax.block_until_ready(self.grads[v](like.params, tok, tok))
            jax.block_until_ready(self.update(like.params, like.params, like.opt_state))

    def steps(self, walk, got):
        """``got``: the ranks' iterations, state and gradients in the flat
        layout; so is what this returns."""
        S, out, i = self.S, [], 0
        prev = _flat(self.initial)
        data = _data(_walk_iterations(walk))
        for kw, n in walk:
            v = jmake_plan(S, M, spec=JSpec(micro_batch_size=b, **kw)).num_virtual
            for _ in range(n):
                state = jrestack(_unflat(prev, self.initial), S, 1, v)
                tok, lab = (jnp.asarray(a.reshape(M, b, T), jnp.int32) for a in data[i])
                loss, grads = self.grads[v](state.params, tok, lab)
                ranks_grads = jrestack(_unflat(got[i]["grads"], self.initial.params), S, 1, v)
                params, opt_state, _ = self.update(state.params, ranks_grads, state.opt_state)
                after = jrestack(JTrainState(state.step + 1, params, opt_state), S, v, 1)
                out.append((float(loss), _flat(after), _flat(jrestack(_summed(grads), S, v, 1))))
                prev, i = got[i]["state"], i + 1
        return out


def _unflat(flat: dict, like):
    """A JAX tree like ``like`` from its flat numpy dictionary."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])


def _full_loss_grads(staged):
    """``jax.value_and_grad`` of the mean unpipelined ``full_loss`` over the
    micro-batches, a gradient per copy (``tests/test_torch_ranks.py``'s
    oracle); one program per layout (the plan does not enter it)."""

    def grads(p, tokens, labels):
        mean = lambda q: jax.vmap(staged.full_loss, in_axes=(None, 0, 0))(q, tokens, labels).mean()  # noqa: E731
        return jax.value_and_grad(mean)(p)

    return grads


def _check(got, want, what):
    """``want``: ``(loss, state, grads)``, the state ``None`` to leave it out."""
    loss, state, grads = want
    assert got["loss"] == pytest.approx(loss, abs=5e-6), what
    for tree, ref in (("state", state), ("grads", grads)):
        if ref is None:
            continue
        assert sorted(got[tree]) == sorted(ref), (what, tree)
        for key, a in ref.items():
            np.testing.assert_allclose(got[tree][key], a, atol=5e-6, err_msg=f"{what}: {tree} {key}")


# -- repro's own spmd runtime, in a subprocess with four host devices -----------------

_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint.io import _path_str
    from repro.core.kinds import ScheduleSpec
    from repro.core.schedule import make_plan
    from repro.models.common import ModelConfig
    from repro.optim import make_optimizer
    from repro.runtime import PlanRuntime, restack_train_state

    inp = np.load(sys.argv[1])
    cfg_kw, S, M, b, T, walk = json.loads(sys.argv[3])
    cfg = ModelConfig(**cfg_kw, dtype=jnp.float32, param_dtype=jnp.float32)
    opt = make_optimizer("adamw", schedule=lambda s: jnp.float32(1e-3))
    # jax 0.9's make_mesh types its axes Explicit, under which the engine's
    # placement gather for v > 1 cannot resolve its sharding
    mesh = jax.make_mesh((S,), ("stage",), axis_types=(jax.sharding.AxisType.Auto,))
    rt = PlanRuntime(cfg, S, opt, global_batch=M * b, seq_len=T, backend="spmd", mesh=mesh)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(rt.state)
    state = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(inp["state/" + _path_str(p)]) for p, _ in leaves])
    rt.state = jax.device_put(state, rt._state_sharding(1))
    out, i = {}, 0
    for kw, n in walk:
        plan = make_plan(S, M, spec=ScheduleSpec(micro_batch_size=b, **kw))
        rt.switch_to(plan.lower())
        for _ in range(n):
            r = rt.run_iteration(inp[f"tokens/{i}"], inp[f"labels/{i}"])
            out[f"{i}/loss"] = np.asarray(r.loss)
            grads = restack_train_state(rt.last_grads, S, plan.num_virtual, 1)
            for p, x in jax.tree_util.tree_flatten_with_path(grads)[0]:
                out[f"{i}/grads/{_path_str(p)}"] = np.asarray(x)
            i += 1
    rt.cache.shutdown()
    np.savez(sys.argv[2], **out)
    """
)


@pytest.fixture(scope="module")
def repro_spmd(tmp_path_factory):
    """Starts ``repro``'s spmd runtime over REPRO_SEGMENTS in a subprocess
    (it runs while the ranks do); calling the fixture's value waits for it
    and returns per iteration ``{"loss", "grads"}`` (the gradients in the
    flat layout)."""
    S, L = 4, 8
    tmp = tmp_path_factory.mktemp("repro_spmd")
    n = _walk_iterations(REPRO_SEGMENTS)
    arrays = {f"state/{k}": a for k, a in _initial(S, L).items()}
    for i, (tok, lab) in enumerate(_data(_walk_iterations(WALK))[:n]):
        arrays[f"tokens/{i}"], arrays[f"labels/{i}"] = tok, lab
    np.savez(tmp / "in.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    spec = json.dumps([dict(TINY, num_layers=L), S, M, b, T, REPRO_SEGMENTS])
    proc = subprocess.Popen(
        [sys.executable, "-c", _REPRO_SCRIPT, str(tmp / "in.npz"), str(tmp / "out.npz"), spec],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    @functools.lru_cache
    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        got = np.load(tmp / "out.npz")
        return [
            {"loss": float(got[f"{i}/loss"]),
             "grads": {k[len(f"{i}/grads/"):]: got[k] for k in got.files if k.startswith(f"{i}/grads/")}}
            for i in range(n)
        ]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _pairs_case():
    """The flat training state of the pairs check: ``repro``'s init with
    AdamW moments drawn at random, each replicated group's moments equal on
    every stage (as the spmd backend keeps them)."""
    S, L = 4, 8
    state = dict(_initial(S, L))
    rng = np.random.default_rng(3)
    for key, a in state.items():
        if key.startswith("opt_state/m/") or key.startswith("opt_state/v/"):
            draw = rng.standard_normal(a.shape[1:] if key.split("/")[2] in REPLICATED else a.shape)
            draw = np.abs(draw) if key.startswith("opt_state/v/") else draw
            state[key] = np.broadcast_to(draw, a.shape).astype(a.dtype).copy()
    return dict(cfg=_cfgs(L)[1], M=M, state=state, plans=[dict(micro_batch_size=b, **kw) for kw in PAIR_PLANS])


@pytest.fixture(scope="module")
def world_s4(repro_spmd):
    """One world of four gloo ranks: the walk, the restack pairs, the tiny
    Fig-10; ``repro``'s oracle walk runs here meanwhile.  Returns ``(rank
    0's results, every rank's results, the oracle walk)``."""
    items = [
        ("walk", _walk_case(4, 8, WALK)),
        ("pairs", _pairs_case()),
        ("fig10", (14, {}, train_adaptive.grad_parity)),
    ]
    oracle = _Oracle(4, 8)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.spawn, rank_checks.runtime_checks, 4, 1, (items,), "cpu", 600)
        oracle.prepare(WALK)
        per_rank = fut.result()
    return per_rank[0], per_rank, oracle.steps(WALK, per_rank[0][0])


@pytest.fixture(scope="module")
def world_data_axis():
    """S = 2 stages x D = 2 replicas walking DATA_WALK, and the oracle."""
    oracle = _Oracle(2, 4)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(ranks.spawn, rank_checks.runtime_checks, 2, 2,
                          ([("walk", _walk_case(2, 4, DATA_WALK))],), "cpu", 600)
        oracle.prepare(DATA_WALK)
        walk = fut.result()[0][0]
    return walk, oracle.steps(DATA_WALK, walk)


# -- (a) the walk against repro's semantics --------------------------------------------


@pytest.mark.parametrize("i", range(_walk_iterations(WALK)))
def test_walk_matches_repro_semantics(world_s4, i):
    walk, _, oracle = world_s4[0][0], world_s4[1], world_s4[2]
    _check(walk[i], oracle[i], f"iteration {i} ({walk[i]['plan']})")


def test_walk_switches_restack_by_placement(world_s4):
    """``restacked`` keeps ``repro``'s meaning (v changed); the layers move
    whenever the placement does, interleaved_zb -> zbv included (same v)."""
    walk = world_s4[0][0]
    firsts = [walk[sum(n for _, n in WALK[:j])] for j in range(len(WALK))]
    assert [r["restacked"] for r in firsts] == [False, False, True, False, True]
    sent = [[r["layers_sent"] for r in f["moved"]] for f in firsts]
    # v 1 -> 2, looped at S = 4 (two layers a rank): ranks 1 and 2 send both
    # of their layers, ranks 0 and 3 one; looped -> V-shaped: every rank its
    # second chunk; zbv -> v = 1: the layers off their flat stage
    assert sent == [[0] * 4, [0] * 4, [1, 2, 2, 1], [1, 1, 1, 1], [1, 2, 1, 2]]
    for f in firsts:
        assert [r["bytes_sent"] for r in f["moved"]] and sum(r["bytes_sent"] for r in f["moved"]) == sum(
            r["bytes_received"] for r in f["moved"])


# -- (b) repro's own spmd runtime ----------------------------------------------------


@pytest.mark.parametrize("i", range(_walk_iterations(REPRO_SEGMENTS)))
def test_walk_matches_repro_spmd_runtime(world_s4, repro_spmd, i):
    walk = world_s4[0][0]
    want = repro_spmd()[i]
    _check(walk[i], (want["loss"], None, want["grads"]), f"iteration {i} ({walk[i]['plan']})")


# -- (c) the replicated copies -------------------------------------------------------


@pytest.mark.parametrize("i", range(_walk_iterations(WALK)))
def test_replicated_copies_stay_bitwise_equal(world_s4, i):
    """Every rank's copy of the parameters and both moments, after
    iteration ``i`` (the flat layout holds a copy a rank)."""
    state = world_s4[0][0][i]["state"]
    keys = [k for k in state if k.split("/")[0] in ("params", "opt_state") and set(k.split("/")) & set(REPLICATED)]
    assert len(keys) == 3 * 3  # embed/table, final_norm/scale and /bias, each in params, m and v
    for key in keys:
        rows = state[key]
        assert all(np.array_equal(rows[0], r) for r in rows[1:]), key


# -- (d) the data axis ---------------------------------------------------------------


@pytest.mark.parametrize("i", range(_walk_iterations(DATA_WALK)))
def test_data_axis_walk_matches_full_loss(world_data_axis, i):
    walk, oracle = world_data_axis
    _check(walk[i], oracle[i], f"iteration {i} ({walk[i]['plan']})")


# -- (e) the tiny Fig-10 on four ranks -----------------------------------------------


def test_fig10_on_ranks_meets_reference_gates(world_s4):
    s = world_s4[0][2]
    assert s["backend"] == "spmd" and s["ranks"] == 4 and s["transport"] == "gloo"
    assert s["kind_switches"] >= 2, s["decision_trail"]
    restacks = [(e["from_spec"]["num_virtual"], e["to_spec"]["num_virtual"])
                for e in s["switch_events"] if e["restacked"]]
    assert (1, 2) in restacks and (2, 1) in restacks, restacks
    assert s["precompile_hit_rate"] >= 0.8 and s["cache"]["cold_misses"] == 0
    assert s["checks"]["max_abs_err"] < 5e-6 and s["checks"]["finite"]
    assert np.isfinite(s["losses"]).all() and s["iterations"] == 14


def test_fig10_on_ranks_follows_the_engine_free_trail(world_s4):
    s = world_s4[0][2]
    assert s["decision_trail"] == train_adaptive.engine_free_decision_trail(14)


def test_fig10_on_ranks_reports_every_rank(world_s4):
    """Per iteration every rank's breakdown; per switch every rank's bytes;
    the K1 count (0 on the CPU) summed over the ranks."""
    s = world_s4[0][2]
    for r in s["per_iteration"]:
        assert len(r["rank_seconds"]) == 4 and r["flash_launches"] == 0
        assert len(r["max_memory_allocated_per_rank"]) == 4
    for p in s["per_plan"].values():
        assert [set(x) for x in p["per_rank_ms_p50"]] == [set(train_adaptive.RANK_ITEMS)] * 4
    for e in s["switch_events"]:
        assert [r["rank"] for r in e["ranks"]] == [0, 1, 2, 3]
        assert (sum(r["bytes_sent"] for r in e["ranks"]) > 0) == e["restacked"]


def test_fig10_on_ranks_starts_where_the_reference_backend_does(world_s4):
    """Same seed, data and first plan: the first loss is the one-process
    runtime's (which ``tests/test_torch_runtime.py`` holds to ``repro``)."""
    sc = train_adaptive.build_fig10_scenario(device="cpu")
    try:
        sc.coordinator.run(1)
    finally:
        sc.runtime.cache.shutdown()
    first = world_s4[0][2]["per_iteration"][0]
    assert first["plan"] == sc.runtime.iterations[0].plan_name
    assert first["loss"] == pytest.approx(sc.runtime.iterations[0].loss, abs=5e-6)


# -- (f) the CLI ---------------------------------------------------------------------


def test_train_adaptive_spmd_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "fig10.json"
    assert train_adaptive.main(["--device", "cpu", "--backend", "spmd", "--iterations", "4", "--out", str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["iterations"] == 4 and s["device"] == "cpu" and s["backend"] == "spmd" and s["ranks"] == 4
    printed = capsys.readouterr().out
    assert "decision trail:" in printed and "rank 3: compute" in printed


# -- (g) restacks there and back -----------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=[f"{PAIR_PLANS[a]['kind']}{a}-{PAIR_PLANS[c]['kind']}{c}" for a, c in PAIRS])
def test_restack_there_and_back_is_bitwise(world_s4, pair):
    a, c = pair
    per_rank = [r[1] for r in world_s4[1]]
    k = PAIRS.index(pair)
    got = [r[k] for r in per_rank]
    assert got[0]["mid"] is True, got[0]
    assert all(g["back"] for g in got), got
    pa, pc = (make_plan(4, M, spec=ScheduleSpec(**PAIR_PLANS[j])) for j in (a, c))
    moves = not np.array_equal(pa.placement.vstage_of, pc.placement.vstage_of)
    assert (sum(g["layers_sent"] for g in got) > 0) == moves


# -- units -----------------------------------------------------------------------------


@pytest.mark.parametrize("kinds", [("kfkb", "interleaved_zb"), ("interleaved_zb", "zbv"), ("zbv", "kfkb")])
def test_rounds_send_and_receive_one_layer_a_stage(kinds):
    """Every move lands in exactly one round, and no stage sends or
    receives two layers in one round (the transient is one layer)."""
    S, L = 4, 32
    a, c = (Placement.build(k, S, 1 if k == "kfkb" else 2) for k in kinds)
    ha, hc = _layer_homes(a, L), _layer_homes(c, L)
    moves = [(g, ha[g][0], hc[g][0]) for g in range(L) if ha[g][0] != hc[g][0]]
    rounds = _rounds(moves)
    assert sorted(mv for r in rounds for mv in r) == moves
    for r in rounds:
        assert len({mv[1] for mv in r}) == len(r) == len({mv[2] for mv in r})
    # a move waits only for moves that share its sender or its receiver
    sends, recvs = [sum(mv[1] == s for mv in moves) for s in range(S)], [sum(mv[2] == s for mv in moves) for s in range(S)]
    assert len(rounds) <= max(sends[mv[1]] + recvs[mv[2]] - 1 for mv in moves)


def test_a_layer_travels_in_one_buffer_a_dtype():
    """_pack flattens a layer's leaves into one buffer per dtype, in
    first-seen order; _unpack gives back every leaf bitwise, as a view."""
    gen = torch.Generator().manual_seed(0)
    leaves = [torch.randn(3, 5, generator=gen), torch.randn(7, generator=gen).to(torch.bfloat16),
              torch.randn(2, 2, 2, generator=gen), torch.randn(1, generator=gen).to(torch.bfloat16)]
    shapes = [(t.shape, t.dtype) for t in leaves]
    bufs = _pack(leaves)
    assert [(b.dtype, b.numel()) for b in bufs] == [(torch.float32, 23), (torch.bfloat16, 8)]
    assert _dtype_sizes(shapes) == {torch.float32: 23, torch.bfloat16: 8}
    back = _unpack([b.clone() for b in bufs], shapes)
    for got, want in zip(back, leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert back[0].untyped_storage().data_ptr() == back[2].untyped_storage().data_ptr()


def test_layer_homes_follow_the_virtual_stage_rule():
    """Virtual stage j holds layers [j n, (j + 1) n) on the device and in the
    chunk the placement gives it (GPT-2.7B's 32 layers at S = 4)."""
    for kind, v in (("kfkb", 1), ("interleaved_zb", 2), ("zbv", 2)):
        pl = Placement.build(kind, 4, v)
        homes = _layer_homes(pl, 32)
        for g, (s, c, i) in enumerate(homes):
            j = g // (32 // (4 * v))
            assert (s, c, i) == (pl.device_of[j], pl.chunk_of[j], g % (32 // (4 * v)))
    with pytest.raises(ValueError, match="split"):
        _layer_homes(Placement.build("zbv", 4, 2), 12)


def test_spmd_runtime_refuses_the_stateless_mode():
    """``optimizer=None`` (the serving side) is not ported on the spmd backend."""
    group = types.SimpleNamespace(S=2, D=1, s=0, rank=0, device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="queue 1, item 4"):
        PlanRuntime(_cfgs(4)[1], 2, None, global_batch=8, seq_len=8, backend="spmd", group=group,
                    program_factory=lambda t: None)
    with pytest.raises(ValueError, match="rank group has 2"):
        PlanRuntime(_cfgs(4)[1], 4, make_optimizer("adamw"), global_batch=8, seq_len=8, backend="spmd",
                    group=group)
