"""The port's live plan-switch runtime (``repro_torch.runtime``) and its
Fig-10 entry point against ``repro``.

* Restacking: ``restack_train_state`` on ``repro``'s training states
  (parameters and AdamW moments, carried across by the bridge) equals
  ``repro``'s bitwise, in both directions and between any two layouts.
* The step cache and the passive telemetry, as ``tests/test_runtime.py``
  tests them (fake step programs, simulated timings).
* Switch equivalence: the port's ``PlanRuntime`` walks kfkb -> zb_h1 ->
  interleaved_zb (v = 2) -> kfkb and matches, after every iteration,
  ``repro``'s engine and optimizer on the same bridged state, restacked by
  ``repro``'s ``restack_train_state`` at each switch: loss, parameters,
  gradients and AdamW moments at atol 5e-6, ``repro``'s own limit for
  this check (fp32 throughout; the two differ by summation order).
  ``repro``'s side is jitted once per plan: its eager engine takes
  10-30 s an iteration at this size, its jitted step ~5-14 s to build.
* The tiny Fig-10 run on the CPU meets ``repro``'s acceptance gates
  (``tests/test_runtime.py::test_fig10_regime_run_meets_acceptance_gates``)
  and its decision trail equals the one ``repro.core`` computes alone.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.core import ScheduleSpec as JSpec
from repro.core import make_plan as jmake_plan
from repro.models.common import ModelConfig as JConfig
from repro.optim import make_optimizer as jmake_optimizer
from repro.pipeline.engine import reference_pipeline_grads as jreference_pipeline_grads
from repro.pipeline.stage import StagedModel as JStaged
from repro.runtime import restack_train_state as jrestack
from repro.training import TrainState as JTrainState
from repro.training import create_train_state as jcreate_train_state
from repro_torch import bridge
from repro_torch.core import (
    NetworkProfiler,
    ScheduleSpec,
    StableTrace,
    StageCosts,
    make_plan,
    optimize_weight_placement,
    simulate_plan,
    uniform_network,
)
from repro_torch.launch import train_adaptive
from repro_torch.models.common import ModelConfig
from repro_torch.optim import constant_schedule, make_optimizer
from repro_torch.pipeline import StagedModel, reference_pipeline_grads
from repro_torch.pipeline import engine as port_engine
from repro_torch.runtime import (
    CompiledStepCache,
    PassiveLinkFeed,
    PlanRuntime,
    TelemetryBus,
    invert_effective_bandwidth,
    restack_train_state,
)
from repro_torch.tree import flatten
from test_torch_adaptive import _coordinator_trail

import repro.core as J
import repro.obs as jobs
import repro.runtime.telemetry as jtel

#: repro's runtime test config (tests/test_runtime.py::_cfg)
TINY = dict(name="rt-tiny", family="dense", num_layers=4, d_model=16, num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64)


def _cfgs(num_layers=4):
    kw = {**TINY, "num_layers": num_layers}
    return (
        JConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32),
        ModelConfig(**kw, dtype=torch.float32, param_dtype=torch.float32),
    )


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _jopt():
    return jmake_optimizer("adamw", schedule=lambda s: jnp.float32(1e-3))


def _jstate(S, L=4, seed=0, moments=True):
    """``repro``'s flat training state, with AdamW moments drawn at random
    (so that a restack that mixes them up shows)."""
    jstaged = JStaged.build(_cfgs(L)[0], S)
    state = jcreate_train_state(jstaged.init_all_stages(jax.random.PRNGKey(seed)), _jopt())
    if moments:
        rng = np.random.default_rng(seed + 1)
        draw = lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32))  # noqa: E731
        opt = state.opt_state
        state = JTrainState(state.step + 3, state.params, type(opt)(
            opt.step + 3, jax.tree_util.tree_map(draw, opt.m), jax.tree_util.tree_map(lambda x: jnp.abs(draw(x)), opt.v)
        ))
    return state


def _port_state(jstate, S, v, L=4):
    staged = StagedModel.build(_cfgs(L)[1], S * v)
    return bridge.train_state_from_repro(_flat(jstate), staged, device="cpu"), staged


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, a in want.items():
        assert got[key].dtype == a.dtype and got[key].shape == a.shape and np.array_equal(got[key], a), key


# -- the training-state bridge ---------------------------------------------------------------


@pytest.mark.parametrize("v", [1, 2])
def test_train_state_bridge_round_trip_is_bitwise(v):
    S = 2
    jstate = jrestack(_jstate(S), S, 1, v)
    state, staged = _port_state(jstate, S, v)
    assert state.step == 3 and state.opt_state.step == 3 and len(state.params) == S * v
    _assert_bitwise(bridge.train_state_to_repro(state, staged), _flat(jstate))


# -- restacking ------------------------------------------------------------------------------


LAYOUTS = [(1, 2), (2, 1), (1, 4), (4, 1), (2, 4), (4, 2)]


@pytest.mark.parametrize("v_from,v_to", LAYOUTS, ids=[f"v{a}-v{b}" for a, b in LAYOUTS])
def test_restack_equals_reference_bitwise(v_from, v_to):
    """Parameters and both AdamW moments; the source layout carries
    diverged replicated copies (each virtual stage's own), so the collapse
    must pick the same authoritative rows."""
    S, L = 2, 8  # 4 layers a flat stage: splits over v = 2 and 4
    jsrc = jrestack(_jstate(S, L), S, 1, v_from)
    if v_from > 1:  # every virtual stage's replicated copy different

        def mark(path, x):
            if {"embed", "final_norm"} & set(_path_str(path).split("/")):
                return x + jnp.arange(x.shape[0], dtype=x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
            return x

        jsrc = jax.tree_util.tree_map_with_path(mark, jsrc)
    want = _flat(jrestack(jsrc, S, v_from, v_to))
    state, _ = _port_state(jsrc, S, v_from, L)
    out = restack_train_state(state, S, v_from, v_to)
    _assert_bitwise(bridge.train_state_to_repro(out, StagedModel.build(_cfgs(L)[1], S * v_to)), want)


def test_restack_collapse_keeps_authoritative_replicated_rows():
    """Flat stage 0 keeps virtual stage 0's copy (the token embedding),
    the last flat stage the LAST virtual stage's (the unembed head)."""
    S, v = 2, 2
    state, _ = _port_state(jrestack(_jstate(S), S, 1, v), S, v)
    for j, tree in enumerate(state.params):
        for t in flatten({g: tree[g] for g in ("embed", "final_norm")}).values():
            t.fill_(float(j))
    flat = restack_train_state(state, S, v, 1)
    for s, want in enumerate([0.0, float(S * v - 1)]):
        for t in flatten({g: flat.params[s][g] for g in ("embed", "final_norm")}).values():
            assert torch.all(t == want)


def test_restack_expanded_copies_do_not_alias():
    """AdamW updates in place: every virtual stage's replicated copy is
    its own tensor, so updating one leaves the others as they were."""
    S, v = 2, 2
    state, _ = _port_state(_jstate(S), S, 1)
    out = restack_train_state(state, S, 1, v)
    for tree in (out.params, out.opt_state.m, out.opt_state.v):
        ptrs = [t.data_ptr() for st in tree for g in ("embed", "final_norm") for t in flatten(st[g]).values()]
        assert len(set(ptrs)) == len(ptrs)
        before = tree[1]["embed"]["table"].clone()
        tree[0]["embed"]["table"].add_(1.0)
        assert torch.equal(tree[1]["embed"]["table"], before)
    # the layers are regrouped, not copied
    assert out.params[1]["layers"][0] is state.params[0]["layers"][1]


def test_restack_rejects_unsplittable_reps():
    S = 2
    state, _ = _port_state(_jstate(S, L=2), S, 1, L=2)  # 1 layer a stage: cannot split over v=2
    with pytest.raises(ValueError, match="reps"):
        restack_train_state(state, S, 1, 2)
    assert restack_train_state(state, S, 1, 1) is state


# -- the step cache (fake step programs) -----------------------------------------------------


def _fake_cache(log, delay=0.0):
    def factory(table):
        if delay:
            time.sleep(delay)
        log.append(table.plan.name)
        return lambda *a: ("ran", table.plan.name)

    return CompiledStepCache(factory)


def _plan(S, M, k):
    return make_plan(S, M, spec=ScheduleSpec(k=k))


def test_cache_warm_hit_and_cold_miss_accounting():
    log = []
    cache = _fake_cache(log)
    t1, t2 = _plan(2, 4, 1).lower(), _plan(2, 4, 2).lower()
    cache.precompile([t1])
    cache.wait_idle()
    e1 = cache.get(t1)
    assert e1.source == "precompile" and cache.stats.warm_hits == 1
    e2 = cache.get(t2)  # never announced: synchronous cold build
    assert e2.source == "demand" and cache.stats.cold_misses == 1
    assert cache.get(t2).compiled is e2.compiled
    assert log.count(t1.plan.name) == 1 and log.count(t2.plan.name) == 1
    assert cache.stats.hit_rate == pytest.approx(2 / 3)
    cache.shutdown()


def test_cache_get_joins_inflight_background_compile():
    log = []
    cache = _fake_cache(log, delay=0.2)
    t1 = _plan(2, 4, 1).lower()
    cache.precompile([t1])
    entry = cache.get(t1)  # joins the in-flight build, does not duplicate it
    assert entry.source == "precompile"
    assert cache.stats.inflight_hits == 1 and cache.stats.cold_misses == 0
    assert log == [t1.plan.name]
    cache.shutdown()


def test_cache_key_distinguishes_refined_lowerings():
    """A +Wopt-refined lowering shares every schedule coordinate with its
    base plan but has another grid: a distinct entry.  The skewed costs of
    tests/test_placement.py, where the search is known to move W tasks."""
    S = 4
    plan = make_plan(S, 8, spec=ScheduleSpec(kind="zb_h2", extra_warmup=2))
    costs = StageCosts(
        fwd_time=[1.0, 1.2, 0.8, 1.0], bwd_time=[3.0, 2.2, 3.6, 2.0], fwd_bytes=[1.0] * S, bwd_bytes=[1.0] * S,
        bwd_input_time=[0.8, 1.0, 0.6, 1.0], bwd_weight_time=[2.2, 1.2, 3.0, 1.0],
    )
    bw = {(s, s + 1): 2.0 for s in range(S - 1)} | {(s + 1, s): 2.0 for s in range(S - 1)}
    refined = optimize_weight_placement(plan, costs, bw)
    k_base = CompiledStepCache.plan_key(plan.lower())
    k_ref = CompiledStepCache.plan_key(refined.lower())
    assert refined.orders != plan.orders and refined.spec == plan.spec
    assert k_base != k_ref and k_ref[-1] != k_base[-1]  # the grid digest differs
    assert CompiledStepCache.plan_key(plan.lower()) == k_base
    assert k_base[1] == plan.spec  # the key carries the schedule coordinates


def test_cache_precompile_thread_safety_under_concurrent_gets():
    log = []
    cache = _fake_cache(log, delay=0.01)
    tables = [_plan(2, 8, k).lower() for k in (1, 2, 4, 8)]
    cache.precompile(tables)
    results = []
    threads = [threading.Thread(target=lambda t=t: results.append(cache.get(t).compiled()[1])) for t in tables * 2]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    cache.wait_idle()
    assert sorted(log) == sorted(t.plan.name for t in tables)
    assert sorted(results) == sorted(t.plan.name for t in tables * 2)
    assert cache.stats.cold_misses == 0
    cache.shutdown()


# -- passive telemetry (simulated timings) ---------------------------------------------------


def test_invert_effective_bandwidth_recovers_ground_truth():
    S, M = 4, 8
    plan = _plan(S, M, 2)
    costs = StageCosts.uniform(S, 1.0, act_bytes=4.0)
    for bw_true in (0.5, 2.0, 8.0):
        observed = simulate_plan(plan, costs, uniform_network(S, lambda: StableTrace(bw_true))).pipeline_length
        assert invert_effective_bandwidth(plan, costs, observed) == pytest.approx(bw_true, rel=0.05)


def test_invert_effective_bandwidth_saturates_cleanly():
    S, M = 4, 8
    plan = _plan(S, M, 2)
    costs = StageCosts.uniform(S, 1.0, act_bytes=4.0)
    compute_bound = simulate_plan(plan, costs, uniform_network(S, lambda: StableTrace(1e30))).pipeline_length
    assert invert_effective_bandwidth(plan, costs, compute_bound * 0.5) == 1e15
    assert invert_effective_bandwidth(plan, costs, 1e12) == 1e-6


def test_passive_feed_keeps_profiler_windows_fresh():
    S, M, bw_true = 4, 8, 2.0
    plan = _plan(S, M, 2)
    costs = StageCosts.uniform(S, 1.0, act_bytes=4.0)
    net = uniform_network(S, lambda: StableTrace(bw_true))
    profiler = NetworkProfiler(net, window=4)
    bus = TelemetryBus()
    bus.subscribe(PassiveLinkFeed(profiler))
    length = simulate_plan(plan, costs, net).pipeline_length
    assert profiler.last_update(0, 1) is None
    bus.publish_iteration(index=0, plan=plan, costs=costs, seconds=length, end_time=100.0, source="sim")
    for s in range(S - 1):
        assert profiler.is_fresh(s, s + 1, now=110.0, max_age=20.0)
        assert not profiler.is_fresh(s, s + 1, now=200.0, max_age=20.0)
        assert profiler.link_bandwidth(s, s + 1) == pytest.approx(bw_true, rel=0.05)
    before = profiler.last_update(0, 1)  # engine-clock timings stay out of the sim-clock windows
    bus.publish_iteration(index=1, plan=plan, costs=costs, seconds=0.01, end_time=999.0, source="engine")
    assert profiler.last_update(0, 1) == before


# -- the runtime -----------------------------------------------------------------------------


def test_runtime_refuses_what_it_cannot_run():
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="rank group"):  # repro raises without a mesh
        PlanRuntime(cfg, 2, None, global_batch=8, seq_len=8, backend="spmd", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        PlanRuntime(cfg, 2, None, global_batch=8, seq_len=8, backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="program_factory"):
        PlanRuntime(cfg, 2, None, global_batch=8, seq_len=8, device="cpu")
    rt = PlanRuntime(cfg, 2, make_optimizer("adamw"), global_batch=8, seq_len=8, device="cpu")
    with pytest.raises(RuntimeError, match="switch_to"):
        rt.run_iteration(np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanRuntime(cfg, 2, make_optimizer("adamw"), global_batch=8, seq_len=8)


def test_stateless_runtime_runs_programs_and_tracks_the_layout():
    _, cfg = _cfgs()
    rt = PlanRuntime(cfg, 2, None, global_batch=8, seq_len=8, device="cpu",
                     program_factory=lambda table: lambda x: (table.plan.name, x + 1))
    ev = rt.switch_to(make_plan(2, 4, spec=ScheduleSpec(kind="interleaved_zb", num_virtual=2)).lower())
    assert not ev.restacked and not ev.warm and rt.current_v == 2 and rt.state is None
    (name, y), seconds = rt.run_program(1)
    assert name.startswith("I2ZB") and y == 2 and seconds >= 0.0
    with pytest.raises(RuntimeError, match="stateless"):
        rt.run_iteration(None, None)
    rt.cache.shutdown()


@pytest.mark.parametrize(
    "kw",
    [dict(kind="kfkb", k=1), dict(kind="kfkb", k=2), dict(kind="zb_h1"), dict(kind="zb_h1", zb_policy="saved_residual"),
     dict(kind="zb_h2", extra_warmup=1), dict(kind="interleaved", num_virtual=2), dict(kind="interleaved_zb", num_virtual=2),
     dict(kind="zbv")],
    ids=lambda kw: "-".join(f"{v}" for v in kw.values()),
)
def test_stage_body_runs_counts_the_engine_recomputes(kw, monkeypatch):
    """The count the on-card phase holds K1's launches to: how often the
    engine runs a virtual stage's body, counted here on the CPU."""
    _, cfg = _cfgs()
    plan = make_plan(2, 4, spec=ScheduleSpec(**kw))
    staged = StagedModel.build(cfg, plan.total_virtual_stages)
    params = staged.init_all_stages(torch.Generator().manual_seed(0))
    calls = []
    body = StagedModel.stage_hidden
    monkeypatch.setattr(StagedModel, "stage_hidden", lambda self, p, x: calls.append(1) or body(self, p, x))
    tokens = torch.zeros((4, 1, 8), dtype=torch.int64)
    reference_pipeline_grads(staged, params, tokens, tokens, plan)
    assert len(calls) == port_engine.stage_body_runs(plan)


# -- switch equivalence against repro --------------------------------------------------------

#: the walk: (plan, iterations under it)
WALK = [
    (dict(kind="kfkb", k=1), 2),
    (dict(kind="zb_h1"), 1),
    (dict(kind="interleaved_zb", num_virtual=2), 2),
    (dict(kind="kfkb", k=1), 1),
]


def test_switch_equivalence_kfkb_zb_interleaved_and_back():
    S, M, b, T = 2, 4, 2, 8
    B = M * b
    jcfg, cfg = _cfgs()
    jopt = _jopt()
    jstate = _jstate(S, moments=False)
    rt = PlanRuntime(cfg, S, make_optimizer("adamw", schedule=constant_schedule(1e-3)),
                     global_batch=B, seq_len=T, device="cpu")
    rt.state, _ = _port_state(jstate, S, 1)
    jstaged = {v: JStaged.build(jcfg, S * v) for v in (1, 2)}
    steps, v_now, i = {}, 1, 0
    for kw, n in WALK:
        spec = dict(micro_batch_size=b, **kw)
        table = make_plan(S, M, spec=ScheduleSpec(**spec)).lower()
        jplan = jmake_plan(S, M, spec=JSpec(**spec))
        v = jplan.num_virtual
        ev = rt.switch_to(table)
        assert ev.restacked == (v != v_now)
        if v != v_now:
            jstate = jrestack(jstate, S, v_now, v)
            v_now = v
        if jplan.name not in steps:

            def step(state, tokens, labels, staged=jstaged[v], plan=jplan):
                loss, grads = jreference_pipeline_grads(staged, state.params, tokens, labels, plan)
                params, opt_state, _ = jopt.update(state.params, grads, state.opt_state)
                return JTrainState(state.step + 1, params, opt_state), loss, grads

            steps[jplan.name] = jax.jit(step)
        for _ in range(n):
            rng = np.random.default_rng(10 + i)
            tok, lab = (rng.integers(0, TINY["vocab_size"], (B, T)) for _ in range(2))
            result = rt.run_iteration(torch.from_numpy(tok), torch.from_numpy(lab))
            jstate, jloss, jgrads = steps[jplan.name](
                jstate, *(jnp.asarray(a.reshape(M, b, T), jnp.int32) for a in (tok, lab))
            )
            staged = rt.staged_for(v)
            assert result.loss == pytest.approx(float(jloss), abs=5e-6), i
            got = bridge.train_state_to_repro(rt.state, staged)
            for key, want in _flat(jstate).items():
                np.testing.assert_allclose(got[key], want, atol=5e-6, err_msg=f"iteration {i}: {key}")
            got = bridge.staged_params_to_repro(rt.last_grads, staged)
            for key, want in _flat(jgrads).items():
                np.testing.assert_allclose(got[key], want, atol=5e-6, err_msg=f"iteration {i}: grad {key}")
            i += 1
    assert [e.restacked for e in rt.switch_events] == [False, False, True, True]
    rt.cache.shutdown()


# -- Fig-10 at tiny size on the CPU ----------------------------------------------------------


@pytest.fixture(scope="module")
def fig10():
    sc = train_adaptive.build_fig10_scenario(device="cpu")
    summary = sc.coordinator.run(14)
    out = train_adaptive.summarize(sc, summary)
    yield sc, out
    sc.runtime.cache.shutdown()


def test_fig10_run_meets_reference_gates(fig10):
    sc, s = fig10
    assert s["kind_switches"] >= 2, s["decision_trail"]
    assert any(e["restacked"] for e in s["switch_events"])
    assert s["warm_switch_seconds"], "no warm switches recorded"
    assert s["warm_switch_latency_frac"] < 0.05
    assert s["precompile_hit_rate"] >= 0.8
    assert s["cache"]["cold_misses"] == 0
    assert train_adaptive.grad_parity_max_err(sc) < 5e-6
    assert s["probe_overhead_saved_frac"] > 0.75
    assert np.isfinite(s["losses"]).all() and s["iterations"] == 14


def test_fig10_decision_trail_equals_reference(fig10):
    _, s = fig10
    want = [{"t": round(r[0], 1), "chosen": r[1], "kind": r[2]} for r in _coordinator_trail(J, jtel, jobs)[0]]
    assert s["decision_trail"] == want == train_adaptive.engine_free_decision_trail(14)


def test_fig10_summary_per_plan(fig10):
    sc, s = fig10
    assert [r["plan"] for r in s["per_iteration"]] == [r.plan_name for r in sc.runtime.iterations]
    assert sum(p["iterations"] for p in s["per_plan"].values()) == 14
    for r in s["per_iteration"]:
        assert r["flash_launches"] == 0 and r["max_memory_allocated"] is None  # the CPU runs no kernel
    for e in sc.runtime.switch_events:
        plan = make_plan(4, 4, spec=e.to_spec)
        assert train_adaptive.expected_flash_launches(plan, sc.cfg) * plan.total_virtual_stages == (
            port_engine.stage_body_runs(plan) * sc.cfg.num_layers
        )
    flat = sc.runtime.grads_in_flat_layout()
    assert flat is not None and len(flat) == 4


def test_train_adaptive_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "fig10.json"
    assert train_adaptive.main(["--device", "cpu", "--iterations", "4", "--out", str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["iterations"] == 4 and s["device"] == "cpu" and s["config"] == "runtime-tiny"
    assert "decision trail:" in capsys.readouterr().out  # --backend spmd: tests/test_torch_spmd_runtime.py
