"""The port's copies of ``repro.core``'s decision layer, ``repro.obs`` and
``repro.runtime.telemetry`` against the originals.

Two kinds of test:

* **Equality on the same inputs**, compared exactly (``==`` on floats: the
  copies run the same Python arithmetic in the same order): the
  simulator's makespan for every registered kind on the Fig-10 network,
  the candidate enumeration over a search space of every kind with the
  saved-residual policy, the memory model's peaks, the weight-placement
  search, and the coordinator's decision trail with each tuning record's
  chosen plan and estimates.
* **Twins** of ``tests/test_{candidates,simulator,tuner,coordinator,placement}.py``
  (none of them needs an engine): each of those modules is loaded once
  more with ``repro.core`` and ``repro.runtime`` replaced by the port's
  copies, and every test of it (each parametrised case) runs again on the
  port.
"""

import os
import types

import numpy as np
import pytest

import repro.core as J
import repro.obs as jobs
import repro.runtime.telemetry as jtel
import repro_torch.core as P
import repro_torch.obs as pobs
import repro_torch.runtime.telemetry as ptel
from repro_torch.launch import train_adaptive

_TESTS = os.path.dirname(os.path.abspath(__file__))
S, M, B = 4, 4, 8


# -- equality on the same inputs -----------------------------------------------------


def _fig10_network(core, seed=0, hour=120.0):
    """The Fig-10 scenario's regime network (``repro/launch/train_adaptive.py``)."""

    def link(a, c):
        s = 17 * a + c + 100 * seed
        bursty = lambda ss: core.BurstyTrace(  # noqa: E731
            8.0, contended_frac=0.05, mean_free=0.5, mean_contended=2.0, seed=ss
        )
        return core.RegimeTrace([hour, 2 * hour], [bursty(s), core.StableTrace(50.0), bursty(s + 7)])

    return core.Network.build(S, link)


#: one spec per registered kind (and the saved-residual and vector-warmup
#: variants), as ScheduleSpec keyword sets
KIND_SPECS = [
    dict(kind="kfkb", k=1),
    dict(kind="kfkb", k=2),
    dict(kind="zb_h1"),
    dict(kind="zb_h1", zb_policy="saved_residual"),
    dict(kind="zb_h2", extra_warmup=2),
    dict(kind="zb_h2", extra_warmup=(3, 2, 1, 0)),
    dict(kind="interleaved", num_virtual=2),
    dict(kind="interleaved_zb", num_virtual=2),
    dict(kind="zbv", k=1),
]


def _costs(core):
    return core.StageCosts(
        fwd_time=[1.0, 1.2, 0.8, 1.0], bwd_time=[3.0, 2.2, 3.6, 2.0],
        fwd_bytes=[2.0] * S, bwd_bytes=[2.0] * S,
        bwd_input_time=[0.8, 1.0, 0.6, 1.0], bwd_weight_time=[2.2, 1.2, 3.0, 1.0],
    )


def test_kind_specs_cover_every_registered_kind():
    assert {kw["kind"] for kw in KIND_SPECS} == set(P.registered_kinds()) == set(J.registered_kinds())


@pytest.mark.parametrize("kw", KIND_SPECS, ids=[str(sorted(kw.items())) for kw in KIND_SPECS])
@pytest.mark.parametrize("t0", [0.0, 150.0, 300.0])
def test_simulated_makespan_equals_reference(kw, t0):
    """The makespan, every task's finish, the queues and the links, on the Fig-10 network
    seen from ``t0`` (bursty, exclusive and bursty again)."""
    got, want = (
        core.simulate_plan(
            core.make_plan(S, 8, spec=core.ScheduleSpec(**kw)), _costs(core),
            core.shifted_network(_fig10_network(core), t0),
        )
        for core in (P, J)
    )
    assert got.pipeline_length == want.pipeline_length
    for field in ("busy_time", "stall_time", "task_finish", "queue_timeline", "link_busy", "link_events"):
        assert getattr(got, field) == getattr(want, field), field


def _memory_model(core):
    return core.MemoryModel.uniform(
        num_stages=S, seq_len=128, param_bytes=1e6, optimizer_bytes=2e6, grad_bytes=1e6,
        stage_input_bytes_per_token=256.0, layer_act_bytes_per_token=128.0, num_layers_per_stage=2,
    )


def _candidates(core, limits):
    space = core.SearchSpace(
        kinds=tuple(core.registered_kinds()), virtual_degrees=(2,), max_k=8,
        zb_policies=("double_remat", "saved_residual"),
    )
    return core.enumerate_candidates(S, 32, _memory_model(core), limits, space=space)


LIMITS = [2e9, [2.2e7, 3e7, 4e7, 6e7], 3e7]


@pytest.mark.parametrize("limits", LIMITS, ids=["loose", "skewed", "tight"])
def test_candidates_and_memory_peaks_equal_reference(limits):
    got, want = _candidates(P, limits), _candidates(J, limits)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.name == b.name and a.spec == P.ScheduleSpec(**vars(b.spec))
        assert (a.k, a.micro_batch_size, a.num_microbatches) == (b.k, b.micro_batch_size, b.num_microbatches)
        assert a.est_peak_bytes == b.est_peak_bytes
        assert _memory_model(P).peak_bytes_per_stage(a.plan) == _memory_model(J).peak_bytes_per_stage(b.plan)
        assert P.predicted_peak_live(a.plan) == J.predicted_peak_live(b.plan)
        assert np.array_equal(a.table.grid, b.table.grid)


@pytest.mark.parametrize("kw", [dict(kind="zb_h2", extra_warmup=2), dict(kind="zb_h2", extra_warmup=(3, 2, 1, 1)),
                                dict(kind="interleaved_zb", num_virtual=2), dict(kind="zbv", k=1)],
                         ids=["zb_h2", "zb_h2_vector", "interleaved_zb", "zbv"])
def test_weight_placement_equals_reference(kw):
    bw = {(s, s + 1): 2.0 for s in range(S - 1)} | {(s + 1, s): 2.0 for s in range(S - 1)}
    got, want = (
        core.optimize_weight_placement(core.make_plan(S, 8, spec=core.ScheduleSpec(**kw)), _costs(core), bw)
        for core in (P, J)
    )
    assert got.name == want.name
    tasks = lambda plan: [[(int(t.op), t.stage, t.mb, t.chunk) for t in o] for o in plan.orders]  # noqa: E731
    assert tasks(got) == tasks(want)
    assert np.array_equal(got.lower().grid, want.lower().grid)


def _coordinator_trail(core, tel, obs_pkg, iterations=14, seed=0):
    """The Fig-10 decision stack of ``repro``'s entry point, without an engine."""
    costs = core.StageCosts.uniform(S, 1.0, act_bytes=2.0)
    specs = [dict(kind="kfkb", k=1), dict(kind="kfkb", k=2), dict(kind="zb_h1"),
             dict(kind="zb_h2", extra_warmup=2), dict(kind="interleaved_zb", num_virtual=2)]
    cands = [
        core.Candidate(kw.get("k", 1), 2, M, core.make_plan(S, M, spec=core.ScheduleSpec(micro_batch_size=2, **kw)), 0.0)
        for kw in specs
    ]
    net = _fig10_network(core, seed)
    profiler = core.NetworkProfiler(net, window=4)
    obs = obs_pkg.Observability.create()
    tuner = core.AutoTuner(cands, lambda c: costs, profiler, passive_staleness=40.0,
                           flight=obs.flight, metrics=obs.metrics)
    bus = tel.TelemetryBus(metrics=obs.metrics)
    bus.subscribe(tel.PassiveLinkFeed(profiler))
    summary = core.Coordinator(tuner, net, global_batch=B, tuning_interval=55.0, tuning_overhead=5.0,
                               telemetry_sink=bus).run(iterations)
    tuning = [(r.time, r.chosen, r.chosen_kind, r.chosen_spec, r.estimates, r.probes_run, r.probes_skipped)
              for r in summary.tuning]
    iters = [(r.start, r.length, r.plan_name) for r in summary.iterations]
    return tuning, iters, summary.total_time, summary.total_tuning_overhead, obs.flight.events("tuner_decision")


@pytest.mark.parametrize("seed", [0, 1])
def test_coordinator_decision_trail_equals_reference(seed):
    got = _coordinator_trail(P, ptel, pobs, seed=seed)
    want = _coordinator_trail(J, jtel, jobs, seed=seed)
    assert len(got[0]) == len(want[0]) > 0
    for a, b in zip(got[0], want[0]):
        assert a[:3] == b[:3] and a[3] == P.ScheduleSpec(**vars(b[3]))
        assert a[4] == b[4] and a[5:] == b[5:]
    assert got[1:4] == want[1:4]
    assert [{k: v for k, v in e.items() if k != "ts"} for e in got[4]] == [
        {k: v for k, v in e.items() if k != "ts"} for e in want[4]
    ]


def test_entry_point_trail_equals_reference():
    """``train_adaptive.engine_free_decision_trail``, the trail the on-card
    run is held to, is ``repro``'s (seed 0: two kind switches)."""
    trail = train_adaptive.engine_free_decision_trail(14)
    want = [{"t": round(r[0], 1), "chosen": r[1], "kind": r[2]} for r in _coordinator_trail(J, jtel, jobs)[0]]
    assert trail == want
    kinds = [d["kind"] for d in trail]
    assert sum(a != b for a, b in zip(kinds, kinds[1:])) >= 2 and "interleaved_zb" in kinds


def test_passive_feed_inverts_like_reference():
    costs = J.StageCosts.uniform(S, 1.0, act_bytes=4.0)
    pcosts = P.StageCosts.uniform(S, 1.0, act_bytes=4.0)
    for observed in (3.0, 14.0, 60.0, 1e9):
        for k in (1, 2):
            a = ptel.invert_effective_bandwidth(P.make_plan(S, 8, spec=P.ScheduleSpec(k=k)), pcosts, observed)
            b = jtel.invert_effective_bandwidth(J.make_plan(S, 8, spec=J.ScheduleSpec(k=k)), costs, observed)
            assert a == b


def test_obs_trace_and_metrics_equal_reference():
    """The simulated-timeline render and the registry's export on one run."""
    got, want = [], []
    for core, obs_pkg, out in ((P, pobs, got), (J, jobs, want)):
        obs = obs_pkg.Observability.create(clock=lambda: 0.0)
        plan = core.make_plan(S, 8, spec=core.ScheduleSpec(kind="zb_h2", extra_warmup=1))
        obs_pkg.render_simulated_trace(plan, _costs(core), _fig10_network(core), recorder=obs.trace)
        obs.metrics.counter("c").inc(3, track="a")
        obs.metrics.histogram("h").observe(0.25, track="a")
        out.append(obs.trace.to_chrome_trace())
        out.append(obs.metrics.snapshot())
    assert got == want


# -- twins of repro's decision-layer tests ---------------------------------------------

TWIN_MODULES = ["test_candidates", "test_simulator", "test_tuner", "test_coordinator", "test_placement"]


def _twin(name: str) -> types.ModuleType:
    with open(os.path.join(_TESTS, name + ".py")) as fh:
        src = fh.read()
    for pkg in ("core", "runtime"):
        src = src.replace(f"repro.{pkg}", f"repro_torch.{pkg}")
    assert "import jax" not in src and "from repro." not in src, name
    mod = types.ModuleType(f"port_twin_{name}")
    mod.__file__ = os.path.join(_TESTS, name + ".py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


def _twin_cases():
    cases = []
    for name in TWIN_MODULES:
        mod = _twin(name)
        for fn_name, fn in vars(mod).items():
            if not fn_name.startswith("test_") or not callable(fn):
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                cases.append(pytest.param(name, fn_name, {}, id=f"{name}::{fn_name}"))
                continue
            (mark,) = marks
            argnames = [a.strip() for a in mark.args[0].split(",")] if isinstance(mark.args[0], str) else list(mark.args[0])
            for i, values in enumerate(mark.args[1]):
                values = values if len(argnames) > 1 else (values,)
                cases.append(pytest.param(name, fn_name, dict(zip(argnames, values)), id=f"{name}::{fn_name}[{i}]"))
    return cases


_TWINS: dict[str, types.ModuleType] = {}


@pytest.mark.parametrize("module,test,kwargs", _twin_cases())
def test_port_twin(module, test, kwargs):
    """The original test's body, run on the port's copies."""
    if module not in _TWINS:
        _TWINS[module] = _twin(module)
    getattr(_TWINS[module], test)(**kwargs)
