"""The port's cross-host fabric (``repro_torch.runtime.fabric``) against ``repro``'s.

* Every test of ``tests/test_fabric.py`` run on the port (source twins: the
  module's source with ``repro.{core,runtime,launch}`` swapped for the
  port's, the workers on the CPU): the pessimistic merge, the barrier's
  commits and aborts, the control plane driven by hand, the fleets'
  commit, rollback and straggler soak.
* The control plane against ``repro``'s: one ``CoordinatorServer`` in each
  package over the same hosts and injected clock, fed the same telemetry
  windows (a slow partition included), votes and polls, gives the same
  merged samples, tuner decisions, barrier history and ``fabric_metrics()``.
* The fleet against ``repro``'s: two hosts under the scripted trail kfkb
  k=1 -> 2F2B -> interleaved_zb (v=2) -> kfkb k=1, the port's runtimes
  loaded with ``repro``'s initial states through the bridge: every loss
  within 5e-6 of ``repro``'s (its own limit in ``tests/test_fabric.py``),
  the final parameters and AdamW moments within atol 5e-6, the applied
  outcomes equal.
* The passive tuner (``decision_fn=None``, ``tuning_interval=0``): a tiny
  iteration on the CPU is far faster than the cost model's estimate at
  infinite bandwidth (fwd 1 s, bwd 2 s a micro-batch), so every host's
  inversion clamps to ``bw_hi`` in both packages, and the chosen sequences
  are equal.
* Two ``fabric_worker`` processes over TCP on the CPU (twin of
  ``tests/test_fabric_distributed.py``), each held to an in-process oracle.
* The CLIs, the ``ServeEngine`` that is freed without a garbage
  collection, and (on a card) a two-host GPT-2.7B fleet.

``repro``'s side shares one step cache across its hosts, as its own tests
do, so each plan is jitted once.
"""

import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import types
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.launch.fabric_worker as jfabric_worker
import repro.launch.train_adaptive as jtrain_adaptive
import repro.runtime.fabric as jfabric
from repro.checkpoint.io import _path_str
import repro_torch.core as P
from repro_torch import bridge
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.launch import fabric_worker, serve_adaptive, train_adaptive
from repro_torch.obs.trace import merge_traces, spans_by_track, validate_chrome_trace
from repro_torch.runtime import fabric
from repro_torch.serve import ServeEngine

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)
#: repro's fleet size in tests/test_fabric.py: S = 2, d_model 8, seq 16
TINY = dict(num_stages=2, d_model=8, seq_len=16)
#: the per-iteration loss limit of repro's fleet-vs-oracle test, and the
#: state limit of the port's runtime against repro's (test_torch_runtime)
LOSS_TOL = STATE_TOL = 5e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work (and its worker
    processes): two packages' fleets share the CPU with the suite's other
    workers, and spinning thread pools oversubscribe it.  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _NullTransport:
    """Oracle transport: no coordinator, no commands."""

    def request(self, msg):
        return None


# -- twins of tests/test_fabric.py ---------------------------------------------------------


def _twin() -> types.ModuleType:
    with open(os.path.join(_TESTS, "test_fabric.py")) as fh:
        src = fh.read()
    for pkg in ("core", "runtime", "launch"):
        src = src.replace(f"repro.{pkg}", f"repro_torch.{pkg}")
    assert "import jax" not in src and "from repro." not in src and "import repro." not in src
    mod = types.ModuleType("port_twin_test_fabric")
    mod.__file__ = os.path.join(_TESTS, "test_fabric.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    # the port's workers run on the card unless asked for the CPU
    mod.build_worker = functools.partial(fabric_worker.build_worker, device="cpu")
    return mod


_TWIN: list = []


def _twin_names() -> list[str]:
    return [n for n, fn in vars(_twin()).items() if n.startswith("test_") and callable(fn)]


@pytest.mark.parametrize("test", _twin_names())
def test_port_twin(test):
    """The original test's body, run on the port's fabric."""
    if not _TWIN:
        _TWIN.append(_twin())
    getattr(_TWIN[0], test)()


def test_every_fabric_test_has_a_twin():
    assert len(_twin_names()) == 19


# -- the control plane against repro's ------------------------------------------------------


class _TickClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


#: per round, host b's bandwidth (host a's is A_BW): a slow partition, on
#: which the tuner prefers ZB-H2+2, at rounds 3-7; on the fast network it
#: prefers I2ZB
A_BW = 1e3
B_BW = [1e3, 1e3, 1e3, 0.5, 0.5, 0.5, 0.5, 0.5, 1e3, 1e3, 1e3, 1e3, 1e3, 1e3, 1e3, 1e3]
#: per epoch, how host b answers a PREPARE (host a always votes ready)
B_VOTES = {2: "refuse", 3: "silent"}


def _control_plane_run(core, fab, fig10_parts) -> dict:
    """Drive one package's ``CoordinatorServer`` through :data:`B_BW`'s
    rounds by hand: windows, votes (host b refuses epoch 2 and never answers
    epoch 3) and boundary polls (each reads the tick clock, so epoch 3 ends
    at its deadline); returns everything the server decided."""
    _, costs, cands, _ = fig10_parts(4)
    tuner = core.AutoTuner(cands, lambda c: costs, core.NetworkProfiler(None, window=4),
                           passive_staleness=float("inf"))
    server = fab.CoordinatorServer(
        ("a", "b"), initial_spec=cands[0].spec, tuner=tuner,
        config=fab.FabricConfig(tuning_interval=0.0, vote_timeout=30.0, boundary_lead=1), clock=_TickClock(),
    )
    links = fab.fabric_probe_links(cands, lambda c: costs)
    specs = {h: cands[0].spec for h in server.hosts}
    pending: dict = {}
    merged, effective, outcomes = [], [], []
    for r, b_bw in enumerate(B_BW):
        for h, bw in (("a", A_BW), ("b", b_bw)):
            t = r + (0.1 if h == "b" else 0.0)
            samples = tuple(core.LinkSample(src, dst, nb, nb / bw, now=t) for src, dst, nb in links)
            reply = server.handle(fab.TelemetryWindow(h, r, 1.0, t, specs[h], samples, loss=1.0))
            if isinstance(reply, fab.PrepareSwitch):
                pending[h] = reply
                how = B_VOTES.get(reply.epoch) if h == "b" else None
                if how != "silent":
                    server.handle(fab.ReadyVote(reply.epoch, h, how != "refuse", 0.0, how or ""))
        merged.append([dataclasses.astuple(s) for s in core.merge_link_samples(
            {h: server.windows[h][-1].samples for h in server.hosts})])
        effective.append([tuner.net_profiler.effective_time(src, dst, nb) for src, dst, nb in links])
        for h, cmd in list(pending.items()):
            if r + 1 < cmd.boundary:
                continue
            out = None
            while out is None:
                out = server.handle(fab.OutcomePoll(cmd.epoch, h, r + 1))
            outcomes.append((h, out.epoch, out.committed, out.boundary, dataclasses.asdict(out.spec)))
            if out.committed:
                specs[h] = out.spec
            del pending[h]
    return {
        "merged": merged,
        "effective": effective,
        "decisions": [(d["t"], d["chosen"], dataclasses.asdict(d["spec"])) for d in server.decision_log],
        "barrier": [(r.epoch, r.boundary, r.committed, r.reason, r.latency, dataclasses.asdict(r.spec))
                    for r in server.barrier.history],
        "outcomes": outcomes,
        "metrics": server.fabric_metrics(),
        "trace": json.loads(json.dumps(server.telemetry_trace())),
    }


def test_control_plane_equals_reference():
    got = _control_plane_run(P, fabric, train_adaptive.fig10_parts)
    want = _control_plane_run(J, jfabric, jtrain_adaptive.fig10_parts)
    assert got == want
    # the scenario reaches every verdict: a commit, a refusal and a deadline
    reasons = [r[3] for r in got["barrier"]]
    assert any(r[2] for r in got["barrier"])
    assert any(x.startswith("refused") for x in reasons) and any(x.startswith("deadline") for x in reasons)
    assert len({d[1] for d in got["decisions"]}) >= 2  # the slow partition moved the tuner


# -- the fleet against repro's ----------------------------------------------------------------


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


#: the scripted trail, as indices into fig10_parts' candidates: 2F2B,
#: interleaved_zb (v=2), back to 1F1B
TRAIL = (1, 4, 0)
FLEET_ROUNDS = 8
_REPRO_CACHE: list = []  # repro's one step cache, shared by every repro host here


def _scripted(cands):
    def decide(server):
        n = len(server.barrier.history)
        return cands[TRAIL[n]].spec if n < len(TRAIL) else None

    return decide


def _repro_worker(host, index, transport):
    w = jfabric_worker.build_worker(host, index, transport, cache=_REPRO_CACHE[0] if _REPRO_CACHE else None, **TINY)
    _REPRO_CACHE[:1] = [w.runtime.cache]
    return w


def _fleets(decision_fn_of, tuner_of=None):
    """The same two-host fleet in both packages (``repro``'s hosts sharing
    one step cache), the port's runtimes loaded with ``repro``'s initial
    states; returns ``(port server, port workers, repro server, repro workers)``."""
    out = []
    for core, fab, parts, build in (
        (J, jfabric, jtrain_adaptive.fig10_parts, _repro_worker),
        (P, fabric, train_adaptive.fig10_parts,
         functools.partial(fabric_worker.build_worker, device="cpu", **TINY)),
    ):
        _, costs, cands, _ = parts(2, d_model=TINY["d_model"])
        tuner = tuner_of(core, cands, costs) if tuner_of else None
        server = fab.CoordinatorServer(
            ("host0", "host1"), initial_spec=cands[0].spec, tuner=tuner,
            config=fab.FabricConfig(tuning_interval=0.0, vote_timeout=300.0, boundary_lead=1),
            decision_fn=decision_fn_of(cands) if decision_fn_of else None,
        )
        workers = [build(h, i, fab.LocalTransport(server, h)) for i, h in enumerate(server.hosts)]
        out.append((server, workers))
    (jserver, jworkers), (server, workers) = out
    for w, jw in zip(workers, jworkers):
        w.runtime.state = bridge.train_state_from_repro(_flat(jw.runtime.state), w.runtime.staged_for(1), device="cpu")
    return server, workers, jserver, jworkers


def _applied(workers) -> list:
    return [[(o.epoch, o.boundary, o.committed) for o in w.applied_outcomes] for w in workers]


def test_fleet_trail_equals_reference_fleet():
    server, workers, jserver, jworkers = _fleets(_scripted)
    for _ in range(FLEET_ROUNDS):
        for w, jw in zip(workers, jworkers):
            jres, res = jw.step(), w.step()
            assert res.plan_name == jres.plan_name
            assert abs(res.loss - float(jres.loss)) < LOSS_TOL, (w.host, res.index)
    assert [(r.epoch, r.boundary, r.committed) for r in server.barrier.history] == [
        (r.epoch, r.boundary, r.committed) for r in jserver.barrier.history]
    assert [r.committed for r in server.barrier.history] == [True] * len(TRAIL)
    assert _applied(workers) == _applied(jworkers)
    for w in workers:  # every host switched at the same boundaries and restacked both ways
        assert [e.restacked for e in w.runtime.switch_events] == [False, False, True, True]
        assert w.runtime.current_v == 1
    for w, jw in zip(workers, jworkers):
        got = bridge.train_state_to_repro(w.runtime.state, w.runtime.staged_for(1))
        want = _flat(jw.runtime.state)
        assert sorted(got) == sorted(want)
        for key, a in want.items():
            np.testing.assert_allclose(got[key], a, atol=STATE_TOL, err_msg=f"{w.host}: {key}")
    # all but the barrier's wall-clock latency, which holds repro's jit in the prepare phase
    drop = lambda m: {k: v for k, v in m.items() if k != "barrier_latency_max"}  # noqa: E731
    assert drop(server.fabric_metrics()) == drop(jserver.fabric_metrics())
    for w in workers:
        w.runtime.cache.shutdown()


def _passive_tuner(core, cands, costs):
    return core.AutoTuner(cands, lambda c: costs, core.NetworkProfiler(None, window=4),
                          passive_staleness=float("inf"))


PASSIVE_ROUNDS = 4


@pytest.fixture(scope="module")
def passive_fleets():
    server, workers, jserver, jworkers = _fleets(None, _passive_tuner)
    jsummary = jtrain_adaptive.run_fabric_rounds(jserver, jworkers, PASSIVE_ROUNDS)
    summary = train_adaptive.run_fabric_rounds(server, workers, PASSIVE_ROUNDS)
    yield server, workers, jserver, summary, jsummary
    for w in workers:
        w.runtime.cache.shutdown()


def _clamped(server) -> bool:
    """Every link sample every host sent is the inversion's ``bw_hi`` clamp:
    an iteration faster than the cost model's estimate at infinite bandwidth."""
    return all(s.duration == s.nbytes / 1e15 for ws in server.windows.values() for w in ws for s in w.samples)


def test_passive_tuner_chooses_like_reference(passive_fleets):
    server, workers, jserver, summary, jsummary = passive_fleets
    assert _clamped(server) and _clamped(jserver)
    chosen = [d["chosen"] for d in server.decision_log]
    assert chosen == [d["chosen"] for d in jserver.decision_log]
    assert chosen and server.barrier.history  # the tuner decided and dispatched
    assert [(r.epoch, r.boundary, r.committed) for r in server.barrier.history] == [
        (r.epoch, r.boundary, r.committed) for r in jserver.barrier.history]
    drop = lambda m: {k: v for k, v in m.items() if k != "barrier_latency_max"}  # noqa: E731
    assert drop(summary["fabric"]) == drop(jsummary["fabric"])
    for h, want in jsummary["hosts"].items():
        got = summary["hosts"][h]
        assert got["spec"] == want["spec"] and got["switches"] == want["switches"]
        assert np.allclose(got["losses"], want["losses"], atol=1e-4)  # both rounded to 4 places


def test_passive_fleet_is_deterministic():
    """The port's own entry point, twice: the same decisions and losses."""
    runs = []
    for _ in range(2):
        server, workers = train_adaptive.build_fabric_fleet(device="cpu", **TINY)
        out = train_adaptive.run_fabric_rounds(server, workers, 3)
        runs.append(([d["chosen"] for d in server.decision_log], [out["hosts"][h]["losses"] for h in server.hosts]))
        assert _clamped(server)
        for w in workers:
            w.runtime.cache.shutdown()
    assert runs[0] == runs[1]


# -- two processes over TCP (twin of tests/test_fabric_distributed.py) ----------------------

_ITERS = 4


def _worker_cmd(port, host, index, out, trace):
    return [
        sys.executable, "-m", "repro_torch.launch.fabric_worker",
        "--connect", f"127.0.0.1:{port}",
        "--host", host, "--host-index", str(index),
        "--iterations", str(_ITERS),
        "--stages", "2", "--d-model", "8", "--seq-len", "16",
        "--device", "cpu", "--out", out, "--trace", trace,
    ]


def test_two_process_fleet_switches_once_and_matches_oracles(tmp_path):
    _, _, cands, _ = train_adaptive.fig10_parts(2, d_model=8)
    target = cands[1].spec

    def one_shot(server):
        return target if not server.barrier.history else None

    server = fabric.CoordinatorServer(
        ("host0", "host1"), initial_spec=cands[0].spec, tuner=None,
        config=fabric.FabricConfig(vote_timeout=300.0, boundary_lead=1),
        decision_fn=one_shot,
    )
    listener = fabric.CoordinatorListener(server).start()
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "OMP_NUM_THREADS": "1"}
    outs = {h: str(tmp_path / f"{h}.json") for h in server.hosts}
    traces = {h: str(tmp_path / f"{h}_trace.json") for h in server.hosts}
    procs = []
    try:
        for i, h in enumerate(server.hosts):
            procs.append(subprocess.Popen(
                _worker_cmd(listener.port, h, i, outs[h], traces[h]),
                cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        for p in procs:
            stdout, _ = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{stdout}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        listener.stop()

    (rec,) = server.barrier.history
    assert rec.committed and rec.spec == target
    assert server.incumbent == target
    m = server.fabric_metrics()
    assert m["committed_switches"] == 1 and m["aborted_switches"] == 0
    assert m["telemetry_windows"] == 2 * _ITERS

    results = {h: json.load(open(outs[h])) for h in server.hosts}
    for h, r in results.items():
        (applied,) = r["applied"]
        assert applied["committed"] and applied["boundary"] == rec.boundary
        assert r["final_spec"]["kind"] == target.kind and r["final_spec"]["k"] == target.k
        assert r["iterations"] == _ITERS and r["switch_events"] >= 2
        assert all(k["flash_launches"] == 0 for k in r["kernel_launches"])  # the CPU launches no kernel

    shared_cache = None
    for i, h in enumerate(server.hosts):
        oracle = fabric_worker.build_worker(f"oracle-{h}", i, _NullTransport(), cache=shared_cache,
                                            device="cpu", **TINY)
        shared_cache = oracle.runtime.cache
        for it in range(_ITERS):
            if it == rec.boundary:
                oracle.runtime.switch_to(oracle.resolve(target))
            oracle.step()
        got, want = results[h], oracle.runtime
        for a, b in zip(got["losses"], [r.loss for r in want.iterations]):
            assert abs(a - b) < LOSS_TOL
        dg, dw = got["param_digest"], fabric_worker.param_digest(want.state.params)
        assert dg["leaves"] == dw["leaves"]
        assert dg["l2"] == pytest.approx(dw["l2"], rel=1e-6)
    shared_cache.shutdown()

    trace = server.telemetry_trace()
    json.dumps(trace)
    assert all(len(ws) == _ITERS for ws in trace["windows"].values())
    assert set(trace["barrier"][0]["votes"]) == set(server.hosts)
    payloads = [server.obs.trace.to_chrome_trace()]
    for h in server.hosts:
        with open(traces[h]) as f:
            payloads.append(json.load(f))
    merged = merge_traces(payloads)
    validate_chrome_trace(merged)
    assert {"coordinator/barrier", "host0/iterations", "host1/iterations"} <= set(spans_by_track(merged))
    for h in server.hosts:
        with open(traces[h] + ".flight.json") as f:
            flight = json.load(f)
        assert {"plan_switch", "worker_prepare", "worker_outcome"} <= {e["kind"] for e in flight["events"]}


# -- the CLIs ----------------------------------------------------------------------------------


def test_fabric_cli_writes_the_reference_summary_keys(tmp_path, passive_fleets, capsys):
    _, _, _, _, jsummary = passive_fleets
    path = tmp_path / "fabric.json"
    assert train_adaptive.main(["--fabric", "2", "--device", "cpu", "--iterations", "4", "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    assert set(jsummary) | {"wall_seconds"} <= set(out)
    assert set(out["fabric"]) == set(jsummary["fabric"])
    for h in jsummary["hosts"]:
        assert set(jsummary["hosts"][h]) <= set(out["hosts"][h])
        assert out["hosts"][h]["iterations"] == 4
    assert out["fabric"]["telemetry_windows"] == 8
    assert "barrier epochs" in capsys.readouterr().out


def test_fabric_cli_refuses_the_spmd_backend():
    with pytest.raises(SystemExit):
        train_adaptive.main(["--fabric", "2", "--backend", "spmd", "--device", "cpu"])


# -- the ServeEngine is freed without a garbage collection ------------------------------------


def test_dropped_serve_engine_is_freed_without_gc():
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                                          d_ff=64, vocab_size=64)
    plans = [P.make_plan(2, M, spec=P.ScheduleSpec(kind="kfkb", k=1, micro_batch_size=4 // M)).lower()
             for M in (2, 4)]
    gc.collect()
    gc.disable()
    try:
        engine = ServeEngine(cfg, num_stages=2, max_slots=4, max_len=16, device="cpu")
        for table in plans:  # a switch, so the cache holds two programs
            engine.switch_to(table)
            engine.decode_tick([])
        assert not engine.nonfinite
        factory = engine.runtime.cache._factory
        ref = weakref.ref(engine)
        del engine
        assert ref() is None
        with pytest.raises(RuntimeError, match="dropped"):
            factory(plans[0])
    finally:
        gc.enable()


def test_engines_behind_the_adaptive_comparison_are_freed_without_gc():
    """``compare_adaptive_static``'s scenarios hold the engines (the adaptive
    one through its tuner's objective); once it returns, dropping the
    engines frees them without a collection (the serve-adaptive phase's
    gate on the card)."""
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(**serve_adaptive.TINY)
    gc.collect()
    gc.disable()
    try:
        first = ServeEngine(cfg, seed=0, device="cpu", **serve_adaptive.ENGINE_ARGS)
        engines = (first, ServeEngine(cfg, params=first.params, device="cpu", **serve_adaptive.ENGINE_ARGS))
        out = serve_adaptive.compare_adaptive_static(max_requests=4, seed=0, device_spec="h100-sxm", engines=engines)
        assert out["first_tokens_equal"] and len(out["adaptive"]["kinds_chosen"]) >= 2
        refs = [weakref.ref(e) for e in engines]
        del first, engines
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# -- on the card ---------------------------------------------------------------------------------


@pytest.mark.gpu
def test_two_host_gpt_fleet_commits_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, _, cands, _ = train_adaptive.fig10_parts(2, gpt="GPT-2.7B", num_layers=2)
    target = cands[1].spec
    server, workers = train_adaptive.build_fabric_fleet(
        num_stages=2, gpt="GPT-2.7B", num_layers=2, seq_len=256, device="cuda", boundary_lead=1,
        decision_fn=lambda s: target if not s.barrier.history else None,
    )
    out = train_adaptive.run_fabric_rounds(server, workers, 4)
    assert out["fabric"]["committed_switches"] == 1
    for w in workers:
        assert w.current_spec == target and len(w.applied_outcomes) == 1
        assert all(np.isfinite(r.loss) for r in w.runtime.iterations)
        for r in out["hosts"][w.host]["per_iteration"]:
            assert r["flash_launches"] == r["attention_forwards"] > 0
        w.runtime.cache.shutdown()
