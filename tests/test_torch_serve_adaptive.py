"""The port's adaptive serving (``ServeRuntime`` with the tuner, ``SLOTracker``,
``launch/serve_adaptive``) against ``repro.serve`` on the CPU.

* **Twins** of ``tests/test_serve.py``'s tests of ``SLOTracker``,
  ``make_slo_objective`` and the serving scenario: each test's source is
  run once more with ``repro.`` replaced by ``repro_torch.`` (the port's
  scenario prices on its default spec, ``h100-sxm``).  The stateless
  ``PlanRuntime`` tests are ported by hand (the reference's factory
  returns a jitted function and its argument specs).
* **Equality**: ``compare_adaptive_static(24, "fig10", seed)`` for seeds 0
  and 1, priced on ``tpu-v5e`` and on ``h100-sxm``, equal to ``repro``'s
  (``==`` on the whole result, floats included: the copies of the decision
  layer and the SLO tracker run the same Python and numpy arithmetic in
  the same order).
* **Tokens across live switches**: the adaptive Fig-10 scenario with both
  engines (a narrow GPT config in fp32, bridged weights, ``repro``'s
  prompts): the port's ``outputs`` equal ``repro``'s ``ServeEngine.outputs``
  token for token.
* ``make_serve_step``, the CLI, and the engine's plan checks.
"""

import ast
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve_adaptive as jax_sa
from repro.checkpoint.io import _path_str
from repro.configs.gpt import GPT_CONFIGS as JAX_GPT
from repro.models import api as jax_api
from repro.serve import ServeEngine as JaxEngine
from repro.training import make_serve_step as jax_make_serve_step
from repro_torch import bridge
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import make_plan
from repro_torch.launch import serve_adaptive
from repro_torch.models import api
from repro_torch.obs import Observability, spans_by_track
from repro_torch.runtime import PlanRuntime
from repro_torch.serve import ServeEngine
from repro_torch.training import make_serve_step

_TESTS = os.path.dirname(os.path.abspath(__file__))
SMALL = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _cfgs():
    jcfg = JAX_GPT["GPT-2.7B"].replace(**SMALL, dtype=jnp.float32)
    tcfg = GPT_CONFIGS["GPT-2.7B"].replace(**SMALL, dtype=torch.float32)
    return jcfg, tcfg


# -- twins of repro's serving tests ----------------------------------------------------

#: the tests of tests/test_serve.py that run on the port unchanged but for the
#: package name, and the helpers they call
TWIN_TESTS = [
    "test_slo_tracker_exact_ttft_tpot",
    "test_slo_tracker_attainment_mixed",
    "test_slo_tracker_quantiles_match_numpy",
    "test_slo_request_spans_disjoint_per_slot",
    "test_quantize_sim_span_touching_stays_touching",
    "test_slo_objective_pressure_gating",
    "test_serve_runtime_completes_and_accounts",
    "test_serve_tuner_crosses_kinds_and_uses_serve_telemetry",
    "test_serve_static_baseline_never_switches",
    "test_serve_chosen_spec_diverges_across_regimes",
    "test_serve_trace_tracks_pass_no_overlap_gate",
]
_HELPERS = ["_req", "_small_run"]
_TWIN: dict = {}


def _twin_namespace() -> dict:
    """The twinned functions, compiled against the port's packages."""
    if _TWIN:
        return _TWIN
    path = os.path.join(_TESTS, "test_serve.py")
    with open(path) as fh:
        src = fh.read()
    tree = ast.parse(src)
    wanted = set(TWIN_TESTS + _HELPERS)
    parts = [ast.get_source_segment(src, n) for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in wanted]
    body = "\n\n\n".join(parts).replace("repro.", "repro_torch.")
    assert "jax" not in body and "from repro." not in body
    header = (
        "import numpy as np\nimport pytest\n"
        "from repro_torch.obs import Observability\n"
        "from repro_torch.obs.trace import quantize_sim_span, spans_by_track, validate_no_overlap\n"
        "from repro_torch.serve import InFlight, Request, SLOTracker, make_slo_objective\n\n\n"
    )
    exec(compile(header + body, path, "exec"), _TWIN)
    assert set(TWIN_TESTS) <= set(_TWIN)
    return _TWIN


@pytest.mark.parametrize("name", TWIN_TESTS)
def test_port_twin(name):
    """The original test's body, run on the port."""
    _twin_namespace()[name]()


# -- the stateless PlanRuntime (tests/test_serve.py's, ported by hand) -----------------


def test_plan_runtime_stateless_requires_factory():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="program_factory"):
        PlanRuntime(tcfg, 2, optimizer=None, global_batch=4, seq_len=8, device="cpu")


def test_plan_runtime_stateless_run_program():
    _, tcfg = _cfgs()

    def factory(table):
        scale = float(table.plan.num_microbatches)
        return lambda x: x * scale

    rt = PlanRuntime(tcfg, 2, optimizer=None, global_batch=4, seq_len=8, program_factory=factory, device="cpu")
    assert rt.state is None
    with pytest.raises(RuntimeError, match="switch_to"):
        rt.run_program(torch.ones(4))
    with pytest.raises(RuntimeError, match="run_program"):
        rt.run_iteration(torch.zeros((4, 8), dtype=torch.long), torch.zeros((4, 8), dtype=torch.long))
    p1 = make_plan(2, 2, 1).lower()
    p2 = make_plan(2, 4, 1).lower()
    rt.switch_to(p1)
    out, seconds = rt.run_program(torch.ones(4))
    np.testing.assert_allclose(out.numpy(), 2.0 * np.ones(4))
    assert seconds >= 0.0
    # a switch to another plan dispatches its program and never touches
    # the (absent) train state
    rt.switch_to(p2)
    out, _ = rt.run_program(torch.ones(4))
    np.testing.assert_allclose(out.numpy(), 4.0 * np.ones(4))
    rt.cache.shutdown()


def test_plan_runtime_labels_the_cache_series_by_track():
    """``obs_track`` names the trace tracks and labels the compile cache's
    series on the shared registry, as ``repro``'s does."""
    _, tcfg = _cfgs()
    obs = Observability.create()
    rts = [
        PlanRuntime(tcfg, 2, optimizer=None, global_batch=4, seq_len=8, device="cpu",
                    program_factory=lambda t: (lambda: None), obs=obs, obs_track=track)
        for track in ("serve", "other")
    ]
    rts[0].switch_to(make_plan(2, 2, 1).lower())
    rts[0].run_program()
    rts[0].switch_to(make_plan(2, 2, 1).lower())
    assert rts[0].cache.stats.gets == 2 and rts[0].cache.stats.cold_misses == 1
    assert rts[1].cache.stats.gets == 0
    assert {"serve/switches", "serve/iterations"} <= set(spans_by_track(obs.trace.to_chrome_trace()))


# -- the headline comparison against repro ---------------------------------------------


@pytest.mark.parametrize("spec", ["tpu-v5e", "h100-sxm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compare_adaptive_static_equals_reference(spec, seed):
    """The decision trail, kinds, every simulated quantile, tick count and
    sim_time (the whole result, compared with ``==``)."""
    ours = serve_adaptive.compare_adaptive_static(24, "fig10", seed, device_spec=spec)
    orig = jax_sa.serve_costs
    with mock.patch.object(jax_sa, "serve_costs", lambda device="tpu-v5e": orig(spec)):
        theirs = jax_sa.compare_adaptive_static(24, "fig10", seed)
    assert ours == theirs
    a = ours["adaptive"]
    assert len(a["kinds_chosen"]) >= 2 and a["ticks"] > 0 and a["requests_completed"] == 24


@pytest.mark.parametrize("spec", ["tpu-v5e", "h100-sxm"])
def test_chosen_specs_by_regime_equals_reference(spec):
    ours = serve_adaptive.chosen_specs_by_regime(12, seed=0, device_spec=spec)
    orig = jax_sa.serve_costs
    with mock.patch.object(jax_sa, "serve_costs", lambda device="tpu-v5e": orig(spec)):
        theirs = jax_sa.chosen_specs_by_regime(12, seed=0)
    assert ours == theirs
    assert ours["bursty"]["final"] != ours["exclusive"]["final"]


def test_serve_costs_equal_reference():
    for spec in ("tpu-v5e", "h100-sxm"):
        for ours, theirs in zip(serve_adaptive.serve_costs(spec), jax_sa.serve_costs(spec)):
            assert vars(ours) == vars(theirs)


# -- real tokens across the tuner's live switches --------------------------------------


def test_engine_tokens_match_reference_across_live_switches():
    """Both engines behind the adaptive Fig-10 scenario (priced on
    ``repro``'s default spec), 12 requests: the port's greedy tokens equal
    ``repro``'s token for token, through every switch the tuner makes."""
    jcfg, tcfg = _cfgs()
    ref = JaxEngine(jcfg, num_stages=4, max_slots=8, max_len=80, init_key=0)
    params = bridge.params_from_repro(_flat(ref.params), tcfg, device="cpu")

    def repro_prompt(rid, n):  # repro/serve/engine.py's prompt of request rid
        return np.array(jax.random.randint(jax.random.PRNGKey(rid), (1, n), 0, jcfg.vocab_size, jnp.int32))

    ours = ServeEngine(tcfg, 4, 8, 80, params=params, device="cpu", prompt_fn=repro_prompt)
    jsc = jax_sa.build_serve_scenario(seed=0, adaptive=True, engine=ref)
    tsc = serve_adaptive.build_serve_scenario(seed=0, adaptive=True, engine=ours, device_spec="tpu-v5e")
    theirs_summary = jsc.runtime.run(12)
    ours_summary = tsc.runtime.run(12)
    ref.runtime.cache.shutdown()

    assert ours.outputs == ref.outputs
    assert len(ours.outputs) >= 12
    assert ours_summary["decision_trail"] == theirs_summary["decision_trail"]
    assert len(ours_summary["kinds_chosen"]) >= 2
    switched = [e.to_plan for e in ours.runtime.switch_events]
    assert len(set(switched)) >= 2, switched
    stats = ours.runtime.cache.stats
    assert stats.cold_misses == len(set(switched)) and stats.warm_hits == len(switched) - len(set(switched))
    assert ours_summary["prefill_calls"] == ours_summary["requests_admitted"]
    assert ours_summary["requests_completed_exactly"] == ours_summary["requests_completed"] >= 12
    assert not ours_summary["nonfinite_logits"]
    assert set(ours_summary["decode_tick_ms_p50_by_plan"]) <= set(switched)
    np.testing.assert_array_equal(ours.positions.numpy(), np.asarray(ref.positions))


def test_engine_free_summary_has_exactly_the_reference_keys():
    jsc = jax_sa.build_serve_scenario(seed=0)
    tsc = serve_adaptive.build_serve_scenario(seed=0, device_spec="tpu-v5e")
    assert set(tsc.runtime.run(6)) == set(jsc.runtime.run(6))


def test_engine_rejects_a_plan_whose_m_does_not_divide_the_slots():
    _, tcfg = _cfgs()
    eng = ServeEngine(tcfg, 2, 6, 16, seed=0, device="cpu")
    with pytest.raises(ValueError, match="M=4"):
        eng.switch_to(make_plan(2, 4, 1).lower())
    eng.switch_to(make_plan(2, 3, 1).lower())  # M = 3 divides 6: a [3, 2] grid
    assert eng.runtime.current_table.plan.num_microbatches == 3


# -- make_serve_step -------------------------------------------------------------------


def test_make_serve_step_greedy_equals_reference():
    jcfg, tcfg = _cfgs()
    jparams = jax_api.init_params(jax.random.PRNGKey(3), jcfg)
    params = bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (3, 7))
    jcache = jax_api.init_cache(jcfg, 3, 16)
    _, jcache = jax_api.prefill_with_cache(jparams, jcfg, jcache, {"tokens": jnp.asarray(prompts, jnp.int32)})
    cache = api.init_cache(tcfg, 3, 16, device="cpu")
    api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.tensor(prompts)})
    jserve = jax_make_serve_step(lambda p, c, i, tokens: jax_api.decode_fn(p, jcfg, c, i, {"tokens": tokens}))
    serve = make_serve_step(lambda p, c, i, tokens: api.decode_fn(p, tcfg, c, i, {"tokens": tokens}))
    jtok = jnp.asarray(prompts[:, -1:], jnp.int32)
    tok = torch.tensor(prompts[:, -1:])
    for i in range(7, 11):
        jt, jcache = jserve(jparams, jcache, i, {"tokens": jtok})
        t, cache = serve(params, cache, i, {"tokens": tok})
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        jtok, tok = jt[:, None], t[:, None]


def _fixed_logits_step(logits: torch.Tensor, temperature: float):
    """A serve step over a decode_fn that returns ``logits`` for every row."""
    return make_serve_step(lambda p, c, i, tokens: (logits.expand(tokens.shape[0], 1, -1), c), temperature)


def test_make_serve_step_sampling_is_reproducible_with_a_fixed_generator():
    logits = torch.tensor(np.random.default_rng(1).normal(size=(1, 1, 32)), dtype=torch.float32)
    serve = _fixed_logits_step(logits, temperature=0.7)
    tokens = torch.zeros((64, 1), dtype=torch.long)
    a, _ = serve(None, None, 0, {"tokens": tokens}, generator=torch.Generator().manual_seed(5))
    b, _ = serve(None, None, 0, {"tokens": tokens}, generator=torch.Generator().manual_seed(5))
    c, _ = serve(None, None, 0, {"tokens": tokens}, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    # no generator: greedy, as the reference is without a key
    g, _ = serve(None, None, 0, {"tokens": tokens})
    assert (g == logits[0, 0].argmax()).all()


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_make_serve_step_frequencies_match_softmax(temperature):
    """20 000 draws: every token's frequency within 5 standard deviations,
    5 * sqrt(p (1 - p) / n) (at most 0.0177), of softmax(logits / T)."""
    n = 20_000
    logits = torch.tensor(np.random.default_rng(2).normal(size=(1, 1, 8)) * 2.0, dtype=torch.float32)
    serve = _fixed_logits_step(logits, temperature)
    draws, _ = serve(None, None, 0, {"tokens": torch.zeros((n, 1), dtype=torch.long)},
                     generator=torch.Generator().manual_seed(0))
    freq = torch.bincount(draws, minlength=8).double() / n
    p = torch.softmax(logits[0, 0].double() / temperature, dim=-1)
    bound = 5 * torch.sqrt(p * (1 - p) / n)
    assert ((freq - p).abs() <= bound).all(), (freq, p)


# -- the CLI ---------------------------------------------------------------------------


def test_serve_adaptive_cli_with_a_tiny_engine_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    rc = serve_adaptive.main(["--device", "cpu", "--tiny", "--engine", "--requests", "12", "--out", str(out)])
    assert rc == 0
    s = json.loads(out.read_text())
    a, st = s["adaptive"], s["static"]
    assert a["requests_completed"] >= 12 and st["requests_completed"] >= 12
    assert s["device_spec"] == "h100-sxm" and s["num_layers"] == 2 and s["device"] == "cpu"
    assert s["first_tokens_equal"] and 0.0 <= s["outputs_equal_share"] <= 1.0
    # the decisions and every simulated number are the engine-free run's
    free = serve_adaptive.compare_adaptive_static(12, "fig10", 0)
    for run in ("adaptive", "static"):
        assert {k: v for k, v in s[run].items() if k in free[run]} == json.loads(json.dumps(free[run]))
    cache = a["compile_cache"]
    assert cache["cold_misses"] + cache["warm_hits"] == cache["gets"] == len(a["switch_seconds"])
    assert cache["cold_misses"] >= len(a["kinds_chosen"]) and st["compile_cache"]["gets"] == 1


def test_serve_adaptive_cli_engine_free_writes_only_where_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_SMOKE", "1")
    assert serve_adaptive.main(["--device", "cpu", "--requests", "80"]) == 0
    assert list(tmp_path.iterdir()) == []
