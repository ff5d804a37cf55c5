"""The port's serving path against ``repro.serve`` on the CPU.

The copied arrival process and batcher must hand out the same requests and
slots as the reference for the same seed; the port's ServeEngine must emit
the same greedy tokens as ``repro.serve.ServeEngine`` for the same request
sequence, prompts and (bridged) weights, in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs.gpt import GPT_CONFIGS as JAX_GPT
from repro.core import make_plan as jax_make_plan
from repro.serve import ArrivalProcess as JaxArrivals
from repro.serve import ContinuousBatcher as JaxBatcher
from repro.serve import InFlight as JaxInFlight
from repro.serve import Request as JaxRequest
from repro.serve import RequestQueue as JaxQueue
from repro.serve import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.core import make_plan
from repro_torch.launch import serve_decode
from repro_torch.launch.serve_adaptive import build_serve_scenario
from repro_torch.serve import (
    ArrivalProcess,
    ContinuousBatcher,
    InFlight,
    Request,
    RequestQueue,
    ServeEngine,
)

SMALL = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


@pytest.mark.parametrize("seed,burst", [(0, 1.0), (1, 3.0), (7, 2.0)])
def test_arrivals_match_reference(seed, burst):
    kw = dict(seed=seed, burst_factor=burst, mean_calm=1.5, mean_burst=0.6,
              prompt_len=(128, 512), new_tokens=(16, 48))
    ours, theirs = ArrivalProcess(6.0, **kw), JaxArrivals(6.0, **kw)
    for until in (0.5, 2.0, 10.0):
        a, b = ours.drain(until), theirs.drain(until)
        assert [tuple(vars(r).values()) for r in a] == [tuple(vars(r).values()) for r in b]
    assert ours.next_arrival_after(10.0) == theirs.next_arrival_after(10.0)


def test_batcher_matches_reference_slot_assignment():
    sides = [(ContinuousBatcher(4), RequestQueue(), Request), (JaxBatcher(4), JaxQueue(), JaxRequest)]
    trails = []
    for batcher, queue, req in sides:
        trail = []
        for rid in range(7):
            queue.push(req(rid, 0.0, 8, 1 + rid % 3))
        for step in range(6):
            done = batcher.retire_finished(float(step))
            admitted = batcher.admit(queue, float(step))
            trail.append(([i.request.rid for i in done], [(i.request.rid, i.slot) for i in admitted]))
            for inf in batcher.in_flight:
                inf.tokens_emitted += 1
        trails.append(trail)
    assert trails[0] == trails[1]


def test_engine_tokens_match_reference_engine():
    jcfg = JAX_GPT["GPT-2.7B"].replace(**SMALL, dtype=jnp.float32)
    tcfg = GPT_CONFIGS["GPT-2.7B"].replace(**SMALL, dtype=torch.float32)
    ref = JaxEngine(jcfg, num_stages=4, max_slots=8, max_len=32, init_key=0)
    ref.switch_to(jax_make_plan(4, 4, 1).lower())  # M = 4 -> grid [4, 2]
    params = bridge.params_from_repro(_flat(ref.params), tcfg, device="cpu")
    reqs = [(0, 9, 0), (1, 5, 3), (2, 12, 5)]  # (rid, prompt_len, slot)
    prompts = {
        rid: np.array(jax.random.randint(jax.random.PRNGKey(rid), (1, n), 0, jcfg.vocab_size, jnp.int32))
        for rid, n, _ in reqs
    }
    ours = ServeEngine(tcfg, 4, max_slots=8, max_len=32, params=params, device="cpu",
                       prompt_fn=lambda rid, n: prompts[rid])
    ours.switch_to(make_plan(4, 4, 1).lower())  # the port's own lowered plan
    jinf = {rid: JaxInFlight(JaxRequest(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs}
    tinf = {rid: InFlight(Request(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs}

    def both(fn_ref, fn_ours):
        fn_ref()
        fn_ours()

    both(lambda: ref.prefill([jinf[0], jinf[1]]), lambda: ours.prefill([tinf[0], tinf[1]]))
    for _ in range(2):
        both(lambda: ref.decode_tick([jinf[0], jinf[1]]), lambda: ours.decode_tick([tinf[0], tinf[1]]))
    both(lambda: ref.prefill([jinf[2]]), lambda: ours.prefill([tinf[2]]))
    both(lambda: ref.decode_tick(list(jinf.values())), lambda: ours.decode_tick(list(tinf.values())))
    both(lambda: ref.release([0]), lambda: ours.release([0]))
    both(lambda: ref.decode_tick([jinf[1], jinf[2]]), lambda: ours.decode_tick([tinf[1], tinf[2]]))
    ref.runtime.cache.shutdown()

    assert ours.outputs == ref.outputs
    assert [len(ours.outputs[r]) for r in range(3)] == [4, 5, 3]
    np.testing.assert_array_equal(ours.positions.numpy(), np.asarray(ref.positions))


def _tiny_cfg():
    return GPT_CONFIGS["GPT-2.7B"].replace(**SMALL, dtype=torch.float32)


def test_serve_loop_completes_deterministically():
    def run():
        engine = ServeEngine(_tiny_cfg(), 4, max_slots=4, max_len=32, seed=3, device="cpu")
        arrivals = ArrivalProcess(8.0, seed=2, prompt_len=(4, 12), new_tokens=(2, 6))
        cand = serve_decode.static_candidate(4, 4, 2)
        sc = build_serve_scenario(seed=2, max_slots=4, adaptive=False, engine=engine,
                                  arrivals=arrivals, candidates=[cand])
        rt = sc.runtime
        return rt.run(5), engine.outputs, [(t.phase, t.occupancy, t.start) for t in rt.ticks]

    (s1, out1, ticks1), (s2, out2, ticks2) = run(), run()
    assert s1["requests_completed"] >= 5 and not s1["nonfinite_logits"]
    assert out1 == out2 and ticks1 == ticks2
    assert s1["prefill_calls"] == s1["requests_admitted"]
    assert s1["tokens"] == sum(len(toks) for toks in out1.values())


def test_serve_decode_entry_point_runs_on_cpu(tmp_path):
    out = tmp_path / "summary.json"
    rc = serve_decode.main([
        "--tiny", "--device", "cpu", "--requests", "3", "--prompt-len", "4", "10",
        "--new-tokens", "2", "4", "--max-len", "32", "--out", str(out),
    ])
    assert rc == 0
    import json

    s = json.loads(out.read_text())
    assert s["requests_completed"] >= 3 and s["num_layers"] == 2 and s["grid"] == [4, 2]
