"""The port's SSM (Mamba2) serving path against ``repro`` on the CPU.

On mamba2-smoke in fp32 with bridged weights: ``init_cache``,
``prefill_with_cache`` and ``decode_fn`` against ``repro``'s (logits and the
recurrent state and conv window within 1e-5, relative and absolute: fp32
through two layers whose matmuls sum in another order); the port's fused
prefill bitwise equal to its own token stepping; the port's ``ServeEngine``
emitting ``repro``'s greedy tokens; and the chunked SSD (kernel K2 on the
card) off the serving path.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs.mamba2_780m import SMOKE as JAX_SMOKE
from repro.core import make_plan as jax_make_plan
from repro.models import api as jax_api
from repro.serve import InFlight as JaxInFlight
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.mamba2_780m import SMOKE
from repro_torch.core import make_plan
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve_decode
from repro_torch.models import api
from repro_torch.serve import InFlight, Request, ServeEngine

#: port vs repro, fp32: relative and absolute
TOL = 1e-5
B, P, L = 2, 6, 12


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _setup(seed=0):
    jcfg = JAX_SMOKE.replace(dtype=jnp.float32)
    tcfg = SMOKE.replace(dtype=torch.float32)
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    params = bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")
    prompts = np.random.default_rng(seed).integers(0, tcfg.vocab_size, (B, P))
    return jcfg, tcfg, jparams, params, prompts


def _assert_cache_close(ours, want):
    for a, b in zip(ours["layers"], want["layers"]):
        assert sorted(a) == sorted(b) == ["ssm"]
        for k in ("state", "conv"):
            assert a["ssm"][k].dtype == b["ssm"][k].dtype and a["ssm"][k].shape == b["ssm"][k].shape
            np.testing.assert_allclose(a["ssm"][k].numpy(), b["ssm"][k].numpy(), rtol=TOL, atol=TOL)


def test_init_cache_matches_reference():
    jcfg, tcfg, *_ = _setup()
    want = bridge.cache_from_repro(_flat(jax_api.init_cache(jcfg, B, L)), tcfg, device="cpu")
    ours = api.init_cache(tcfg, B, L, device="cpu")
    _assert_cache_close(ours, want)
    assert ours["layers"][0]["ssm"]["state"].dtype == torch.float32
    assert ours["layers"][0]["ssm"]["conv"].shape[1] == tcfg.ssm_conv_width - 1


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_match_reference(seed):
    jcfg, tcfg, jparams, params, prompts = _setup(seed)
    jcache = jax_api.init_cache(jcfg, B, L)
    jl, jcache = jax_api.prefill_with_cache(jparams, jcfg, jcache, {"tokens": jnp.asarray(prompts, jnp.int32)})
    cache = api.init_cache(tcfg, B, L, device="cpu")
    tl, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.tensor(prompts)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    _assert_cache_close(cache, bridge.cache_from_repro(_flat(jcache), tcfg, device="cpu"))
    tok = torch.tensor(np.asarray(jl).argmax(-1))
    for i in range(P, P + 3):
        jl, jcache = jax_api.decode_fn(jparams, jcfg, jcache, i, {"tokens": jnp.asarray(tok.numpy(), jnp.int32)})
        tl, cache = api.decode_fn(params, tcfg, cache, i, {"tokens": tok})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        tok = torch.tensor(np.asarray(jl).argmax(-1))
    _assert_cache_close(cache, bridge.cache_from_repro(_flat(jcache), tcfg, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_prefill_is_bitwise_token_stepping(dtype):
    """The fused prefill leaves the logits and every state leaf exactly as
    stepping ``decode_fn`` over the prompt does, and the next decode step
    from both caches agrees bitwise."""
    tcfg = SMOKE.replace(dtype=dtype)
    params = api.cast_for_serving(api.init_params(tcfg, seed=3, device="cpu"), tcfg)
    prompts = torch.tensor(np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, P)))
    cache = api.init_cache(tcfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": prompts})
    ref = api.init_cache(tcfg, B, L, device="cpu")
    for i in range(P):
        ref_logits, ref = api.decode_fn(params, tcfg, ref, i, {"tokens": prompts[:, i : i + 1]})
    assert torch.equal(logits, ref_logits)
    for a, b in zip(cache["layers"], ref["layers"]):
        assert torch.equal(a["ssm"]["state"], b["ssm"]["state"]) and torch.equal(a["ssm"]["conv"], b["ssm"]["conv"])
    tok = logits[:, -1].argmax(-1, keepdim=True)
    nl, _ = api.decode_fn(params, tcfg, cache, P, {"tokens": tok})
    rl, _ = api.decode_fn(params, tcfg, ref, P, {"tokens": tok})
    assert torch.equal(nl, rl)


def test_cast_for_serving_leaves_ssm_serving_unchanged():
    """The Mamba2 matrices and conv bias cast once at load give the numbers
    the cast at every use gives, bitwise, in half the weight memory."""
    tcfg = SMOKE.replace(dtype=torch.bfloat16)
    params = api.init_params(tcfg, seed=2, device="cpu")
    cast = api.cast_for_serving(params, tcfg)
    assert cast["layers"][0]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert cast["layers"][0]["mamba"]["A_log"].dtype == torch.float32
    prompts = torch.tensor(np.random.default_rng(5).integers(0, tcfg.vocab_size, (B, P)))
    out = []
    for p in (params, cast):
        cache = api.init_cache(tcfg, B, L, device="cpu")
        logits, cache = api.prefill_with_cache(p, tcfg, cache, {"tokens": prompts})
        step, _ = api.decode_fn(p, tcfg, cache, P, {"tokens": logits[:, -1].argmax(-1, keepdim=True)})
        out.append((logits, step))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_serving_never_runs_the_chunked_ssd():
    """K2 (the chunked SSD) is not on the serving path: the prefill is the
    recurrence, which leaves the final state the decode loop needs."""
    tcfg = SMOKE.replace(dtype=torch.float32)
    params = api.init_params(tcfg, seed=0, device="cpu")
    cache = api.init_cache(tcfg, 1, 8, device="cpu")

    refuse = mock.Mock(side_effect=AssertionError("the chunked SSD ran on the serving path"))
    with mock.patch.object(ssd_ops, "ssd_chunked", refuse):
        logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.zeros((1, 5), dtype=torch.long)})
        api.decode_fn(params, tcfg, cache, 5, {"tokens": logits[:, -1].argmax(-1, keepdim=True)})
    assert not refuse.called


def test_engine_tokens_match_reference_engine():
    """The same request sequence through ``repro``'s ServeEngine and the
    port's (grid [4, 2], then [2, 4] after a switch): the same greedy tokens."""
    jcfg, tcfg, *_ = _setup()
    ref = JaxEngine(jcfg, num_stages=4, max_slots=8, max_len=24, init_key=0)
    params = bridge.params_from_repro(_flat(ref.params), tcfg, device="cpu")

    def repro_prompt(rid, n):
        return np.array(jax.random.randint(jax.random.PRNGKey(rid), (1, n), 0, jcfg.vocab_size, jnp.int32))

    ours = ServeEngine(tcfg, 4, 8, 24, params=params, device="cpu", prompt_fn=repro_prompt)
    ref.switch_to(jax_make_plan(4, 4, 1).lower())
    ours.switch_to(make_plan(4, 4, 1).lower())
    reqs = [(0, 7, 0), (1, 5, 3), (2, 9, 6)]  # (rid, prompt_len, slot)
    jinf = {rid: JaxInFlight(JaxRequest(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs}
    tinf = {rid: InFlight(Request(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs}
    ref.prefill([jinf[0], jinf[1]])
    ours.prefill([tinf[0], tinf[1]])
    for _ in range(2):
        ref.decode_tick([jinf[0], jinf[1]])
        ours.decode_tick([tinf[0], tinf[1]])
    ref.switch_to(jax_make_plan(4, 2, 1).lower())
    ours.switch_to(make_plan(4, 2, 1).lower())
    ref.prefill([jinf[2]])
    ours.prefill([tinf[2]])
    for _ in range(2):
        ref.decode_tick(list(jinf.values()))
        ours.decode_tick(list(tinf.values()))
    ref.runtime.cache.shutdown()
    assert ours.outputs == ref.outputs
    assert [len(ours.outputs[r]) for r in range(3)] == [5, 5, 3]
    assert not ours.nonfinite


def test_serve_decode_entry_point_serves_mamba2_on_cpu(tmp_path):
    import json

    out = tmp_path / "summary.json"
    rc = serve_decode.main([
        "--config", "mamba2-780m", "--tiny", "--device", "cpu", "--requests", "3",
        "--prompt-len", "4", "10", "--new-tokens", "2", "4", "--max-len", "32", "--out", str(out),
    ])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["config"] == "mamba2-smoke" and s["requests_completed"] >= 3 and not s["nonfinite_logits"]
    assert s["tokens"] == sum(len(t) for t in s["outputs"].values())
