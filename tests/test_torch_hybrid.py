"""The port's hybrid and MoE architectures against ``repro`` on the CPU.

jamba-v0.1-52b (Mamba2 and attention interleaved, MoE every other layer),
kimi-k2-1t-a32b (a dense prefix layer, sigmoid top-2 with a shared expert)
and llama4-maverick-400b-a17b (top-1 with a shared expert on alternate
layers), each on its smoke config in fp32 with ``repro``'s weights through
the bridge, at ``test_torch_archs.py``'s 1e-4: the forward logits and the
aux terms, ``decoder_loss`` and its gradients, one train step with the
arch's optimizer (Adafactor for kimi and llama4, in the reference's
stacked layout; AdamW for jamba), and ``prefill_with_cache`` plus 4 decode
steps, logits and every cache leaf (jamba's prefill at 16 tokens).

The jamba prefill finding: ``repro``'s fused prefill and its token
stepping part at the config's capacity factor 1.25 because the prefill
routes B * P tokens per MoE layer and each step B, so the capacity, and
so the drops, differ; at capacity factor 100 no token is dropped and the
two agree.  The port shows the same on its own weights.

The serve engine on an MoE smoke config: each row of a decode group routed
as its own group, so its tokens equal ``repro``'s engine's, whose per-slot
``vmap`` routes one token a dispatch.  ``StagedModel`` on a 4-layer jamba
variant at S = 2: the reference pipeline engine's loss and gradients
against ``repro``'s.  The bridge round-trips kimi's prefix and jamba's
mixed caches bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import make_plan as jax_make_plan
from repro.core.kinds import ScheduleSpec as JaxSpec
from repro.models import api as jax_api
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jax_schedules
from repro.pipeline.engine import reference_pipeline_grads as jax_reference_pipeline_grads
from repro.pipeline.stage import StagedModel as JaxStaged
from repro.serve import InFlight as JaxInFlight
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro.training import create_train_state as jax_create_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer, schedules
from repro_torch.pipeline import StagedModel, reference_pipeline_grads
from repro_torch.serve import InFlight, Request, ServeEngine
from repro_torch.training import create_train_state, make_train_step
from repro_torch.tree import flatten, tree_map
from test_torch_archs import _batch, _bridged, _cfgs, _close, _flat, _np, _recording

ARCHS = ["jamba-v0.1-52b", "kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]


def _compare_cache(cache, jcache, cfg):
    want = bridge.cache_from_repro(_flat(jcache), cfg)
    for i, (got_l, want_l) in enumerate(zip(cache["layers"], want["layers"])):
        assert sorted(got_l) == sorted(want_l), i
        for key, t in flatten(want_l).items():
            got = flatten(got_l)[key]
            assert got.shape == t.shape, (i, key)
            _close(got, _np(t), name=f"layer {i} {key}")


def test_structures_equal_reference():
    """The port's prefix and repeating block are ``repro``'s, MoE included."""
    from repro.models.transformer import structure as jax_structure

    for arch in ARCHS:
        for cfg, jcfg in ((get_arch(arch).model, jax_get_arch(arch).model), _cfgs(arch)[::-1]):
            st, jst = tf.structure(cfg), jax_structure(jcfg)
            assert [dataclasses.astuple(s) for s in st.prefix] == [dataclasses.astuple(s) for s in jst.prefix]
            assert [dataclasses.astuple(s) for s in st.pattern] == [dataclasses.astuple(s) for s in jst.pattern]
            assert st.n_blocks == jst.n_blocks
    jamba = tf.structure(get_arch("jamba-v0.1-52b").model)
    assert len(jamba.pattern) == 8 and jamba.n_blocks == 4
    assert [s.kind for s in jamba.pattern].count("attn") == 1 and jamba.pattern[4].kind == "attn"
    assert [s.moe for s in jamba.pattern] == [i % 2 == 1 for i in range(8)]


def test_serving_cast_keeps_the_router_in_fp32():
    """The expert banks go to ``cfg.dtype`` (``repro`` casts them at use);
    the router's weight stays in ``param_dtype``, as ``repro`` reads it in
    fp32 on every call, and a bf16 copy would move tokens across top-k."""
    cfg = get_arch("kimi-k2-1t-a32b").smoke
    flat = flatten(api.init_serving_params(cfg, seed=0, device="cpu"))
    assert flat["layers/1/moe/router/w"].dtype == torch.float32
    for bank in ("gate", "up", "down"):
        assert flat[f"layers/1/moe/experts/{bank}"].dtype == torch.bfloat16
    assert flat["layers/1/moe/shared/gate/w"].dtype == torch.bfloat16
    assert flat["layers/0/mlp/gate/w"].dtype == torch.bfloat16 and flat["layers/1/ln2/scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=1)
    jb, tb = _batch(tcfg, B=2, T=16, seed=1)
    jlogits, jaux = jax.jit(lambda p: jax_api.forward_fn(p, jcfg, jb))(jparams)
    logits, aux = tf.decoder_forward(params, tcfg, tb["tokens"])
    _close(logits, jlogits, name="logits")
    for key in ("moe_load_balance", "moe_router_z"):
        _close(aux[key], jaux[key], name=key)
        assert float(aux[key]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=2)
    jb, tb = _batch(tcfg, B=2, T=16, seed=2)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, m = api.loss_fn(leaves, tcfg, tb)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    grads = bridge.params_to_repro(tree_map(lambda _: next(grads), params), tcfg)
    _close(loss, jloss, name="loss")
    for key in ("ce_loss", "moe_load_balance", "moe_router_z"):
        _close(m[key], jm[key], name=key)
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    for key, g in grads.items():
        _close(torch.from_numpy(g), jflat[key], name=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of the arch's optimizer over M = 2 micro-batches: the loss,
    the clip norm, the learning rate and the gradients handed to the
    optimizer; under Adafactor also the updated parameters and the
    statistics (taken over the reference's stacked leaves, kimi's prefix
    layer on its own).  AdamW's first step is about lr * sign(g), so a
    gradient element within rounding of 0 may take either sign in the two
    frameworks; its inputs are held, as for the dense archs."""
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=4)
    spec = get_arch(arch)
    assert spec.optimizer == ("adamw" if arch.startswith("jamba") else "adafactor")
    jseen, seen = [], []
    jopt = _recording(jax_make_optimizer(spec.optimizer, jax_schedules.linear_warmup_cosine(1e-3, 0, 4)), jseen)
    opt = _recording(
        make_optimizer(spec.optimizer, schedules.linear_warmup_cosine(1e-3, 0, 4),
                       layout=tf.reference_layout(tcfg, params)),
        seen,
    )
    jstep = jax_make_train_step(lambda p, b: jax_api.loss_fn(p, jcfg, b), jopt, num_microbatches=2)
    step = make_train_step(lambda p, b: api.loss_fn(p, tcfg, b), opt, num_microbatches=2)
    jb, tb = _batch(tcfg, seed=6)
    jstate, jm = jstep(jax_create_train_state(jparams, jopt), jb)
    state, m = step(create_train_state(params, opt), tb)
    _close(m["loss"], jm["loss"], name="loss")
    _close(m["grad_norm"], jm["grad_norm"], name="grad_norm")
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    held = [(seen[0], _flat(jseen[0]), "grad")]
    if spec.optimizer == "adafactor":
        held.append((state.params, _flat(jstate.params), "param"))
    for got, want, what in held:
        got = bridge.params_to_repro(got, tcfg)
        assert sorted(got) == sorted(want)
        for key in want:
            _close(torch.from_numpy(got[key]), want[key], name=f"{what} {key}")
    if spec.optimizer == "adafactor":
        for ours, theirs in ((state.opt_state.v_row, jstate.opt_state.v_row), (state.opt_state.v_col, jstate.opt_state.v_col)):
            want = _flat(theirs)
            assert sorted(ours) == sorted(want)
            for key in want:
                _close(ours[key], want[key], name=key)
    assert state.step == int(jstate.step) == 1


PREFILL_CASES = [("jamba-v0.1-52b", 16, 24), ("kimi-k2-1t-a32b", 12, 20), ("llama4-maverick-400b-a17b", 12, 20)]


@pytest.mark.parametrize("arch,T,L", PREFILL_CASES, ids=[a for a, _, _ in PREFILL_CASES])
def test_prefill_and_decode_match_reference(arch, T, L):
    """``prefill_with_cache`` and 4 decode steps against ``repro``'s (its
    fused prefill, not its stepping): the logits and every cache leaf, KV
    and SSM state alike."""
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=3)
    B = 2
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jcache = jax_api.init_cache(jcfg, B, L)
    jlogits, jcache = jax_api.prefill_with_cache(jparams, jcfg, jcache, {"tokens": jnp.asarray(prompt)})
    cache = api.init_cache(tcfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.from_numpy(prompt).long()})
    _close(logits, jlogits, name="prefill logits")
    _compare_cache(cache, jcache, tcfg)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(_np(logits[:, -1]).argmax(-1), tok[:, 0])
        jlogits, jcache = jax_api.decode_fn(jparams, jcfg, jcache, T + i, {"tokens": jnp.asarray(tok)})
        logits, cache = api.decode_fn(params, tcfg, cache, T + i, {"tokens": torch.from_numpy(tok).long()})
        _close(logits, jlogits, name=f"decode {i} logits")
    _compare_cache(cache, jcache, tcfg)


@pytest.mark.parametrize("capacity_factor", [100.0, 1.25])
def test_jamba_prefill_equals_stepping_only_without_drops(capacity_factor):
    """``repro``'s ``test_prefill_with_cache_matches_token_stepping`` on the
    port (jamba-smoke in bf16 on ``repro``'s seed-0 weights, its prompts,
    B 2, P 6): at capacity factor 100 no token is dropped, and the fused
    prefill leaves the logits and the cache of token stepping, bitwise; at
    the config's 1.25 the prefill routes 12 tokens a layer against
    stepping's 2, drops where stepping does not, and the last logits part
    by ~0.1 (``repro`` itself: 0.105), far more than a rounding."""
    jcfg = jax_get_arch("jamba-v0.1-52b").smoke
    cfg = get_arch("jamba-v0.1-52b").smoke.replace(capacity_factor=capacity_factor)
    B, P, L = 2, 6, 10
    params = bridge.params_from_repro(_flat(jax_api.init_params(jax.random.PRNGKey(0), jcfg)), cfg, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)))
    cache = api.init_cache(cfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, cfg, cache, {"tokens": prompts})
    ref = api.init_cache(cfg, B, L, device="cpu")
    for i in range(P):
        ref_logits, ref = api.decode_fn(params, cfg, ref, i, {"tokens": prompts[:, i : i + 1]})
    gap = float((logits.float() - ref_logits.float()).abs().max())
    if capacity_factor == 100.0:
        assert gap == 0.0 and torch.equal(logits, ref_logits)
        for a, b in zip(flatten(cache).values(), flatten(ref).values()):
            assert torch.equal(a, b)
    else:
        assert gap > 5e-2, gap


SERVE_CASES = [("llama4-maverick-400b-a17b", {}), ("jamba-v0.1-52b", {"num_experts": 16})]


@pytest.mark.parametrize("arch,kw", SERVE_CASES, ids=["llama4-top1", "jamba-16-experts"])
def test_engine_tokens_match_reference_engine(arch, kw):
    """4 requests in 4 slots of a [2, 2] grid through ``repro``'s
    ServeEngine and the port's: the same greedy tokens.  llama4-smoke's
    top-1 over 4 experts and jamba-smoke with its full config's 16 experts
    both have a capacity of 1 for a 2-token group, so routing a group's two
    rows as one dispatch would drop one wherever they pick one expert."""
    jcfg, tcfg = _cfgs(arch, **kw)
    ref = JaxEngine(jcfg, num_stages=2, max_slots=4, max_len=20, init_key=0)
    params = bridge.params_from_repro(_flat(ref.params), tcfg, device="cpu")

    def repro_prompt(rid, n):
        return np.array(jax.random.randint(jax.random.PRNGKey(rid), (1, n), 0, jcfg.vocab_size, jnp.int32))

    ours = ServeEngine(tcfg, 2, 4, 20, params=params, device="cpu", prompt_fn=repro_prompt)
    ref.switch_to(jax_make_plan(2, 2, 1).lower())
    ours.switch_to(make_plan(2, 2, 1).lower())
    reqs = [(0, 7, 0), (1, 5, 1), (2, 9, 2), (3, 4, 3)]  # (rid, prompt_len, slot)
    jinf = [JaxInFlight(JaxRequest(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs]
    tinf = [InFlight(Request(rid, 0.0, n, 8), s, 0.0) for rid, n, s in reqs]
    ref.prefill(jinf)
    ours.prefill(tinf)
    for _ in range(5):
        ref.decode_tick(jinf)
        ours.decode_tick(tinf)
    ref.runtime.cache.shutdown()
    assert ours.outputs == ref.outputs
    assert [len(ours.outputs[r]) for r in range(4)] == [6] * 4
    assert not ours.nonfinite


def test_staged_jamba_matches_reference_engine():
    """A 4-layer jamba-smoke variant (attention every 2nd layer, MoE on odd
    layers; two layers a stage) in S = 2 stages, kfkb k = 1 over M = 2
    micro-batches: the port's reference engine against ``repro``'s, loss
    and every gradient (the stage body drops the aux terms in both)."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", num_layers=4, attn_every=2)
    S_, M_, B_, T_ = 2, 2, 1, 16
    jstaged, staged = JaxStaged.build(jcfg, S_), StagedModel.build(tcfg, S_)
    assert len(staged.pattern) == 2 and staged.reps == 1
    jparams = jstaged.init_all_stages(jax.random.PRNGKey(5))
    params = bridge.staged_params_from_repro(_flat(jparams), staged, device="cpu")
    rng = np.random.default_rng(5)
    tokens, labels = (rng.integers(0, tcfg.vocab_size, (M_, B_, T_)) for _ in range(2))
    jloss, jgrads = jax_reference_pipeline_grads(
        jstaged, jparams, jnp.asarray(tokens, jnp.int32), jnp.asarray(labels, jnp.int32),
        jax_make_plan(S_, M_, spec=JaxSpec(kind="kfkb", k=1)),
    )
    loss, grads = reference_pipeline_grads(
        staged, params, torch.from_numpy(tokens), torch.from_numpy(labels),
        make_plan(S_, M_, spec=ScheduleSpec(kind="kfkb", k=1)),
    )
    _close(loss, jloss, name="loss")
    got, want = bridge.staged_params_to_repro(grads, staged), _flat(jgrads)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(torch.from_numpy(got[key]), want[key], name=key)


def test_staged_model_refuses_a_prefix_as_reference_does():
    with pytest.raises(ValueError, match="irregular prefix layers"):
        StagedModel.build(get_arch("kimi-k2-1t-a32b").smoke, 1)
    with pytest.raises(ValueError, match="irregular prefix layers"):
        JaxStaged.build(jax_get_arch("kimi-k2-1t-a32b").smoke, 1)


def test_bridge_round_trips_prefix_and_mixed_caches_bitwise():
    """kimi's prefix layer and jamba's period-2 block: parameters to the
    port and back equal ``repro``'s leaves bitwise; jamba's mixed KV and SSM
    caches (batch and slot-major) land in their layers' rows bitwise."""
    for arch in ("kimi-k2-1t-a32b", "jamba-v0.1-52b"):
        jcfg, tcfg = _cfgs(arch)
        jparams, params = _bridged(jcfg, tcfg, seed=6)
        want = _flat(jparams)
        back = bridge.params_to_repro(params, tcfg)
        assert sorted(back) == sorted(want)
        for key in want:
            assert back[key].dtype == want[key].dtype and np.array_equal(back[key], want[key]), key
    assert any(k.startswith("prefix/0/") for k in _flat(_bridged(*_cfgs("kimi-k2-1t-a32b"))[0]))
    jcfg, tcfg = _cfgs("jamba-v0.1-52b")
    rng = np.random.default_rng(8)
    jcache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype)), jax_api.init_cache(jcfg, 3, 8)
    )
    flat = _flat(jcache)
    cache = bridge.cache_from_repro(flat, tcfg)
    kinds = [sorted(layer) for layer in cache["layers"]]
    assert kinds == [["ssm"], ["kv"]]
    for key, arr in flat.items():
        group, j, *rest = key.split("/")
        got = flatten(cache["layers"][int(j)])["/".join(rest)]
        assert np.array_equal(got.numpy(), arr[0]), key
    slots = {k: np.stack([v] * 2) for k, v in _flat(jax_api.init_cache(jcfg, 1, 8)).items()}
    slots = {k: rng.standard_normal(v.shape).astype(v.dtype) for k, v in slots.items()}
    cache = bridge.cache_from_repro(slots, tcfg, slot_major=True)
    for key, arr in slots.items():
        group, j, *rest = key.split("/")
        got = flatten(cache["layers"][int(j)])["/".join(rest)]
        assert np.array_equal(got.numpy(), arr[:, 0, 0]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_and_train_the_smoke_configs(arch, tmp_path):
    """``serve_decode --config <id> --tiny`` and ``train --arch <id> --smoke``
    on the CPU: every request served with finite logits; the loss falls
    under the arch's optimizer, and a step of one micro-batch reports the
    MoE terms."""
    import json

    from repro_torch.launch import serve_decode, train

    out = tmp_path / "serve.json"
    rc = serve_decode.main([
        "--config", arch, "--tiny", "--device", "cpu", "--requests", "3", "--prompt-len", "4", "10",
        "--new-tokens", "2", "4", "--max-len", "24", "--out", str(out),
    ])
    s = json.loads(out.read_text())
    assert rc == 0 and s["requests_completed"] >= 3 and not s["nonfinite_logits"]
    out = tmp_path / "train.json"
    rc = train.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--steps", "10", "--seq", "32", "--batch", "8",
        "--lr", "3e-3", "--warmup", "2", "--log-every", "5", "--out", str(out),
    ])
    s = json.loads(out.read_text())
    assert rc == 0 and s["optimizer"] == get_arch(arch).optimizer
    assert len(s["moe_load_balance"]) == len(s["moe_router_z"]) == 10
    assert all(np.isfinite(s["moe_load_balance"])) and s["losses"][-1] < s["losses"][0]
