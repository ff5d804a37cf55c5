"""The port's dense training path and pipeline engine against ``repro``.

Weights are ``repro``'s, carried across by the bridge; tokens, inputs and
cotangents are made with numpy from a seed and handed to both packages.
JAX runs on the CPU; everything is fp32 at a tiny size.

Tolerances:

* the engine against ``jax.value_and_grad`` of ``repro``'s unpipelined
  ``full_loss`` (and against ``repro``'s own engine): ``repro``'s engine
  tests' limits, loss relative 1e-5 and gradients absolute 5e-6;
* the attention, the decoder loss and the stage functions: 1e-4 relative
  to the largest entry of each tensor (the two frameworks sum products in
  different orders, ~1e-6 relative each, over a few layers);
* the optimizer step on identical gradients: 1e-5 (the same arithmetic in
  the same order).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.core.kinds import ScheduleSpec as JaxSpec
from repro.core.schedule import make_plan as jax_make_plan
from repro.models import attention as jax_attention
from repro.models import api as jax_api
from repro.models.common import ModelConfig as JaxConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jax_schedules
from repro.pipeline.engine import reference_pipeline_grads as jax_reference_pipeline_grads
from repro.pipeline.stage import StagedModel as JaxStaged
from repro.training import create_train_state as jax_create_train_state
from repro_torch import bridge
from repro_torch.core import ScheduleSpec, make_plan
from repro_torch.launch import train
from repro_torch.models import api, attention
from repro_torch.models.common import ModelConfig
from repro_torch.optim import adamw, make_optimizer, schedules
from repro_torch.pipeline import StagedModel, reduce_replicated, reference_pipeline_grads
from repro_torch.training import create_train_state, make_pipeline_train_step
from repro_torch.tree import flatten, tree_map
from test_torch_schedule import FAMILY_PARITY_CASES, SAVED_RESIDUAL_PARITY_CASES

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-4
#: the engine parity config of tests/test_pipeline_engine.py
TINY = dict(name="tiny", family="dense", num_layers=4, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64)
S, M, B, T = 2, 4, 2, 8


def _cfgs(**kw):
    return (
        JaxConfig(**{**TINY, **kw}, dtype=jnp.float32, param_dtype=jnp.float32),
        ModelConfig(**{**TINY, **kw}, dtype=torch.float32, param_dtype=torch.float32),
    )


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _jax_tree_like(tree, flat):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])


def _close(got, want, tol=TOL, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], (M, B, T)), rng.integers(0, TINY["vocab_size"], (M, B, T))


def _draw(init, seed, stacked=False):
    """Weights of ``init``'s tree structure drawn with numpy (``repro``'s
    eager initialisers take seconds): matrices normal over sqrt(fan-in), the
    embedding 0.02-normal, norm scales 1 + 0.1-normal, biases 0.1-normal.
    ``stacked``: leaves stacked over stages, with the replicated groups
    (``embed``, ``final_norm``) equal on every stage."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = _path_str(path)
        shape = leaf.shape[1:] if stacked and key.split("/")[0] in ("embed", "final_norm") else leaf.shape
        a = rng.standard_normal(shape).astype(np.float32)
        if key.endswith("scale"):
            a = 1.0 + 0.1 * a
        elif key.endswith("table"):
            a = 0.02 * a
        elif key.endswith("/w"):
            a = a / np.sqrt(shape[-2])
        else:
            a = 0.1 * a
        return jnp.asarray(np.broadcast_to(a, leaf.shape))

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, jax.random.PRNGKey(0)))


@functools.lru_cache
def _jax_staged(V, kw):
    jstaged = JaxStaged.build(_cfgs(**dict(kw))[0], V)
    return jstaged, _draw(jstaged.init_all_stages, V, stacked=True)


def _staged(V, **kw):
    """``repro``'s staged model and weights (made once: JAX arrays are
    immutable), and the port's on a fresh copy of the same weights."""
    jstaged, jparams = _jax_staged(V, tuple(sorted(kw.items())))
    staged = StagedModel.build(_cfgs(**kw)[1], V)
    return jstaged, jparams, staged, bridge.staged_params_from_repro(_flat(jparams), staged, device="cpu")


@pytest.fixture(scope="module")
def oracle():
    """``v -> (staged, params, loss, flat grads)``: ``jax.value_and_grad`` of
    ``repro``'s mean unpipelined ``full_loss`` over the micro-batches, jitted,
    computed once per virtual degree."""
    tokens, labels = (jnp.asarray(a, jnp.int32) for a in _data())
    cache = {}

    def get(v):
        if v not in cache:
            jstaged, jparams, staged, params = _staged(S * v)

            def mean_loss(p):
                return sum(jstaged.full_loss(p, tokens[m], labels[m]) for m in range(M)) / M

            loss, grads = jax.jit(jax.value_and_grad(mean_loss))(jparams)
            cache[v] = (staged, params, float(loss), _flat(grads))
        return cache[v]

    return get


def _engine(staged, params, plan):
    tokens, labels = (torch.from_numpy(a) for a in _data())
    loss, grads = reference_pipeline_grads(staged, params, tokens, labels, plan)
    return loss, bridge.staged_params_to_repro(grads, staged)


def _check_engine(got_loss, got_grads, want_loss, want_grads):
    assert float(got_loss) == pytest.approx(want_loss, rel=1e-5)
    assert sorted(got_grads) == sorted(want_grads)
    for key, want in want_grads.items():
        np.testing.assert_allclose(got_grads[key], want, atol=5e-6, err_msg=key)


# -- the engine --------------------------------------------------------------------


@pytest.mark.parametrize("kind,k,v,w", FAMILY_PARITY_CASES)
def test_engine_family_matches_oracle(oracle, kind, k, v, w):
    staged, params, want_loss, want_grads = oracle(v)
    plan = make_plan(S, M, spec=ScheduleSpec(kind=kind, k=k, num_virtual=v, extra_warmup=w))
    _check_engine(*_engine(staged, params, plan), want_loss, want_grads)


@pytest.mark.parametrize("kind,k,v,w,pol", SAVED_RESIDUAL_PARITY_CASES)
def test_engine_saved_residual_matches_oracle(oracle, kind, k, v, w, pol):
    staged, params, want_loss, want_grads = oracle(v)
    plan = make_plan(S, M, spec=ScheduleSpec(kind=kind, k=k, num_virtual=v, extra_warmup=w, zb_policy=pol))
    _check_engine(*_engine(staged, params, plan), want_loss, want_grads)


def test_engine_matches_reference_engine_kfkb_k2():
    """The port's engine against ``repro``'s own reference engine (eager)."""
    jstaged, jparams, staged, params = _staged(S)
    tokens, labels = (jnp.asarray(a, jnp.int32) for a in _data())
    jloss, jgrads = jax_reference_pipeline_grads(
        jstaged, jparams, tokens, labels, jax_make_plan(S, M, spec=JaxSpec(kind="kfkb", k=2))
    )
    plan = make_plan(S, M, spec=ScheduleSpec(kind="kfkb", k=2))
    _check_engine(*_engine(staged, params, plan), float(jloss), _flat(jgrads))


def test_engine_does_not_touch_the_parameters(oracle):
    staged, params, _, _ = oracle(1)
    before = {k: t.clone() for k, t in flatten(params).items()}
    _engine(staged, params, make_plan(S, M, spec=ScheduleSpec(kind="zb_h1", zb_policy="saved_residual")))
    for key, t in flatten(params).items():
        assert not t.requires_grad and torch.equal(t, before[key]), key


def test_engine_refuses_a_plan_of_other_virtual_stages(oracle):
    staged, params, _, _ = oracle(1)
    with pytest.raises(ValueError, match="virtual stages"):
        _engine(staged, params, make_plan(S, M, spec=ScheduleSpec(kind="interleaved", k=2, num_virtual=2)))


def test_reduce_replicated_sums_the_copies_in_place():
    rng = np.random.default_rng(3)
    grads = [
        {"embed": {"table": torch.from_numpy(rng.standard_normal((5, 3)))},
         "final_norm": {"scale": torch.from_numpy(rng.standard_normal(3))},
         "layers": [{"w": torch.from_numpy(rng.standard_normal((3, 3)))}]}
        for _ in range(3)
    ]
    want = tree_map(lambda *gs: sum(g.clone() for g in gs), *grads)
    layers = [g["layers"][0]["w"].clone() for g in grads]
    out = reduce_replicated(grads)
    assert out is grads
    for g, w in zip(grads, layers):
        torch.testing.assert_close(g["embed"]["table"], want["embed"]["table"], rtol=0, atol=1e-12)
        torch.testing.assert_close(g["final_norm"]["scale"], want["final_norm"]["scale"], rtol=0, atol=1e-12)
        assert torch.equal(g["layers"][0]["w"], w)
    assert torch.equal(grads[0]["embed"]["table"], grads[2]["embed"]["table"])


# -- attention, decoder and stages ----------------------------------------------------


ATTN_CASES = [(16, None), (16, 5), (2100, None)]


@pytest.mark.parametrize("T_,window", ATTN_CASES, ids=["sdpa", "sdpa_window", "chunked"])
def test_attn_train_matches_reference(T_, window):
    """Forward and gradients (params and input); from 2048 query tokens up
    both sides take their chunked path (2100 also pads the last chunk)."""
    jcfg, tcfg = _cfgs()
    jparams = jax_attention.attn_init(jax.random.PRNGKey(1), jcfg)
    tp = {k: {kk: torch.from_numpy(np.array(a)).requires_grad_(True) for kk, a in v.items()} for k, v in jparams.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, T_, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    @jax.jit
    def forward_and_grads(p, xx, c):
        y, vjp = jax.vjp(lambda p, xx: jax_attention.attn_train(p, xx, jcfg, window=window), p, xx)
        return y, vjp(c)

    jy, (jgp, jgx) = forward_and_grads(jparams, jnp.asarray(x), jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = attention.attn_train(tp, tx, tcfg, window=window)
    leaves = list(flatten(tp).values())
    grads = torch.autograd.grad(y, leaves + [tx], torch.from_numpy(ct))
    _close(y, jy, name="y")
    for (key, _), g in zip(flatten(tp).items(), grads):
        _close(g, _flat(jgp)[key], name=key)
    _close(grads[-1], jgx, name="x")


def test_chunked_attention_matches_reference_off_the_diagonal():
    """T < S with a window, at a chunk size that leaves a ragged last chunk."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 70, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 90, 2, 8)).astype(np.float32) for _ in range(2))
    want = jax_attention.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)), window=33, q_chunk=32)
    got = attention.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)), window=33, q_chunk=32)
    _close(got, want, name="out")
    assert attention.CHUNKED_ATTN_THRESHOLD == jax_attention.CHUNKED_ATTN_THRESHOLD == 2048


DECODER_CASES = [{}, dict(norm="layernorm", mlp_act="gelu", tie_embeddings=True, qkv_bias=True)]


@pytest.mark.parametrize("kw", DECODER_CASES, ids=["rmsnorm_swiglu_gqa", "gpt_style"])
def test_dense_decoder_loss_and_grads_match_reference(kw):
    jcfg, tcfg = _cfgs(**kw)
    jparams = _draw(lambda key: jax_api.init_params(key, jcfg), 2)
    params = bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")
    tokens, labels = _data(5)
    jb = {"tokens": jnp.asarray(tokens[0], jnp.int32), "labels": jnp.asarray(labels[0], jnp.int32)}
    tb = {"tokens": torch.from_numpy(tokens[0]), "labels": torch.from_numpy(labels[0])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(p, jcfg, jb), has_aux=True))(jparams)

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = api.loss_fn(leaves, tcfg, tb)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    grads = bridge.params_to_repro(tree_map(lambda _: next(grads), params), tcfg)
    _close(loss, jloss, 1e-5, "loss")
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    for key, g in grads.items():
        _close(torch.from_numpy(g), jflat[key], name=key)


@pytest.mark.parametrize("kw", [{}, dict(window_pattern=(3, None))], ids=["dense", "window_pattern"])
def test_staged_model_matches_reference(kw):
    """stage_hidden, embed_tokens, head_loss and full_loss on bridged weights
    (the window pattern makes a two-layer pattern, one repeat a stage)."""
    jstaged, jparams, staged, params = _staged(2, **kw)
    assert (staged.reps, len(staged.pattern)) == (jstaged.reps, len(jstaged.pattern))
    tokens, labels = _data(6)
    tok, lab = tokens[0], labels[0]
    jtok, jlab, ttok, tlab = jnp.asarray(tok), jnp.asarray(lab), torch.from_numpy(tok), torch.from_numpy(lab)
    p_of = lambda s: jax.tree_util.tree_map(lambda a: a[s], jparams)  # noqa: E731
    x = np.random.default_rng(7).standard_normal((B, T, TINY["d_model"])).astype(np.float32)
    stage_hidden, full_loss = jax.jit(jstaged.stage_hidden), jax.jit(jstaged.full_loss)
    with torch.no_grad():
        _close(staged.embed_tokens(params[0], ttok), jstaged.embed_tokens(p_of(0), jtok), name="embed")
        for s in range(2):
            _close(staged.stage_hidden(params[s], torch.from_numpy(x)),
                   stage_hidden(p_of(s), jnp.asarray(x)), name=f"stage {s}")
        _close(staged.head_loss(params[1], torch.from_numpy(x), tlab),
               jstaged.head_loss(p_of(1), jnp.asarray(x), jlab), name="head_loss")
        _close(staged.full_loss(params, ttok, tlab), full_loss(jparams, jtok, jlab), name="full_loss")


def test_staged_init_copies_the_replicated_groups():
    _, tcfg = _cfgs()
    staged = StagedModel.build(tcfg, 4)
    params = staged.init_all_stages(torch.Generator().manual_seed(0))
    assert len(params) == 4 and all(len(p["layers"]) == 1 for p in params)
    for p in params[1:]:
        assert torch.equal(p["embed"]["table"], params[0]["embed"]["table"])
        assert p["embed"]["table"].data_ptr() != params[0]["embed"]["table"].data_ptr()
        assert torch.equal(p["final_norm"]["scale"], params[0]["final_norm"]["scale"])
    assert not torch.equal(params[0]["layers"][0]["attn"]["wq"]["w"], params[1]["layers"][0]["attn"]["wq"]["w"])
    with pytest.raises(ValueError, match="layers 4 % stages 3"):
        StagedModel.build(tcfg, 3)


@pytest.mark.parametrize("V,kw", [(2, {}), (4, {}), (2, dict(window_pattern=(3, None)))], ids=["v1", "v2", "pattern"])
def test_staged_bridge_round_trip_is_bitwise(V, kw):
    _, jparams, staged, params = _staged(V, **kw)
    assert len(params) == V and len(params[0]["layers"]) == staged.layers_per_stage
    flat, back = _flat(jparams), bridge.staged_params_to_repro(params, staged)
    assert sorted(back) == sorted(flat)
    for key, a in flat.items():
        assert back[key].dtype == a.dtype and np.array_equal(back[key], a), key


# -- the optimizer step ------------------------------------------------------------------


def test_decay_mask_decays_every_leaf_of_the_pipeline_layout():
    _, _, _, params = _staged(2)
    mask = adamw.decay_mask(params)
    assert len(mask) == len(flatten(params)) and all(mask.values())
    assert params[0]["final_norm"]["scale"].ndim == 1 and params[0]["layers"][0]["ln1"]["scale"].ndim == 1
    single = adamw.decay_mask(params[0])  # one stage as a model tree: the single-model rule
    assert single["embed/table"] and not single["final_norm/scale"] and single["layers/0/ln1/scale"]


def test_pipeline_train_step_matches_reference_update():
    """One step of ``make_pipeline_train_step`` (engine, ``reduce_replicated``,
    clip and AdamW) against ``repro``'s optimizer applied to the same
    stacked gradients, summed over the stages as ``make_pipeline_step``
    sums them.  lr 1e-2 makes the decay of the stacked rank->=2 norm scales
    and biases visible."""
    jstaged, jparams, staged, params = _staged(S, norm="layernorm", qkv_bias=True)
    tokens, labels = (torch.from_numpy(a) for a in _data(8))
    plan = make_plan(S, M, spec=ScheduleSpec(kind="kfkb", k=2))
    loss, grads = reference_pipeline_grads(staged, params, tokens, labels, plan)
    jgrads = bridge.staged_params_to_repro(grads, staged)
    for key in jgrads:
        if key.split("/")[0] in ("embed", "final_norm"):
            jgrads[key] = np.broadcast_to(jgrads[key].sum(axis=0), jgrads[key].shape)
    jopt = jax_make_optimizer("adamw", jax_schedules.constant_schedule(1e-2))
    jstate = jax_create_train_state(jparams, jopt)
    jnew, jopt_state, jm = jax.jit(jopt.update)(jstate.params, _jax_tree_like(jparams, jgrads), jstate.opt_state)

    opt = make_optimizer("adamw", schedules.constant_schedule(1e-2))
    state = create_train_state(params, opt)
    state, m = make_pipeline_train_step(staged, plan, opt)(state, tokens, labels)
    assert state.step == 1 and float(m["loss"]) == float(loss)
    _close(m["grad_norm"], jm["grad_norm"], 1e-5, "grad_norm")
    for got_tree, want_tree in ((state.params, jnew), (state.opt_state.m, jopt_state.m), (state.opt_state.v, jopt_state.v)):
        got, want = bridge.staged_params_to_repro(got_tree, staged), _flat(want_tree)
        for key in want:
            _close(torch.from_numpy(got[key]), want[key], 1e-5, key)
    for p in state.params[1:]:  # the tied copies stay equal
        assert torch.equal(p["embed"]["table"], state.params[0]["embed"]["table"])
        assert torch.equal(p["final_norm"]["scale"], state.params[0]["final_norm"]["scale"])


#: a small config of the GPT family (configs/gpt.py: LayerNorm, GELU MLP, tied
#: embeddings, as many key/value heads as query heads)
GPT_SMALL = dict(num_kv_heads=4, norm="layernorm", mlp_act="gelu", tie_embeddings=True)


def test_pipeline_train_steps_at_lr_3e4_match_reference():
    """Six steps of ``make_pipeline_train_step`` (S = 2, kfkb k = 2) at lr
    3e-4, the rate at which the on-card pipeline loss rose over 6 steps,
    against ``repro``: its reference engine (jitted), the replicated
    copies' gradients summed with numpy as ``make_pipeline_step`` sums
    them (``repro``'s multi-device engine cannot run in one CPU process),
    then its optimizer (clip at 1 and AdamW).  Loss and every parameter
    after every step within 1e-5 relative to each tensor's largest entry:
    the one-step limit above, as AdamW's normalised updates keep a
    gradient difference of ~1e-6 relative from growing over six steps."""
    jstaged, jparams, staged, params = _staged(S, **GPT_SMALL)
    plan = make_plan(S, M, spec=ScheduleSpec(kind="kfkb", k=2))
    jplan = jax_make_plan(S, M, spec=JaxSpec(kind="kfkb", k=2))
    jopt = jax_make_optimizer("adamw", jax_schedules.constant_schedule(3e-4))
    jstate = jax_create_train_state(jparams, jopt)
    grads_fn = jax.jit(lambda p, t, l: jax_reference_pipeline_grads(jstaged, p, t, l, jplan))
    update = jax.jit(jopt.update)
    opt = make_optimizer("adamw", schedules.constant_schedule(3e-4))
    state = create_train_state(params, opt)
    step = make_pipeline_train_step(staged, plan, opt)
    jp, jo, losses = jstate.params, jstate.opt_state, []
    for i in range(6):
        tokens, labels = _data(20 + i)
        jloss, jgrads = grads_fn(jp, jnp.asarray(tokens, jnp.int32), jnp.asarray(labels, jnp.int32))
        flat = _flat(jgrads)
        for key in flat:
            if key.split("/")[0] in ("embed", "final_norm"):
                flat[key] = np.broadcast_to(flat[key].sum(axis=0), flat[key].shape)
        jp, jo, _ = update(jp, _jax_tree_like(jp, flat), jo)
        state, m = step(state, torch.from_numpy(tokens), torch.from_numpy(labels))
        _close(m["loss"], jloss, 1e-5, f"loss, step {i}")
        got, want = bridge.staged_params_to_repro(state.params, staged), _flat(jp)
        for key in want:
            _close(torch.from_numpy(got[key]), want[key], 1e-5, f"step {i}: {key}")
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()


# -- the launcher ------------------------------------------------------------------------


def test_run_pipeline_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    _, tcfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run_pipeline(tcfg, 2, ScheduleSpec(), steps=1, batch=4, seq=8, microbatches=4, lr=1e-3, warmup=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "pipeline", "--steps", "1"])


def test_pipeline_launcher_on_cpu_reduces_the_loss(tmp_path):
    out = tmp_path / "pipeline.json"
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train", "--mode", "pipeline", "--gpt", "GPT-Medium",
        "--layers", "2", "--stages", "2", "--k", "2", "--steps", "10", "--batch", "16", "--seq", "64",
        "--microbatches", "4", "--lr", "3e-4", "--warmup", "2", "--log-every", "5", "--device", "cpu",
        "--out", str(out),
    ]
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = json.loads(out.read_text())
    assert (s["config"], s["num_layers"], s["d_model"], s["vocab_size"]) == ("GPT-Medium", 2, 1024, 1024)
    assert (s["stages"], s["microbatches"], s["micro_batch_size"], s["plan"]) == (2, 4, 4, "2F2B(b=4)")
    assert s["device"] == "cpu" and s["flash_launches"] == 0
    assert len(s["losses"]) == 10 and np.isfinite(s["losses"] + s["grad_norms"]).all()
    assert s["losses"][-1] < s["losses"][0]
