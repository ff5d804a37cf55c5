"""The port's SSM training path against ``repro`` on mamba2-smoke in fp32.

Weights are ``repro``'s, carried across by the bridge; inputs, gradients
and cotangents are made with numpy from a seed and handed to both packages.
JAX runs on the CPU.  Tolerances: forward values and gradients agree to
1e-4 relative to the largest entry of each tensor (the two frameworks sum
products and reductions in different orders, ~1e-6 relative each, over two
layers and a tied unembedding); optimizer and schedule arithmetic, which
both sides do in the same order on identical inputs, to 1e-5.
"""

import dataclasses
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
from repro.configs.mamba2_780m import FULL as JAX_FULL
from repro.configs.mamba2_780m import SMOKE as JAX_SMOKE
from repro.data import SyntheticTextDataset as JaxDataset
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import mamba as jax_mamba
from repro.models.common import param_count as jax_param_count
from repro.optim import adamw as jax_adamw
from repro.optim import clipping as jax_clipping
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jax_schedules
from repro.training import create_train_state as jax_create_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs.mamba2_780m import FULL, SMOKE
from repro_torch.data import SyntheticTextDataset
from repro_torch.models import api, layers, mamba
from repro_torch.models.common import param_count
from repro_torch.optim import adamw, clipping, make_optimizer, schedules
from repro_torch.training import create_train_state, make_eval_step, make_train_step
from repro_torch.tree import flatten, tree_map

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL = 1e-4


def _cfgs():
    return JAX_SMOKE.replace(dtype=jnp.float32), SMOKE.replace(dtype=torch.float32)


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _jax_tree_like(tree, flat):
    """``tree``'s structure with the leaves of ``flat`` (keyed by path)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[_path_str(p)]) for p, _ in leaves])


def _params(seed=0):
    jcfg, tcfg = _cfgs()
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")


def _close(got, want, tol=TOL, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _batch(cfg, B=4, T=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T))
    labels = rng.integers(0, cfg.vocab_size, (B, T))
    return (
        {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)},
        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
    )


# -- the layer and the loss --------------------------------------------------------


def test_mamba_train_forward_and_grads_match_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _params()
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"][0]["mamba"])  # layer 1
    tp = {k: v.clone().requires_grad_(True) for k, v in params["layers"][1]["mamba"].items()}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    jy, vjp = jax.vjp(lambda p, xx: jax_mamba.mamba_train(p, xx, jcfg), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = mamba.mamba_train(tp, tx, tcfg)
    grads = torch.autograd.grad(y, [*tp.values(), tx], torch.from_numpy(ct))
    _close(y, jy, name="y")
    for (name, _), g in zip(tp.items(), grads):
        _close(g, jgp[name], name=name)
    _close(grads[-1], jgx, name="x")


def test_decoder_loss_and_grads_match_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _params(seed=2)
    jb, tb = _batch(tcfg)
    (jloss, jm), jg = jax.value_and_grad(lambda p: jax_api.loss_fn(p, jcfg, jb), has_aux=True)(jparams)

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, m = api.loss_fn(leaves, tcfg, tb)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    grads = bridge.params_to_repro(tree_map(lambda _: next(grads), params), tcfg)

    assert sorted(m) == sorted(jm) == ["ce_loss", "moe_load_balance", "moe_router_z"]
    _close(loss, jloss, 1e-5, "loss")
    _close(m["ce_loss"], jm["ce_loss"], 1e-5, "ce_loss")
    assert float(m["moe_load_balance"]) == float(m["moe_router_z"]) == 0.0
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    for key, g in grads.items():
        _close(g, jflat[key], name=key)


CE_CASES = [("plain", False, 0.0), ("mask", True, 0.0), ("z_loss", False, 1e-4), ("mask_z_loss", True, 1e-3)]


@pytest.mark.parametrize("name,masked,z_loss", CE_CASES, ids=[c[0] for c in CE_CASES])
def test_cross_entropy_loss_matches_reference(name, masked, z_loss):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5))
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32) if masked else None

    def jloss(lg):
        return jax_layers.cross_entropy_loss(
            lg, jnp.asarray(labels), mask=None if mask is None else jnp.asarray(mask), z_loss=z_loss
        )

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = layers.cross_entropy_loss(
        tl, torch.from_numpy(labels), mask=None if mask is None else torch.from_numpy(mask), z_loss=z_loss
    )
    (grad,) = torch.autograd.grad(got, tl)
    _close(got, want, 1e-6, "loss")
    _close(grad, jgrad, 1e-5, "grad")


def test_param_count_of_ssm_configs_matches_reference():
    assert param_count(FULL) == jax_param_count(JAX_FULL) == 780_062_976
    assert param_count(SMOKE) == jax_param_count(JAX_SMOKE)


# -- optimizer, schedules, data -----------------------------------------------------


def test_decay_mask_follows_the_reference_stacked_layout():
    _, params = _params()
    mask = adamw.decay_mask(params)
    assert mask["embed/table"] and not mask["final_norm/scale"]
    for i, layer in enumerate(params["layers"]):
        layer = flatten(layer)
        for leaf in ("ln1/scale", "mamba/A_log", "mamba/D", "mamba/dt_bias", "mamba/conv_b", "mamba/norm_scale"):
            assert layer[leaf].ndim == 1 and mask[f"layers/{i}/{leaf}"], leaf


def test_adamw_update_matches_reference():
    """Two updates at lr 1e-2 on bridged params: the port's 1-D per-layer
    leaves are decayed as the reference's stacked 2-D ones are."""
    _, tcfg = _cfgs()
    jparams, params = _params()
    rng = np.random.default_rng(5)
    gflats = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in _flat(jparams).items()} for _ in range(2)]
    jstate, state = jax_adamw.adamw_init(jparams), adamw.adamw_init(params)
    for g in gflats:
        jparams, jstate = jax_adamw.adamw_update(jparams, _jax_tree_like(jparams, g), jstate, 1e-2)
        params, state = adamw.adamw_update(params, bridge.params_from_repro(g, tcfg), state, 1e-2)
    assert state.step == int(jstate.step) == 2
    for got_tree, want_tree in ((params, jparams), (state.m, jstate.m), (state.v, jstate.v)):
        got, want = bridge.params_to_repro(got_tree, tcfg), _flat(want_tree)
        for key in want:
            _close(torch.from_numpy(got[key]), want[key], 1e-5, key)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((3, 4)), "b": [rng.standard_normal(5), rng.standard_normal((2, 2))]}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    jclipped, jnorm = jax_clipping.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    clipped, norm = clipping.clip_by_global_norm(tree_map(torch.from_numpy, tree), max_norm)
    _close(norm, jnorm, 1e-6, "norm")
    _close(clipping.global_norm(tree_map(torch.from_numpy, tree)), jax_clipping.global_norm(tree), 1e-6)
    for key, want in _flat(jclipped).items():
        _close(flatten(clipped)[key], want, 1e-6, key)


SCHEDULES = [
    ("constant", lambda m: m.constant_schedule(3e-4)),
    ("cosine", lambda m: m.cosine_schedule(1e-3, 10, final_frac=0.2)),
    ("warmup_cosine", lambda m: m.linear_warmup_cosine(1e-3, 3, 10)),
    ("warmup_cosine_short", lambda m: m.linear_warmup_cosine(3e-4, 2, 6)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_reference(name, make):
    ours, theirs = make(schedules), make(jax_schedules)
    for step in range(13):
        assert ours(step) == pytest.approx(float(theirs(jnp.asarray(step, jnp.int32))), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_tokens_match_reference(seed):
    ours = SyntheticTextDataset(1024, 24, 4, seed=seed)
    theirs = JaxDataset(1024, 24, 4, seed=seed)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step, "cpu"), theirs.batch_at(step)
        assert a.tokens.dtype == torch.int64 and a.tokens.device.type == "cpu"
        np.testing.assert_array_equal(a.tokens.numpy(), np.asarray(b.tokens))
        np.testing.assert_array_equal(a.labels.numpy(), np.asarray(b.labels))


# -- the train step ------------------------------------------------------------------


def _recording(opt, seen: list):
    """``opt`` with an update that records the gradients it is handed."""
    def update(params, grads, state):
        seen.append(grads)
        return opt.update(params, grads, state)

    return dataclasses.replace(opt, update=update)


def test_train_steps_match_reference():
    """Three steps with M = 2 micro-batches: per-step losses to 1e-4, and the
    averaged gradients each step hands the optimizer (compared, not the
    parameters after Adam, whose normalisation turns rounding noise in
    near-zero gradients into whole steps of ``lr``)."""
    jcfg, tcfg = _cfgs()
    jparams, params = _params(seed=3)
    jseen, seen = [], []
    jopt = _recording(jax_make_optimizer("adamw", jax_schedules.linear_warmup_cosine(1e-3, 1, 3)), jseen)
    opt = _recording(make_optimizer("adamw", schedules.linear_warmup_cosine(1e-3, 1, 3)), seen)
    jstate = jax_create_train_state(jparams, jopt)
    state = create_train_state(params, opt)
    jstep = jax_make_train_step(lambda p, b: jax_api.loss_fn(p, jcfg, b), jopt, num_microbatches=2)
    step = make_train_step(lambda p, b: api.loss_fn(p, tcfg, b), opt, num_microbatches=2)
    jds, ds = JaxDataset(tcfg.vocab_size, 16, 4, seed=1), SyntheticTextDataset(tcfg.vocab_size, 16, 4, seed=1)
    for i in range(3):
        jb, tb = jds.batch_at(i), ds.batch_at(i, "cpu")
        jstate, jm = jstep(jstate, {"tokens": jb.tokens, "labels": jb.labels})
        state, m = step(state, {"tokens": tb.tokens, "labels": tb.labels})
        _close(m["loss"], jm["loss"], name=f"loss {i}")
        _close(m["grad_norm"], jm["grad_norm"], name=f"grad_norm {i}")
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        got, want = bridge.params_to_repro(seen[i], tcfg), _flat(jseen[i])
        for key in want:
            _close(torch.from_numpy(got[key]), want[key], name=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3


def test_eval_step_is_the_loss_without_gradients():
    _, tcfg = _cfgs()
    _, params = _params()
    _, tb = _batch(tcfg)
    out = make_eval_step(lambda p, b: api.loss_fn(p, tcfg, b))(params, tb)
    loss, _ = api.loss_fn(params, tcfg, tb)
    assert not out["loss"].requires_grad
    assert float(out["loss"]) == float(loss) and float(out["ce_loss"]) == float(loss)


def test_train_launcher_on_cpu_reduces_the_loss(tmp_path):
    out = tmp_path / "train.json"
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-780m", "--smoke",
        "--device", "cpu", "--steps", "10", "--seq", "32", "--microbatches", "2", "--lr", "3e-3",
        "--warmup", "2", "--log-every", "5", "--out", str(out),
    ]
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = json.loads(out.read_text())
    assert s["config"] == "mamba2-smoke" and s["device"] == "cpu" and s["ssd_launches"] == 0
    assert len(s["losses"]) == 10 and np.isfinite(s["losses"] + s["grad_norms"]).all()
    assert s["losses"][-1] < s["losses"][0]
