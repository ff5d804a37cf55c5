"""The port's vision-language family (qwen2-vl) against ``repro``.

qwen2-vl-smoke (2 layers, d_model 192, GQA 4 over 2 heads of 48, QKV bias,
M-RoPE sections (6, 9, 9), tied embeddings) in fp32, on ``repro``'s
weights carried across by the bridge; inputs are made with numpy from a
seed and JAX runs on the CPU.  Tolerance: 1e-4 relative to the largest
entry of each tensor, for M-RoPE, logits, losses, gradients and decode
logits (the two frameworks sum products in different orders, ~1e-6
relative each, over two layers and the tied unembedding).  The data, the
micro-batch split, the bridge and the parameter count are held bitwise or
exactly.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs import get_arch as jax_get_arch
from repro.configs.io import make_batch as jax_make_batch
from repro.data import SyntheticTextDataset as JaxDataset
from repro.data import microbatch_split as jax_microbatch_split
from repro.launch import train as jax_train
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models.common import param_count as jax_param_count
from repro.training.steps import _reshape_microbatches
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.io import make_batch
from repro_torch.core.calibrate import _MetaGenerator
from repro_torch.data import SyntheticTextDataset, microbatch_split
from repro_torch.launch import train
from repro_torch.models import api, layers
from repro_torch.models import transformer as tf
from repro_torch.models.common import param_count
from repro_torch.serve import ServeEngine
from repro_torch.training.steps import _microbatches
from repro_torch.tree import flatten, tree_map

ARCH = "qwen2-vl-2b"
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite's other
    workers share the CPU, and spinning thread pools oversubscribe it.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (
        jax_get_arch(ARCH).smoke.replace(dtype=jnp.float32, **kw),
        get_arch(ARCH).smoke.replace(dtype=torch.float32, **kw),
    )


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _close(got, want, tol=TOL, name=""):
    """Within ``tol`` relative to the largest entry of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _bridged(seed=0):
    jcfg, tcfg = _cfgs()
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")


def _positions(B, T, seed):
    """Three distinct position streams [3, B, T] (a patch grid's t, h, w)."""
    return np.random.default_rng(seed).integers(0, 4 * T, (3, B, T)).astype(np.int32)


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full-sections"])
def test_apply_mrope_matches_reference(full):
    """M-RoPE on distinct streams, and on equal streams (text only), where
    it is 1-D RoPE; the full config's sections (16, 24, 24) at hd 128 and
    theta 1e6 too."""
    jcfg, tcfg = (jax_get_arch(ARCH).model, get_arch(ARCH).model) if full else _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, tcfg.hd)).astype(np.float32)
    p3 = _positions(2, 7, seed=1)
    got = layers.apply_mrope(tcfg, torch.from_numpy(x), torch.from_numpy(p3))
    _close(got, jax_layers.apply_mrope(jcfg, jnp.asarray(x), jnp.asarray(p3)), name="distinct streams")
    same = np.broadcast_to(p3[:1], p3.shape)
    got = layers.apply_mrope(tcfg, torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(same)))
    _close(got, jax_layers.apply_mrope(jcfg, jnp.asarray(x), jnp.asarray(same)), name="equal streams")
    cos, sin = layers.rope_frequencies(tcfg, torch.from_numpy(np.ascontiguousarray(same[0])))
    _close(got, layers.apply_rope(torch.from_numpy(x), cos, sin).numpy(), tol=1e-6, name="equal streams = RoPE")


def test_bridge_round_trip_is_bitwise():
    jparams, params = _bridged()
    _, tcfg = _cfgs()
    want, got = _flat(jparams), bridge.params_to_repro(params, tcfg)
    assert sorted(got) == sorted(want) and "blocks/0/attn/wq/b" in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _batch(B=2, T=16, seed=0):
    """make_batch's embeddings and labels in both packages (equal), with
    three distinct position streams in place of its equal ones."""
    jcfg, tcfg = _cfgs()
    jb, tb = jax_make_batch(jcfg, B, T, seed=seed), make_batch(tcfg, B, T, seed=seed)
    p3 = _positions(B, T, seed + 1)
    jb["mrope_positions"], tb["mrope_positions"] = jnp.asarray(p3), torch.from_numpy(p3)
    return jb, tb


def test_forward_loss_and_gradients_match_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _bridged(seed=1)
    jb, tb = _batch(seed=2)
    jlogits, _ = jax.jit(lambda p: jax_api.forward_fn(p, jcfg, jb))(jparams)
    logits, _ = api.forward_fn(params, tcfg, tb)
    _close(logits, jlogits, name="logits")
    _close(api.prefill_fn(params, tcfg, tb), jlogits[:, -1:], name="prefill logits")
    (jloss, _), jg = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = api.loss_fn(leaves, tcfg, tb)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    grads = bridge.params_to_repro(tree_map(lambda _: next(grads), params), tcfg)
    _close(loss, jloss, name="loss")
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    for key, g in grads.items():
        _close(torch.from_numpy(g), jflat[key], name=key)


def test_decode_steps_match_reference():
    """4 greedy decode steps over tokens through ``decode_fn``: the position
    broadcast to three streams (``cfg.mrope``), logits each step and the
    cache."""
    jcfg, tcfg = _cfgs()
    jparams, params = _bridged(seed=3)
    jcache, cache = jax_api.init_cache(jcfg, 2, 8), api.init_cache(tcfg, 2, 8, device="cpu")
    jdecode = jax.jit(lambda p, c, i, b: jax_api.decode_fn(p, jcfg, c, i, b))
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    for i in range(4):
        jlogits, jcache = jdecode(jparams, jcache, i, {"tokens": jnp.asarray(tok)})
        logits, cache = api.decode_fn(params, tcfg, cache, i, {"tokens": torch.from_numpy(tok).long()})
        _close(logits, jlogits, name=f"decode {i} logits")
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), tok[:, 0])
    want = bridge.cache_from_repro(_flat(jcache), tcfg)
    for got_l, want_l in zip(cache["layers"], want["layers"]):
        for name in ("k", "v"):
            _close(got_l["kv"][name], want_l["kv"][name].numpy(), name=name)


def test_make_batch_and_dataset_equal_reference():
    jcfg, tcfg = _cfgs()
    for kind, seed in (("train", 0), ("train", 5), ("decode", 3)):
        jb, tb = jax_make_batch(jcfg, 2, 24, kind=kind, seed=seed), make_batch(tcfg, 2, 24, kind=kind, seed=seed)
        assert sorted(jb) == sorted(tb)
        for key in tb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)
    ds = SyntheticTextDataset(1024, 24, 4, seed=2, embed_dim=192, mrope=True)
    jds = JaxDataset(1024, 24, 4, seed=2, embed_dim=192, mrope=True)
    for step in (0, 3):
        got, want = ds.batch_at(step, "cpu"), jds.batch_at(step)
        assert got.embeds.shape == (4, 24, 192)
        for name in ("tokens", "labels", "embeds", "mrope_positions"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_mrope_positions_split_along_the_batch_axis():
    """``[3, B, T]`` positions cut along axis 1 into micro-batches, by the
    train step's split and by ``microbatch_split``, as ``repro``'s; the
    other entries along axis 0."""
    B, T, M = 4, 6, 2
    rng = np.random.default_rng(0)
    batch = {
        "embeds": rng.standard_normal((B, T, 8)).astype(np.float32),
        "labels": rng.integers(0, 50, (B, T)),
        "mrope_positions": _positions(B, T, seed=1),
    }
    want = _reshape_microbatches({k: jnp.asarray(v) for k, v in batch.items()}, M)
    got = _microbatches({k: torch.from_numpy(v) for k, v in batch.items()}, M)
    for i in range(M):
        assert got[i]["mrope_positions"].shape == (3, B // M, T)
        for key in batch:
            np.testing.assert_array_equal(got[i][key].numpy(), np.asarray(want[key][i]), err_msg=key)
    jb = JaxDataset(64, T, B, seed=1, embed_dim=8, mrope=True).batch_at(0)
    tb = SyntheticTextDataset(64, T, B, seed=1, embed_dim=8, mrope=True).batch_at(0, "cpu")
    for got_mb, want_mb in zip(microbatch_split(tb, M), jax_microbatch_split(jb, M)):
        for name in ("tokens", "labels", "embeds", "mrope_positions"):
            np.testing.assert_array_equal(getattr(got_mb, name).numpy(), np.asarray(getattr(want_mb, name)))


def test_param_count_equals_reference_at_full_size():
    """``param_count`` of the full config equals ``repro``'s (1,543,757,312),
    and the tree drawn on ``meta`` holds ``repro``'s stacked leaves layer by
    layer."""
    cfg, jcfg = get_arch(ARCH).model, jax_get_arch(ARCH).model
    assert param_count(cfg) == jax_param_count(jcfg) == 1_543_757_312
    tree = tf.init_decoder(_MetaGenerator(), cfg)
    jtree = jax.eval_shape(lambda: jax_api.init_params(jax.random.PRNGKey(0), jcfg))
    jshapes = {_path_str(p): tuple(x.shape) for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    shapes = {k: tuple(t.shape) for k, t in flatten({k: v for k, v in tree.items() if k != "layers"}).items()}
    for key, t in flatten(tree["layers"][0]).items():
        shapes[f"blocks/0/{key}"] = (len(tree["layers"]), *t.shape)
    assert shapes == jshapes
    assert sum(t.numel() for t in flatten(tree).values()) == sum(int(np.prod(s)) for s in jshapes.values())


def _fp32_spec(get, dtype):
    def patched(arch):
        spec = get(arch)
        return dataclasses.replace(spec, smoke=spec.smoke.replace(dtype=dtype))

    return patched


def test_train_main_matches_run_spmd(monkeypatch, tmp_path):
    """``train.main --arch qwen2-vl-2b --smoke`` against ``repro``'s
    ``run_spmd`` on its weights, both in fp32: each step's loss (M = 2
    micro-batches, so the ``[3, B, T]`` positions are cut along axis 1;
    the patch embeddings from the dataset).  Both runs assert that the
    loss falls; the random patch embeddings carry nothing of the labels, so
    over a few steps the loss moves by noise around log(vocab), and the seed
    and rate are ones where ``repro``'s run falls."""
    monkeypatch.setattr(jax_train, "get_arch", _fp32_spec(jax_train.get_arch, jnp.float32))
    monkeypatch.setattr(train, "get_arch", _fp32_spec(train.get_arch, torch.float32))
    monkeypatch.setattr(api, "init_params", lambda cfg, seed, device: _bridged(seed)[1])
    argv = dict(steps=4, batch=4, seq=32, microbatches=2, lr=1e-3, warmup=1, seed=2, log_every=10)
    want = jax_train.run_spmd(argparse.Namespace(arch=ARCH, smoke=True, ckpt_dir=None, ckpt_every=0, **argv))
    out = tmp_path / "train.json"
    rc = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--out", str(out),
                     *[f"--{k.replace('_', '-')}={v}" for k, v in argv.items()]])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["config"] == "qwen2-vl-smoke" and s["flash_launches"] == 0
    _close(np.asarray(s["losses"]), np.asarray(want), name="losses")
    assert s["leaves_updated"] == s["leaves"]


def test_serving_paths_refuse_the_family_as_reference():
    jcfg, tcfg = _cfgs()
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError) as want:
        jax_api.prefill_with_cache({}, jcfg, {}, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(NotImplementedError) as got:
        api.prefill_with_cache({}, tcfg, {}, {"tokens": torch.from_numpy(tokens)})
    assert str(got.value) == str(want.value) == "prefill_with_cache does not support family 'vlm'"
    with pytest.raises(NotImplementedError, match="serving does not support family 'vlm'"):
        ServeEngine(tcfg, num_stages=1, max_slots=2, max_len=8, device="cpu")
