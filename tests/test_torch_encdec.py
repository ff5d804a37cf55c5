"""The port's encoder-decoder family (seamless-m4t) against ``repro``.

seamless-m4t-smoke (2 encoder and 2 decoder layers, d_model 128, 4 heads
of 32 over 4 KV heads, LayerNorm, GeLU, tied embeddings) in fp32, on
``repro``'s weights carried across by the bridge; inputs are made with
numpy from a seed (``configs/io.py::make_batch`` in both packages) and JAX
runs on the CPU.  Tolerance: 1e-4 relative to the largest entry of each
tensor, for logits, losses, gradients, decode logits and caches (the two
frameworks sum products in different orders, ~1e-6 relative each, over
four layers, the cross attention and the tied unembedding).  The data,
the bridge and the parameter count are held bitwise or exactly.
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
from repro.launch import train as jax_train
from repro.models import api as jax_api
from repro.models import transformer as jax_tf
from repro.models.common import param_count as jax_param_count
from repro.pipeline.stage import StagedModel as JaxStaged
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.configs.io import make_batch
from repro_torch.core.calibrate import _MetaGenerator
from repro_torch.data import SyntheticTextDataset
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.models.common import param_count
from repro_torch.pipeline import StagedModel
from repro_torch.serve import ServeEngine
from repro_torch.tree import flatten, tree_map

ARCH = "seamless-m4t-medium"
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


def _cfgs():
    return jax_get_arch(ARCH).smoke.replace(dtype=jnp.float32), get_arch(ARCH).smoke.replace(dtype=torch.float32)


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


def _batches(kind="train", B=2, T=16, seed=0):
    jcfg, tcfg = _cfgs()
    return jax_make_batch(jcfg, B, T, kind=kind, seed=seed), make_batch(tcfg, B, T, kind=kind, seed=seed)


def test_bridge_round_trip_is_bitwise():
    jparams, params = _bridged()
    _, tcfg = _cfgs()
    assert len(params["encoder"]) == len(params["decoder"]) == 2
    assert sorted(params["decoder"][0]) == ["attn", "ln1", "ln2", "ln_x", "mlp", "xattn"]
    want, got = _flat(jparams), bridge.params_to_repro(params, tcfg)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_forward_loss_and_gradients_match_reference():
    jcfg, tcfg = _cfgs()
    jparams, params = _bridged(seed=1)
    jb, tb = _batches(seed=2)
    jlogits, _ = jax.jit(lambda p: jax_api.forward_fn(p, jcfg, jb))(jparams)
    logits, _ = api.forward_fn(params, tcfg, tb)
    _close(logits, jlogits, name="logits")
    _close(api.prefill_fn(params, tcfg, tb), jlogits[:, -1:], name="prefill logits")
    (jloss, jm), jg = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(p, jcfg, jb), has_aux=True))(jparams)
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, m = api.loss_fn(leaves, tcfg, tb)
    grads = iter(torch.autograd.grad(loss, list(flatten(leaves).values())))
    grads = bridge.params_to_repro(tree_map(lambda _: next(grads), params), tcfg)
    _close(loss, jloss, name="loss")
    _close(m["ce_loss"], jm["ce_loss"], name="ce_loss")
    jflat = _flat(jg)
    assert sorted(grads) == sorted(jflat)
    for key, g in grads.items():
        _close(torch.from_numpy(g), jflat[key], name=key)


def test_decode_steps_match_reference():
    """The encoder's memory of a source batch, then 4 greedy decode steps
    against it through ``decode_fn``: logits each step and the cache."""
    jcfg, tcfg = _cfgs()
    jparams, params = _bridged(seed=3)
    jb, tb = _batches(B=2, T=24, seed=4)
    jmem = jax.jit(lambda p, x: jax_tf._encode(p, jcfg, x))(jparams, jb["src_embeds"])
    mem = tf._encode(params, tcfg, tb["src_embeds"])
    _close(mem, jmem, name="memory")
    jcache, cache = jax_api.init_cache(jcfg, 2, 8), api.init_cache(tcfg, 2, 8, device="cpu")
    jdecode = jax.jit(lambda p, c, i, b: jax_api.decode_fn(p, jcfg, c, i, b))
    tok = np.array(jb["tgt_tokens"][:, :1])
    for i in range(4):
        jlogits, jcache = jdecode(jparams, jcache, i, {"tokens": jnp.asarray(tok), "memory": jmem})
        logits, cache = api.decode_fn(params, tcfg, cache, i, {"tokens": torch.from_numpy(tok).long(), "memory": mem})
        _close(logits, jlogits, name=f"decode {i} logits")
        tok = np.array(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(), tok[:, 0])
    want = bridge.cache_from_repro(_flat(jcache), tcfg)
    for got_l, want_l in zip(cache["decoder"], want["decoder"]):
        for name in ("k", "v"):
            _close(got_l["kv"][name], want_l["kv"][name].numpy(), name=name)


def test_make_batch_and_dataset_equal_reference():
    for kind, seed in (("train", 0), ("train", 5), ("decode", 3)):
        jb, tb = _batches(kind, B=2, T=24, seed=seed)
        assert sorted(jb) == sorted(tb)
        for key in tb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]), err_msg=key)
    assert tb["memory"].shape == (2, 3, 128) and tb["memory"].dtype == torch.float32
    # the frame embeddings draw from the generator after the token noise
    ds = SyntheticTextDataset(1024, 32, 4, seed=2, embed_dim=128, embed_len=4)
    jds = JaxDataset(1024, 32, 4, seed=2, embed_dim=128, embed_len=4)
    for step in (0, 3):
        got, want = ds.batch_at(step, "cpu"), jds.batch_at(step)
        for name in ("tokens", "labels", "embeds"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert got.mrope_positions is None and want.mrope_positions is None


def test_param_count_equals_reference_at_full_size():
    """``param_count`` of the full config equals ``repro``'s (614,763,520),
    and the tree drawn on ``meta`` has ``repro``'s leaves and shapes."""
    cfg, jcfg = get_arch(ARCH).model, jax_get_arch(ARCH).model
    assert param_count(cfg) == jax_param_count(jcfg) == 614_763_520
    shapes = {k: tuple(t.shape) for k, t in flatten(tf.init_encdec(_MetaGenerator(), cfg)).items()}
    jshapes = {
        _path_str(p): tuple(x.shape)
        for p, x in jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda: jax_api.init_params(jax.random.PRNGKey(0), jcfg))
        )[0]
    }
    assert shapes == jshapes


def _fp32_spec(get, dtype):
    def patched(arch):
        spec = get(arch)
        return dataclasses.replace(spec, smoke=spec.smoke.replace(dtype=dtype))

    return patched


def test_train_main_matches_run_spmd(monkeypatch, tmp_path):
    """``train.main --arch seamless-m4t-medium --smoke`` against ``repro``'s
    ``run_spmd`` on its weights, both in fp32: each step's loss (M = 2
    micro-batches, the frame embeddings from the dataset)."""
    jcfg, tcfg = _cfgs()
    monkeypatch.setattr(jax_train, "get_arch", _fp32_spec(jax_train.get_arch, jnp.float32))
    monkeypatch.setattr(train, "get_arch", _fp32_spec(train.get_arch, torch.float32))
    monkeypatch.setattr(api, "init_params", lambda cfg, seed, device: _bridged(seed)[1])
    argv = dict(steps=4, batch=4, seq=32, microbatches=2, lr=3e-3, warmup=1, seed=0, log_every=10)
    want = jax_train.run_spmd(argparse.Namespace(arch=ARCH, smoke=True, ckpt_dir=None, ckpt_every=0, **argv))
    out = tmp_path / "train.json"
    rc = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--out", str(out),
                     *[f"--{k.replace('_', '-')}={v}" for k, v in argv.items()]])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["config"] == "seamless-m4t-smoke" and s["flash_launches"] == 0
    _close(np.asarray(s["losses"]), np.asarray(want), name="losses")
    assert s["leaves_updated"] == s["leaves"]


def test_serving_paths_refuse_the_family_as_reference():
    """``repro``'s ``prefill_with_cache`` and serve engine refuse enc-dec;
    so do the port's, with the same messages; the pipeline's stage
    partitioner refuses it with ``repro``'s ``ValueError``."""
    jcfg, tcfg = _cfgs()
    tokens = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError) as want:
        jax_api.prefill_with_cache({}, jcfg, {}, {"tokens": jnp.asarray(tokens)})
    with pytest.raises(NotImplementedError) as got:
        api.prefill_with_cache({}, tcfg, {}, {"tokens": torch.from_numpy(tokens)})
    assert str(got.value) == str(want.value) == "prefill_with_cache does not support family 'encdec'"
    with pytest.raises(NotImplementedError, match="serving does not support family 'encdec'"):
        ServeEngine(tcfg, num_stages=1, max_slots=2, max_len=8, device="cpu")
    with pytest.raises(ValueError) as want:
        JaxStaged.build(jcfg, 2)
    with pytest.raises(ValueError) as got:
        StagedModel.build(tcfg, 2)
    assert str(got.value) == str(want.value)
