"""The weight and cache bridge between ``repro``'s trees and the port's.

``repro``'s trees are flattened here with ``jax.tree_util`` and the
``checkpoint/io.py::_path_str`` key scheme; the bridge itself takes numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs.gpt import GPT_CONFIGS as JAX_GPT
from repro.configs.mamba2_780m import SMOKE as JAX_MAMBA_SMOKE
from repro.models import api as jax_api
from repro_torch import bridge
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.configs.mamba2_780m import SMOKE as MAMBA_SMOKE
from repro_torch.models import api

SMALL = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)
# (name, replacements): the GPT shape (one-layer pattern, 2 blocks), and a
# 4-layer two-window pattern (2 layers per block, 2 blocks) with biases
CONFIGS = [
    ("gpt", {}),
    ("pattern2_bias", {"num_layers": 4, "window_pattern": (4, None), "qkv_bias": True}),
]


def _cfgs(bf16: bool = False, **kw):
    return (
        JAX_GPT["GPT-2.7B"].replace(**{**SMALL, **kw}, dtype=jnp.bfloat16 if bf16 else jnp.float32),
        GPT_CONFIGS["GPT-2.7B"].replace(**{**SMALL, **kw}, dtype=torch.bfloat16 if bf16 else torch.float32),
    )


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_params_round_trip_is_bitwise(name, kw):
    jcfg, tcfg = _cfgs(**kw)
    flat = _flat(jax_api.init_params(jax.random.PRNGKey(0), jcfg))
    params = bridge.params_from_repro(flat, tcfg, device="cpu")
    back = bridge.params_to_repro(params, tcfg)
    assert sorted(back) == sorted(flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].shape == arr.shape, key
        np.testing.assert_array_equal(back[key].view(np.uint32), arr.view(np.uint32), err_msg=key)


@pytest.mark.parametrize("name,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_params_unstack_into_model_order(name, kw):
    jcfg, tcfg = _cfgs(**kw)
    flat = _flat(jax_api.init_params(jax.random.PRNGKey(1), jcfg))
    params = bridge.params_from_repro(flat, tcfg, device="cpu")
    pattern = 2 if kw else 1
    assert len(params["layers"]) == tcfg.num_layers
    for g, layer in enumerate(params["layers"]):
        block, j = divmod(g, pattern)
        want = flat[f"blocks/{j}/attn/wq/w"][block]
        np.testing.assert_array_equal(layer["attn"]["wq"]["w"].numpy(), want)
    # the port's own initialiser makes the same tree shape
    ours = bridge.flatten(api.init_params(tcfg, seed=0, device="cpu"))
    mine = bridge.flatten(params)
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in mine.items()}


def test_mamba_params_round_trip_is_bitwise():
    """mamba2-smoke: ``blocks/0/mamba/*`` (one layer per block, 2 blocks)
    unstacks into ``layers/<i>/mamba/*`` and stacks back, bitwise."""
    flat = _flat(jax_api.init_params(jax.random.PRNGKey(0), JAX_MAMBA_SMOKE))
    params = bridge.params_from_repro(flat, MAMBA_SMOKE, device="cpu")
    assert len(params["layers"]) == MAMBA_SMOKE.num_layers
    for i, layer in enumerate(params["layers"]):
        for name, t in layer["mamba"].items():
            np.testing.assert_array_equal(t.numpy(), flat[f"blocks/0/mamba/{name}"][i])
    back = bridge.params_to_repro(params, MAMBA_SMOKE)
    assert sorted(back) == sorted(flat) and any("/mamba/A_log" in k for k in flat)
    for key, arr in flat.items():
        assert back[key].dtype == arr.dtype and back[key].shape == arr.shape, key
        np.testing.assert_array_equal(back[key].view(np.uint32), arr.view(np.uint32), err_msg=key)
    # the port's own initialiser makes the same tree shape
    ours = bridge.flatten(api.init_params(MAMBA_SMOKE, seed=0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in bridge.flatten(params).items()
    }


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_cache_from_batch_and_slot_major_layouts(bf16):
    jcfg, tcfg = _cfgs(bf16, num_layers=4, window_pattern=(4, None))
    B, L, slots = 2, 6, 3
    rng = np.random.default_rng(0)
    cache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jax_api.init_cache(jcfg, B, L)
    )
    flat = _flat(cache)
    ours = bridge.cache_from_repro(flat, tcfg, device="cpu")
    for g, layer in enumerate(ours["layers"]):
        block, j = divmod(g, 2)
        want = flat[f"blocks/{j}/kv/k"][block]
        got = layer["kv"]["k"]
        assert got.dtype == tcfg.dtype and tuple(got.shape) == want.shape
        if bf16:  # compare the bits
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)

    # ServeEngine.kv: every leaf gains a leading slot axis over a batch-1 row
    row = jax_api.init_cache(jcfg, 1, L)
    kv = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal((slots,) + x.shape), x.dtype), row
    )
    flat = _flat(kv)
    ours = bridge.cache_from_repro(flat, tcfg, slot_major=True, device="cpu")
    for g, layer in enumerate(ours["layers"]):
        block, j = divmod(g, 2)
        want = np.asarray(flat[f"blocks/{j}/kv/v"][:, block, 0], np.float32)
        got = layer["kv"]["v"]
        assert tuple(got.shape) == (slots,) + want.shape[1:]
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_bridge_rejects_missing_layers():
    jcfg, tcfg = _cfgs()
    flat = _flat(jax_api.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="blocks"):
        bridge.params_from_repro(flat, tcfg.replace(num_layers=4), device="cpu")
