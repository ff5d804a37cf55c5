"""The port's layers and dense decoder against ``repro`` on bridged weights.

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU.  Tolerances: fp32 logits agree to 1e-4 (the two
frameworks sum matrix products in different orders, ~1e-6 relative per
product, compounded over two layers and the unembedding); bf16 logits to
5e-2 (a few bf16 ulps at magnitude ~1, where the two frameworks round
intermediates at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs.gpt import GPT_CONFIGS as JAX_GPT
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models.common import param_count as jax_param_count
from repro_torch import bridge
from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.models import api, layers
from repro_torch.models import transformer as tf
from repro_torch.models.common import param_count

SMALL = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32", **kw):
    jd, td = DTYPES[dtype]
    return (
        JAX_GPT["GPT-2.7B"].replace(**SMALL, dtype=jd, **kw),
        GPT_CONFIGS["GPT-2.7B"].replace(**SMALL, dtype=td, **kw),
    )


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _jnp32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- layers -----------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    want = jax_layers.layernorm({"scale": scale, "bias": bias}, jnp.asarray(x))
    got = layers.layernorm({"scale": torch.tensor(scale), "bias": torch.tensor(bias)}, torch.tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    want = jax_layers.rmsnorm({"scale": scale}, jnp.asarray(x))
    got = layers.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_mlp_matches_reference(act):
    jcfg, tcfg = _cfgs(mlp_act=act)
    rng = np.random.default_rng(1)
    names = ["gate", "up", "down"] if act == "swiglu" else ["up", "down"]
    p = {}
    for n in names:
        shape = (tcfg.d_ff, tcfg.d_model) if n == "down" else (tcfg.d_model, tcfg.d_ff)
        p[n] = {"w": rng.standard_normal(shape).astype(np.float32) * 0.1}
    x = rng.standard_normal((2, 3, tcfg.d_model)).astype(np.float32)
    want = jax_layers.mlp(p, jnp.asarray(x), jcfg)
    tp = {n: {"w": torch.tensor(v["w"])} for n, v in p.items()}
    got = layers.mlp(tp, torch.tensor(x), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_rope_matches_reference():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, tcfg.hd)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    jc, js = jax_layers.rope_frequencies(jcfg, jnp.asarray(pos))
    want = jax_layers.apply_rope(jnp.asarray(x), jc, js)
    tc, ts = layers.rope_frequencies(tcfg, torch.tensor(pos))
    got = layers.apply_rope(torch.tensor(x), tc, ts)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- whole model: prefill + decode ----------------------------------------------------


def _compare_cache(port_cache, jax_cache, cfg, tol):
    want = bridge.cache_from_repro(_flat(jax_cache), cfg)
    for got_l, want_l in zip(port_cache["layers"], want["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(got_l["kv"][name]), _np(want_l["kv"][name]), atol=tol, rtol=tol
            )


CASES = [
    # (name, dtype, extra config, tolerance, compare greedy tokens)
    ("fp32", "float32", {}, 1e-4, True),
    ("fp32_window_ring", "float32", {"attn_window": 8}, 1e-4, True),
    ("bf16", "bfloat16", {}, 5e-2, False),
]


@pytest.mark.parametrize("name,dtype,extra,tol,tokens", CASES, ids=[c[0] for c in CASES])
def test_prefill_and_decode_match_reference(name, dtype, extra, tol, tokens):
    jcfg, tcfg = _cfgs(dtype, **extra)
    jparams = jax_api.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")
    B, T, L = 2, 12, 32
    prompt = np.random.default_rng(3).integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)

    jcache = jax_api.init_cache(jcfg, B, L)
    jlogits, jcache = jax_api.prefill_with_cache(jparams, jcfg, jcache, {"tokens": jnp.asarray(prompt)})
    cache = api.init_cache(tcfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.tensor(prompt).long()})
    np.testing.assert_allclose(_np(logits), _jnp32(jlogits), atol=tol, rtol=tol)
    _compare_cache(cache, jcache, tcfg, tol)

    for i in range(3):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
        if tokens:
            np.testing.assert_array_equal(_np(logits[:, -1]).argmax(-1), tok[:, 0])
        jlogits, jcache = jax_api.decode_fn(jparams, jcfg, jcache, T + i, {"tokens": jnp.asarray(tok)})
        logits, cache = api.decode_fn(params, tcfg, cache, T + i, {"tokens": torch.tensor(tok).long()})
        np.testing.assert_allclose(_np(logits), _jnp32(jlogits), atol=tol, rtol=tol)
    _compare_cache(cache, jcache, tcfg, tol)


def test_batched_per_row_decode_matches_vmapped_single_slot():
    """Per-row positions in one batch == the reference's vmap of batch-1
    decode_fn over slot-major cache rows (serve/engine.py's group step)."""
    jcfg, tcfg = _cfgs()
    jparams = jax_api.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")
    L, lens = 24, [5, 11, 1, 8]
    rng = np.random.default_rng(4)
    rows = []
    for n in lens:
        c = jax_api.init_cache(jcfg, 1, L)
        prompt = rng.integers(0, tcfg.vocab_size, (1, n)).astype(np.int32)
        _, c = jax_api.prefill_with_cache(jparams, jcfg, c, {"tokens": jnp.asarray(prompt)})
        rows.append(c)
    kv = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *rows)  # [slots, <batch-1 row>]
    pos = np.asarray(lens, np.int32)
    tok = rng.integers(0, tcfg.vocab_size, (len(lens), 1, 1)).astype(np.int32)

    cache = bridge.cache_from_repro(_flat(kv), tcfg, slot_major=True, device="cpu")

    def single(p, c, i, t):
        logits, nc = jax_api.decode_fn(p, jcfg, c, i, {"tokens": t})
        return logits[:, -1, :], nc

    jlogits, jkv = jax.vmap(single, in_axes=(None, 0, 0, 0))(
        jparams, kv, jnp.asarray(pos), jnp.asarray(tok)
    )
    logits, cache = api.decode_fn(
        params, tcfg, cache, torch.tensor(pos).long(), {"tokens": torch.tensor(tok[:, 0]).long()}
    )
    np.testing.assert_allclose(_np(logits[:, -1]), np.asarray(jlogits)[:, 0], atol=1e-4, rtol=1e-4)
    want = bridge.cache_from_repro(_flat(jkv), tcfg, slot_major=True)
    for got_l, want_l in zip(cache["layers"], want["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(got_l["kv"][name]), _np(want_l["kv"][name]), atol=1e-4, rtol=1e-4
            )


def test_cast_for_serving_keeps_norms_and_biases_in_param_dtype():
    _, tcfg = _cfgs("bfloat16", qkv_bias=True)
    params = api.cast_for_serving(api.init_params(tcfg, seed=0, device="cpu"), tcfg)
    flat = bridge.flatten(params)
    for key, t in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        want = torch.bfloat16 if leaf in ("w", "table", "head") else torch.float32
        assert t.dtype == want, key
    assert any(k.endswith("/b") for k in flat)


UNPORTED = [
    # (call, family, what repro does): each call on each family the port
    # refused until the encoder-decoder and vision-language families were
    # ported; "raise" where repro raises, else the result is held to repro's
    ("init_params", "encdec", "shapes"),
    ("init_params", "vlm", "shapes"),
    ("init_cache", "audio", "shapes"),
    ("init_cache", "vlm", "shapes"),
    ("prefill_with_cache", "encdec", "raise"),
    ("decode_fn", "audio", "values"),
    ("loss_fn", "vlm", "values"),
    ("loss_fn", "encdec", "values"),
    ("decoder_forward", "audio", "values"),
]


@pytest.mark.parametrize("call,family,match", UNPORTED, ids=[f"{c}-{f}" for c, f, _ in UNPORTED])
def test_unported_families_raise(call, family, match):
    """Each call does what ``repro``'s does on the family (the GPT test
    config with the family swapped in, one encoder layer for encdec):
    ``prefill_with_cache`` of encdec raises ``repro``'s
    ``NotImplementedError``; the inits give ``repro``'s leaves and shapes
    (through the bridge); the loss, forward and decode give its values on
    its weights, to 1e-4."""
    jcfg, tcfg = _cfgs()
    extra = {"family": family, "encoder_layers": 1 if family == "encdec" else 0}
    jcfg, cfg = jcfg.replace(**extra), tcfg.replace(**extra)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    embeds = (rng.standard_normal((2, 6, cfg.d_model)) * 0.02).astype(np.float32)
    if match == "raise":
        with pytest.raises(NotImplementedError) as want:
            jax_api.prefill_with_cache({}, jcfg, {}, {"tokens": jnp.asarray(tokens)})
        with pytest.raises(NotImplementedError) as got:
            api.prefill_with_cache({}, cfg, {}, {"tokens": torch.from_numpy(tokens)})
        assert str(got.value) == str(want.value)
        return
    if match == "shapes":
        if call == "init_params":
            want = _flat(jax_api.init_params(jax.random.PRNGKey(0), jcfg))
            got = bridge.params_to_repro(api.init_params(cfg, device="cpu"), cfg)
        else:  # the port's cache against repro's, carried to the port's layout
            want = bridge.flatten(bridge.cache_from_repro(_flat(jax_api.init_cache(jcfg, 2, 8)), cfg))
            got = bridge.flatten(api.init_cache(cfg, 2, 8, device="cpu"))
        assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
        return
    jparams = jax_api.init_params(jax.random.PRNGKey(1), jcfg)
    params = bridge.params_from_repro(_flat(jparams), cfg, device="cpu")
    jbatch, batch = {"tokens": tokens, "labels": tokens}, {"tokens": tokens, "labels": tokens}
    if family == "vlm":
        jbatch = batch = {"embeds": embeds, "labels": tokens}
    if family == "encdec":
        jbatch = batch = {"src_embeds": embeds, "tgt_tokens": tokens, "labels": tokens}
    jbatch = {k: jnp.asarray(v) for k, v in jbatch.items()}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    if call == "loss_fn":
        want, got = jax_api.loss_fn(jparams, jcfg, jbatch)[0], api.loss_fn(params, cfg, batch)[0]
    elif call == "decoder_forward":
        from repro.models import transformer as jax_tf

        want = jax_tf.decoder_forward(jparams, jcfg, jbatch["tokens"])[0]
        got = tf.decoder_forward(params, cfg, batch["tokens"])[0]
    else:
        want, _ = jax_api.decode_fn(jparams, jcfg, jax_api.init_cache(jcfg, 2, 8), 0, {"tokens": jbatch["tokens"][:, :1]})
        got, _ = api.decode_fn(params, cfg, api.init_cache(cfg, 2, 8, device="cpu"), 0, {"tokens": batch["tokens"][:, :1]})
    want = _jnp32(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_plain_attention_prefill_matches_flash_path():
    """``plain_attention`` (the kernel's plain version, called directly) and
    the flash wrapper (which dispatches a CPU tensor to that plain version)
    give one function, and fill the cache alike."""
    _, tcfg = _cfgs()
    params = api.init_params(tcfg, seed=5, device="cpu")
    tokens = torch.tensor(np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 10)))
    out = []
    for plain in (False, True):
        cache = api.init_cache(tcfg, 2, 16, device="cpu")
        logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": tokens}, plain_attention=plain)
        out.append((logits, cache["layers"][1]["kv"]["k"]))
    torch.testing.assert_close(out[0][0], out[1][0], atol=0, rtol=0)
    torch.testing.assert_close(out[0][1], out[1][1], atol=0, rtol=0)


PARAM_COUNT_CASES = [
    (name, extra)
    for name in JAX_GPT
    for extra in ({}, {"mlp_act": "swiglu", "norm": "rmsnorm", "qkv_bias": True, "tie_embeddings": False})
]


@pytest.mark.parametrize(
    "name,extra", PARAM_COUNT_CASES, ids=[f"{n}-{'variant' if e else 'table1'}" for n, e in PARAM_COUNT_CASES]
)
def test_param_count_matches_reference(name, extra):
    """The port's param_count equals the reference's for each Table-1 GPT
    and for a SwiGLU / RMSNorm / qkv-bias / untied variant of it."""
    want = jax_param_count(JAX_GPT[name].replace(**extra))
    assert param_count(GPT_CONFIGS[name].replace(**extra)) == want


def test_param_count_of_gpt_2_7b_and_unported_family():
    # ~2.65 B parameters: 32 layers of ~78.7 M plus the tied 50 257 x 2560 table;
    # the vlm family counts as repro counts it (the decoder alone), and an
    # encoder-decoder adds its encoder layers and each decoder layer's cross
    # attention
    n = param_count(GPT_CONFIGS["GPT-2.7B"])
    assert 2.6e9 < n < 2.7e9
    for extra in ({"family": "vlm"}, {"family": "encdec", "encoder_layers": 3}):
        want = jax_param_count(JAX_GPT["GPT-2.7B"].replace(**extra))
        assert param_count(GPT_CONFIGS["GPT-2.7B"].replace(**extra)) == want
