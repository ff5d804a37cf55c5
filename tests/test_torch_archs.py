"""The port's arch registry and its dense architectures against ``repro``.

Registry: the ids, every ``ArchSpec`` and ``ModelConfig`` field (dtypes
mapped) and ``param_count`` equal to ``repro``'s for every arch
(``tests/test_torch_hybrid.py`` holds the MoE and hybrid models,
``tests/test_torch_encdec.py`` and ``tests/test_torch_vlm.py`` the
encoder-decoder and vision-language ones); twins of
``tests/test_archs.py``'s config checks.
``configs/io.py``: ``make_batch``, ``serving_config`` and ``input_specs``
equal to ``repro``'s.

Model: each dense smoke config (RMSNorm, SwiGLU, RoPE; qwen1.5's QKV bias
with MHA, qwen2.5's bias with GQA 8 over 2, internlm2's GQA at rope_theta
1e4 as its smoke has it, gemma3's period-2 window pattern with head_dim 64
and tied embeddings) in fp32 on ``repro``'s weights through the bridge:
prefill plus 3 decode steps (logits and cache), the loss and its gradients,
and one AdamW train step, at 1e-4 (the two frameworks sum products in
different orders, ~1e-6 relative each, over two layers and the
unembedding).  gemma3-smoke also runs an 80-token prompt past its 64-token
window (cache ``max_len`` 96), so that the ring buffer and the window mask
matter.  The full configs' features that no smoke config has
(``q_dim != d_model``, rope_theta 1e6, the period-6 pattern) run through a
narrow two-block variant of the full config.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import _path_str
from repro.configs import ALL_ARCH_IDS as JAX_ALL_ARCH_IDS
from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs.io import input_specs as jax_input_specs
from repro.configs.io import make_batch as jax_make_batch
from repro.configs.io import serving_config as jax_serving_config
from repro.models import api as jax_api
from repro.models.common import active_param_count as jax_active_param_count
from repro.models.common import param_count as jax_param_count
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import schedules as jax_schedules
from repro.training import create_train_state as jax_create_train_state
from repro.training import make_train_step as jax_make_train_step
from repro_torch import bridge
from repro_torch.configs import ALL_ARCH_IDS, INPUT_SHAPES, get_arch, list_archs
from repro_torch.configs.io import AUDIO_SUBSAMPLE, input_specs, make_batch, serving_config
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, active_param_count, param_count
from repro_torch.optim import make_optimizer, schedules
from repro_torch.training import create_train_state, make_train_step
from repro_torch.tree import flatten, tree_map

DENSE = ["qwen2.5-14b", "internlm2-20b", "gemma3-12b", "qwen1.5-4b"]
TOL = 1e-4
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def _torch_dtype(jdtype) -> torch.dtype:
    return _DTYPES[jnp.dtype(jdtype).name]


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _close(got, want, tol=TOL, name=""):
    """Within ``tol`` relative to the largest entry of ``want``."""
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _config_fields_equal(port: ModelConfig, ref) -> None:
    """Every field of the port's ModelConfig equals ``repro``'s, dtypes mapped."""
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name in ("dtype", "param_dtype"):
            want = _torch_dtype(want)
        assert got == want, f"{port.name}.{f.name}: {got!r} != {want!r}"


# -- the registry -------------------------------------------------------------------


def test_list_archs_equals_reference():
    assert list_archs() == jax_list_archs() == ALL_ARCH_IDS == JAX_ALL_ARCH_IDS
    assert list(INPUT_SHAPES) == list(JAX_INPUT_SHAPES)
    for name, shape in INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JAX_INPUT_SHAPES[name])


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_arch_spec_and_configs_equal_reference(arch):
    spec, ref = get_arch(arch), jax_get_arch(arch)
    for f in ("arch_id", "citation", "optimizer", "long_context", "long_window", "notes", "family"):
        assert getattr(spec, f) == getattr(ref, f), f
    for name in INPUT_SHAPES:
        assert spec.supports(INPUT_SHAPES[name]) == ref.supports(JAX_INPUT_SHAPES[name])
    _config_fields_equal(spec.model, ref.model)
    _config_fields_equal(spec.smoke, ref.smoke)
    assert spec.model.max_seq_len == ref.model.max_seq_len == 131_072


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_unported_arch_raises_naming_its_item(arch):
    """The two archs ``get_arch`` refused until their families were ported
    now build ``repro``'s configs, field for field; an unknown id raises
    ``KeyError``, as in ``repro``."""
    spec, ref = get_arch(arch), jax_get_arch(arch)
    _config_fields_equal(spec.model, ref.model)
    assert spec.family == ref.family in ("encdec", "vlm") and spec.citation == ref.citation
    with pytest.raises(KeyError):
        get_arch("gpt-5")


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_count_equals_reference(arch):
    spec, ref = get_arch(arch), jax_get_arch(arch)
    assert param_count(spec.model) == jax_param_count(ref.model)
    assert param_count(spec.smoke) == jax_param_count(ref.smoke)
    assert active_param_count(spec.model) == jax_active_param_count(ref.model)
    assert active_param_count(spec.smoke) == jax_active_param_count(ref.smoke)


# twins of tests/test_archs.py's config checks, on the port's registry


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_smoke_constraints(arch):
    cfg = get_arch(arch).smoke
    assert cfg.num_layers <= 2
    assert cfg.d_model <= 512
    assert cfg.num_experts <= 4


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_full_config_matches_assignment(arch):
    expected = {
        "kimi-k2-1t-a32b": (61, 7168, 64, 8, 163_840, 384, 8),
        "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 202_048, 128, 1),
        "qwen2.5-14b": (48, 5120, 40, 8, 152_064, 0, 0),
        "internlm2-20b": (48, 6144, 48, 8, 92_544, 0, 0),
        "gemma3-12b": (48, 3840, 16, 8, 262_144, 0, 0),
        "jamba-v0.1-52b": (32, 4096, 32, 8, 65_536, 16, 2),
        "qwen1.5-4b": (40, 2560, 20, 20, 151_936, 0, 0),
        "mamba2-780m": (48, 1536, 0, 0, 50_280, 0, 0),
        "seamless-m4t-medium": (12, 1024, 16, 16, 256_206, 0, 0),
        "qwen2-vl-2b": (28, 1536, 12, 2, 151_936, 0, 0),
    }[arch]
    cfg = get_arch(arch).model
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.vocab_size, cfg.num_experts,
            cfg.num_experts_per_tok) == expected


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_counts_in_band(arch):
    bands = {
        "kimi-k2-1t-a32b": (0.9e12, 1.2e12),
        "llama4-maverick-400b-a17b": (3.5e11, 4.5e11),
        "jamba-v0.1-52b": (4.5e10, 6e10),
        "qwen2.5-14b": (1.2e10, 1.7e10),
        "internlm2-20b": (1.7e10, 2.3e10),
        "gemma3-12b": (0.9e10, 1.4e10),
        "qwen1.5-4b": (3e9, 5e9),
        "mamba2-780m": (6e8, 1e9),
        "seamless-m4t-medium": (4e8, 1.5e9),
        "qwen2-vl-2b": (1.2e9, 2.5e9),
    }[arch]
    n = param_count(get_arch(arch).model)
    assert bands[0] <= n <= bands[1], f"{arch}: {n:.3e}"


# -- configs/io.py --------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_serving_config_and_input_specs_equal_reference(arch):
    spec, ref = get_arch(arch), jax_get_arch(arch)
    for name, shape in INPUT_SHAPES.items():
        _config_fields_equal(serving_config(spec, shape), jax_serving_config(ref, JAX_INPUT_SHAPES[name]))
        for reduced in (False, True):
            got, want = input_specs(spec, name, reduced=reduced), jax_input_specs(ref, name, reduced=reduced)
            assert sorted(got) == sorted(want)
            for key, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[key].shape and t.dtype == _torch_dtype(want[key].dtype), key
    assert serving_config(spec, INPUT_SHAPES["long_500k"]).max_seq_len == 524_288


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_make_batch_equals_reference(arch):
    cfg, jcfg = get_arch(arch).smoke, jax_get_arch(arch).smoke
    for kind, seed in (("train", 0), ("train", 5), ("decode", 3)):
        got, want = make_batch(cfg, 2, 24, kind=kind, seed=seed), jax_make_batch(jcfg, 2, 24, kind=kind, seed=seed)
        assert sorted(got) == sorted(want)
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_io_refuses_the_later_families():
    """The vlm and encdec branches of ``make_batch`` on a text arch's smoke
    config with the family swapped in give ``repro``'s arrays (they raised
    until those families were ported)."""
    assert AUDIO_SUBSAMPLE == 8
    for family in ("vlm", "encdec"):
        cfg = get_arch("qwen2.5-14b").smoke.replace(family=family)
        jcfg = jax_get_arch("qwen2.5-14b").smoke.replace(family=family)
        for kind in ("train", "decode"):
            got, want = make_batch(cfg, 2, 16, kind=kind), jax_make_batch(jcfg, 2, 16, kind=kind)
            assert sorted(got) == sorted(want)
            for key in got:
                np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_init_serving_params_is_the_cast_init_bitwise(arch):
    cfg = get_arch(arch).smoke
    want = flatten(api.cast_for_serving(api.init_params(cfg, seed=7, device="cpu"), cfg))
    got = flatten(api.init_serving_params(cfg, seed=7, device="cpu"))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


# -- the dense model on bridged weights ----------------------------------------------


def _cfgs(arch, **kw):
    return (
        jax_get_arch(arch).smoke.replace(dtype=jnp.float32, **kw),
        get_arch(arch).smoke.replace(dtype=torch.float32, **kw),
    )


def _full_variant(arch):
    """The full config's attention features (head_dim, q_dim != d_model,
    GQA, rope_theta, the window pattern's period) at a narrow width and
    one block's depth; vocabulary 512."""
    cut = {
        "gemma3-12b": dict(num_layers=6, d_model=96, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128,
                           window_pattern=(16, 16, 16, 16, 16, None)),
        "qwen2.5-14b": dict(num_layers=2, d_model=80, num_heads=10, num_kv_heads=2, head_dim=16, d_ff=128),
    }[arch]
    return (
        jax_get_arch(arch).model.replace(vocab_size=512, dtype=jnp.float32, **cut),
        get_arch(arch).model.replace(vocab_size=512, dtype=torch.float32, **cut),
    )


def _bridged(jcfg, tcfg, seed=0):
    jparams = jax_api.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, bridge.params_from_repro(_flat(jparams), tcfg, device="cpu")


def _compare_cache(cache, jcache, cfg):
    want = bridge.cache_from_repro(_flat(jcache), cfg)
    for got_l, want_l in zip(cache["layers"], want["layers"]):
        for name in ("k", "v"):
            assert got_l["kv"][name].shape == want_l["kv"][name].shape
            _close(got_l["kv"][name], _np(want_l["kv"][name]), name=name)


def _prefill_and_decode(jcfg, tcfg, T, L, seed=0):
    jparams, params = _bridged(jcfg, tcfg, seed)
    B = 2
    prompt = np.random.default_rng(seed + 3).integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    jcache = jax_api.init_cache(jcfg, B, L)
    jlogits, jcache = jax_api.prefill_with_cache(jparams, jcfg, jcache, {"tokens": jnp.asarray(prompt)})
    cache = api.init_cache(tcfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, tcfg, cache, {"tokens": torch.from_numpy(prompt).long()})
    _close(logits, jlogits, name="prefill logits")
    _compare_cache(cache, jcache, tcfg)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1)).astype(np.int32)[:, None]
        np.testing.assert_array_equal(_np(logits[:, -1]).argmax(-1), tok[:, 0])
        jlogits, jcache = jax_api.decode_fn(jparams, jcfg, jcache, T + i, {"tokens": jnp.asarray(tok)})
        logits, cache = api.decode_fn(params, tcfg, cache, T + i, {"tokens": torch.from_numpy(tok).long()})
        _close(logits, jlogits, name=f"decode {i} logits")
    _compare_cache(cache, jcache, tcfg)


PREFILL_CASES = [
    # (arch, prompt length, cache max_len)
    *[(a, 12, 32) for a in DENSE],
    ("gemma3-12b", 80, 96),  # past the 64-token window: the ring buffer wraps
]


@pytest.mark.parametrize("arch,T,L", PREFILL_CASES, ids=[f"{a}-T{t}" for a, t, _ in PREFILL_CASES])
def test_prefill_and_decode_match_reference(arch, T, L):
    _prefill_and_decode(*_cfgs(arch), T, L)


FULL_VARIANTS = [("gemma3-12b", 40, 48), ("qwen2.5-14b", 12, 32)]


@pytest.mark.parametrize("arch,T,L", FULL_VARIANTS, ids=[a for a, _, _ in FULL_VARIANTS])
def test_full_config_features_match_reference(arch, T, L):
    """gemma3-12b's period-6 pattern (the bridge unstacks six layers a
    block), q_dim 128 != d_model 96 and rope_theta 1e6, 40 tokens past its
    16-token windows; qwen2.5-14b's QKV bias with GQA 10 over 2 at rope_theta
    1e6, q_dim 160 != d_model 80."""
    jcfg, tcfg = _full_variant(arch)
    assert tcfg.q_dim != tcfg.d_model and tcfg.rope_theta == 1e6
    _prefill_and_decode(jcfg, tcfg, T, L, seed=1)


def _batch(cfg, B=4, T=16, seed=0):
    rng = np.random.default_rng(seed)
    tokens, labels = rng.integers(0, cfg.vocab_size, (B, T)), rng.integers(0, cfg.vocab_size, (B, T))
    return (
        {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)},
        {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)},
    )


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=2)
    jb, tb = _batch(tcfg, T=80 if arch == "gemma3-12b" else 16)  # gemma3: past the window
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


def _recording(opt, seen: list):
    def update(params, grads, state):
        seen.append(grads)
        return opt.update(params, grads, state)

    return dataclasses.replace(opt, update=update)


@pytest.mark.parametrize("arch", DENSE)
def test_train_step_matches_reference(arch):
    """One AdamW step over M = 2 micro-batches: the loss, the clip norm, the
    learning rate and the averaged gradients handed to the optimizer."""
    jcfg, tcfg = _cfgs(arch)
    jparams, params = _bridged(jcfg, tcfg, seed=4)
    spec = get_arch(arch)
    jseen, seen = [], []
    jopt = _recording(jax_make_optimizer(spec.optimizer, jax_schedules.linear_warmup_cosine(1e-3, 0, 4)), jseen)
    opt = _recording(make_optimizer(spec.optimizer, schedules.linear_warmup_cosine(1e-3, 0, 4)), seen)
    jstep = jax_make_train_step(lambda p, b: jax_api.loss_fn(p, jcfg, b), jopt, num_microbatches=2)
    step = make_train_step(lambda p, b: api.loss_fn(p, tcfg, b), opt, num_microbatches=2)
    jb, tb = _batch(tcfg, seed=6)
    jstate, jm = jstep(jax_create_train_state(jparams, jopt), jb)
    state, m = step(create_train_state(params, opt), tb)
    _close(m["loss"], jm["loss"], name="loss")
    _close(m["grad_norm"], jm["grad_norm"], name="grad_norm")
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    got, want = bridge.params_to_repro(seen[0], tcfg), _flat(jseen[0])
    assert sorted(got) == sorted(want)
    for key in want:
        _close(torch.from_numpy(got[key]), want[key], name=key)
    assert state.step == int(jstate.step) == 1


STEPPING_CASES = [("qwen2.5-14b", 6, 10), ("gemma3-12b", 6, 10), ("gemma3-12b", 80, 96)]


@pytest.mark.parametrize("arch,P,L", STEPPING_CASES, ids=[f"{a}-P{p}" for a, p, _ in STEPPING_CASES])
def test_prefill_with_cache_matches_token_stepping(arch, P, L):
    """``repro``'s ``tests/test_serve.py`` claim, held on the port (bf16, its
    own weights) where ``repro``'s own test passes: the fused prefill leaves
    the logits and the cache that P decode steps leave, bitwise, and the
    next step from both agrees (gemma3 also 80 tokens past its window)."""
    cfg = get_arch(arch).smoke
    B = 2
    params = api.init_params(cfg, seed=0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, P)))
    cache = api.init_cache(cfg, B, L, device="cpu")
    logits, cache = api.prefill_with_cache(params, cfg, cache, {"tokens": prompts})
    ref = api.init_cache(cfg, B, L, device="cpu")
    for i in range(P):
        ref_logits, ref = api.decode_fn(params, cfg, ref, i, {"tokens": prompts[:, i : i + 1]})
    assert torch.equal(logits, ref_logits)
    for a, b in zip(cache["layers"], ref["layers"]):
        assert torch.equal(a["kv"]["k"], b["kv"]["k"]) and torch.equal(a["kv"]["v"], b["kv"]["v"])
    tok = logits[:, -1].argmax(-1, keepdim=True)
    nl, _ = api.decode_fn(params, cfg, cache, P, {"tokens": tok})
    rl, _ = api.decode_fn(params, cfg, ref, P, {"tokens": tok})
    assert torch.equal(nl, rl)
