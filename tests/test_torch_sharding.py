"""The port's sharding rules (``repro_torch.distributed.sharding``) against
``repro``'s, and the shard helpers.

The rules read only a mesh's ``axis_names`` and ``shape``, so fake meshes
stand in for ``repro``'s (``tests/test_sharding.py``'s ``_FakeMesh``): (1, 1),
(2, 2), (4, 1), the production (16, 16) and (2, 16, 16).  For every arch of
the registry, smoke and full configs (the full ones as shapes only, drawn
under ``FakeTensorMode``), each port leaf's spec is ``repro``'s ``_spec_for``
on the port's own path (``layers/<i>/...``) and per-layer shape, with
``fsdp`` on and off; ``zero3_param_pspecs``, ``batch_shardings`` (M-RoPE
positions included) and ``cache_shardings`` likewise.  The twins of
``tests/test_sharding.py``'s ten tests run on the port, and the stacked-dim
layout difference from ``repro``'s ``blocks/`` tree is asserted as recorded
(ROADMAP.md queue 3).  The shard helpers gather and reduce-scatter on four
gloo ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.distributed.sharding as jsh
import repro.distributed.spmd as jspmd
from repro.configs import get_arch as jax_get_arch
from repro.configs.io import input_specs as jax_input_specs
from repro.models import api as jax_api
from repro.models import transformer as jax_tf
from repro_torch.configs import ALL_ARCH_IDS, INPUT_SHAPES, get_arch
from repro_torch.configs.io import input_specs
from repro_torch.distributed import rank_checks
from repro_torch.distributed.sharding import (
    PartitionSpec as P,
    _spec_for,
    batch_shardings,
    cache_shardings,
    local_shape,
    local_shard,
    param_pspecs,
    zero3_param_pspecs,
)
from repro_torch.distributed.spmd import _state_shardings, state_specs_for
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.models.common import check_servable
from repro_torch.optim import make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.tree import flatten


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite's other
    workers share the CPU, and spinning thread pools oversubscribe it.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeMesh:
    """Duck-typed mesh: just axis_names + shape (rules only read those)."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "4x1": {"data": 4, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
MESH = _FakeMesh(MESHES["16x16"])
MESH3 = _FakeMesh(MESHES["2x16x16"])


@functools.lru_cache
def _param_shapes(arch: str, full: bool) -> dict:
    """The port's ``{path: shape}`` of an arch's smoke or full config."""
    spec = get_arch(arch)
    cfg = spec.model if full else spec.smoke
    return {k: tuple(t.shape) for k, t in flatten(state_specs_for(cfg, make_optimizer()).params).items()}


def _as_spec(fn, *args):
    """Run one of ``repro``'s sharding functions against a fake mesh, its NamedSharding
    (in the rules' module and the step's) swapped for a spec-carrying stub
    (``tests/test_sharding.py``'s way)."""

    class Stub:
        def __init__(self, mesh, spec):
            self.spec = spec

    orig = jsh.NamedSharding
    jsh.NamedSharding = jspmd.NamedSharding = Stub
    try:
        return fn(*args)
    finally:
        jsh.NamedSharding = jspmd.NamedSharding = orig


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_param_and_zero3_specs_equal_repro_rules_on_port_leaves(arch, full):
    shapes = _param_shapes(arch, full)
    tree = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    for name, axes in MESHES.items():
        mesh = _FakeMesh(axes)
        for fsdp in (True, False):
            got = param_pspecs(meta, mesh, fsdp=fsdp)
            for k, s in shapes.items():
                assert got[k] == jsh._spec_for(k, s, mesh, fsdp=fsdp), (name, fsdp, k, s)
        got = zero3_param_pspecs(meta, mesh)
        want = jsh.zero3_param_pspecs(tree, mesh)
        for k in shapes:
            assert got[k] == want[k], (name, k)


@pytest.mark.parametrize("arch", ALL_ARCH_IDS)
def test_batch_and_cache_specs_equal_repro(arch):
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    for name, axes in MESHES.items():
        mesh = _FakeMesh(axes)
        for shape in INPUT_SHAPES:
            for reduced in (True, False):
                got = batch_shardings(input_specs(spec, shape, reduced=reduced), mesh)
                want = _as_spec(jsh.batch_shardings, jax_input_specs(jspec, shape, reduced=reduced), mesh)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].spec == want[k].spec, (name, shape, reduced, k)
        for cfg in (spec.smoke, spec.model):
            try:
                check_servable(cfg)
            except NotImplementedError:
                continue
            for B, L in ((2, 64), (1, 4096)):
                cache = flatten(api.init_cache(cfg, B, L, device="meta"))
                got = flatten(cache_shardings(api.init_cache(cfg, B, L, device="meta"), mesh))
                want = _as_spec(jsh.cache_shardings, {k: jax.ShapeDtypeStruct(t.shape, jnp.float32)
                                                      for k, t in cache.items()}, mesh)
                for k in cache:
                    assert got[k].spec == want[k].spec, (name, cfg.name, B, L, k)


def test_spec_twin_compares_as_jax_does():
    assert P(("data",)) == P("data") == JP(("data",)) and P() != P(None)
    assert P(None, "model") != P(None, "model", None)
    assert P(("data", "model"), None) == JP(("data", "model"), None)


def test_production_and_local_meshes():
    assert make_production_mesh().shape == MESHES["16x16"]
    assert make_production_mesh(multi_pod=True).shape == MESHES["2x16x16"]
    mesh = make_local_mesh(2, 2)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.coords == (0, 0) and mesh.group is None


def test_adafactor_stat_shardings_equal_repro():
    """kimi-k2 smoke's Adafactor statistics: each group's v_row and v_col
    spec, under both strategies, equal ``repro``'s ``_state_shardings`` and its
    zero3 ``like`` on the reference's stacked tree."""
    from repro.optim import make_optimizer as jax_make_optimizer
    from repro.training import create_train_state as jax_create_train_state
    from repro_torch.models.transformer import reference_layout

    cfg, jcfg = get_arch("kimi-k2-1t-a32b").smoke, jax_get_arch("kimi-k2-1t-a32b").smoke
    meta = state_specs_for(cfg, make_optimizer()).params
    specs = state_specs_for(cfg, make_optimizer("adafactor", layout=reference_layout(cfg, meta)))
    jopt = jax_make_optimizer("adafactor")
    jspecs = jax.eval_shape(lambda: jax_create_train_state(jax_api.init_params(jax.random.PRNGKey(0), jcfg), jopt))
    for name, axes in MESHES.items():
        mesh = _FakeMesh(axes)
        got = _state_shardings(specs, mesh)
        want = _as_spec(jspmd._state_shardings, jspecs, mesh)
        for which in ("v_row", "v_col"):
            flat_want = {jsh._path_str(p): s.spec for p, s in
                         jax.tree_util.tree_flatten_with_path(getattr(want.opt_state, which),
                                                              is_leaf=lambda x: hasattr(x, "spec"))[0]}
            for group, s in getattr(got.opt_state, which).items():
                assert s.spec == flat_want[group], (name, which, group)
        z = _state_shardings(specs, mesh, "zero3")
        for group, s in z.opt_state.v_row.items():
            vr = specs.opt_state.v_row[group]
            full = tuple(vr.shape) if specs.opt_state.v_col[group].ndim == 0 else (
                *vr.shape, specs.opt_state.v_col[group].shape[-1])
            ps = jsh.zero3_param_pspecs({"x": jax.ShapeDtypeStruct(full, jnp.float32)}, mesh)["x"]
            assert s.spec == (JP(*ps[: vr.ndim]) if len(ps) > vr.ndim else ps), (name, group)


def test_stacked_dim_layout_difference_is_recorded():
    """``repro`` keys the stacked block dim on ``blocks/``, and two rules fall
    on it; the port's per-layer leaves take the 1-D rule (ROADMAP.md queue 3,
    a layout note: the math is unchanged)."""
    mesh = _FakeMesh(MESHES["2x2"])
    jcfg = jax_get_arch("qwen2.5-14b").smoke
    stacked = {jsh._path_str(p): tuple(x.shape) for p, x in jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jax_api.init_params(jax.random.PRNGKey(0), jcfg)))[0]}
    assert stacked["blocks/0/attn/wq/b"] == (2, 256) and stacked["blocks/0/ln1/scale"] == (2, 256)
    assert jsh._spec_for("blocks/0/attn/wq/b", (2, 256), mesh) == JP("data", "model")
    assert jsh._spec_for("blocks/0/ln1/scale", (2, 256), mesh) == JP(None, "model")
    shapes = _param_shapes("qwen2.5-14b", False)
    assert shapes["layers/0/attn/wq/b"] == (256,) and shapes["layers/0/ln1/scale"] == (256,)
    specs = param_pspecs({k: torch.empty(s, device="meta") for k, s in shapes.items()}, mesh)
    assert specs["layers/0/attn/wq/b"] == P("model") and specs["layers/0/ln1/scale"] == P()
    assert jax_tf.structure(jcfg).n_blocks == 2


def test_local_shape_and_shard_at_every_coordinate():
    """A dim over two axes is chunked in mesh-axis order: the chunks of all
    four coordinates tile the leaf."""
    full = torch.arange(8 * 6).reshape(8, 6)
    for spec in (P(("data", "model"), None), P("data", "model"), P(None, "model")):
        chunks = {}
        for d in range(2):
            for m in range(2):
                mesh = Mesh(("data", "model"), (2, 2), (d, m))
                x = local_shard(full, spec, mesh)
                assert tuple(x.shape) == local_shape((8, 6), spec, mesh)
                chunks[(d, m)] = x
        if spec == P(("data", "model"), None):
            torch.testing.assert_close(torch.cat([chunks[(0, 0)], chunks[(0, 1)], chunks[(1, 0)], chunks[(1, 1)]]), full)
        if spec == P("data", "model"):
            top = torch.cat([chunks[(0, 0)], chunks[(0, 1)]], dim=1)
            bottom = torch.cat([chunks[(1, 0)], chunks[(1, 1)]], dim=1)
            torch.testing.assert_close(torch.cat([top, bottom]), full)
    with pytest.raises(ValueError):
        local_shape((6, 6), P(("data", "model")), make_local_mesh(2, 2))


ROUND_TRIPS = [
    ((8, 6), P("data")), ((8, 6), P(None, "model")), ((8, 6), P(("data", "model"), None)),
    ((8, 4), P("data", "model")), ((2, 8, 4), P(None, None, ("data", "model"))), ((5,), P()),
]


@pytest.fixture(scope="module")
def round_trips():
    """Every case whole, then in pieces of 32 bytes (several a leaf)."""
    return [ranks.spawn(rank_checks.shard_round_trips, 4, args=(ROUND_TRIPS, piece), device="cpu", timeout=300,
                        axes={"data": 2, "model": 2}) for piece in (None, 32)]


@pytest.mark.parametrize("pieces", [False, True], ids=["whole", "pieces"])
@pytest.mark.parametrize("i", range(len(ROUND_TRIPS)), ids=[f"{s}-{p}" for s, p in ROUND_TRIPS])
def test_gather_and_reduce_scatter_round_trip(round_trips, i, pieces):
    """On four gloo ranks, a (2, 2) mesh: every rank's shard gathers back to
    the full leaf, and a reduce-scatter sums over the spec's axes only."""
    got = round_trips[pieces]
    assert all(r[i] == (True, True) for r in got), [r[i] for r in got]


# -- twins of tests/test_sharding.py -------------------------------------------------


def test_col_row_split_intent():
    assert _spec_for("blocks/0/attn/wq/w", (40, 5120, 5120), MESH) == P(None, ("data",), "model")
    assert _spec_for("attn/wq/w", (5120, 5120), MESH) == P(("data",), "model")
    assert _spec_for("attn/wo/w", (5120, 5120), MESH) == P("model", ("data",))
    assert _spec_for("attn/wq/w", (5120, 5120), MESH, fsdp=False) == P(None, "model")
    assert _spec_for("mlp/down/w", (13824, 5120), MESH, fsdp=False) == P("model", None)


def test_expert_2d_sharding_kept_for_serving():
    spec = _spec_for("moe/experts/gate", (384, 7168, 2048), MESH, fsdp=False)
    assert spec == P("model", ("data",), None)


def test_divisibility_guard_falls_back():
    spec = _spec_for("attn/wq/w", (30, 30), MESH)
    assert spec == P(None, None) or spec == P()


def test_embed_vocab_over_model():
    assert _spec_for("embed/table", (152064, 5120), MESH)[0] == "model"


def test_norms_replicated():
    assert _spec_for("ln1/scale", (5120,), MESH) == P()


def test_batch_shardings_divisible_and_not():
    specs = {"tokens": torch.empty(256, 4096, device="meta"), "mrope_positions": torch.empty(3, 256, 4096, device="meta")}
    out = {k: v.spec for k, v in batch_shardings(specs, MESH).items()}
    assert out["tokens"][0] in ("data", ("data",))
    assert out["mrope_positions"][0] is None
    out1 = {k: v.spec for k, v in batch_shardings({"tokens": torch.empty(1, 524288, device="meta")}, MESH).items()}
    assert out1["tokens"] == P(None, "model")


def test_cache_shardings_seq_over_model():
    cache = {"blocks": {"kv": {
        "k": torch.empty(4, 128, 32768, 8, 128, device="meta"),
        "v": torch.empty(4, 128, 32768, 8, 128, device="meta"),
    }}}
    spec = cache_shardings(cache, MESH)["blocks"]["kv"]["k"].spec
    assert spec[1] in ("data", ("data",))
    assert spec[2] == "model"


def test_zero3_flat_shards_largest_dim():
    params = {"w": torch.zeros(512, 256), "odd": torch.zeros(30, 34), "b": torch.zeros(64)}
    specs = zero3_param_pspecs(params, MESH)
    assert specs["w"] == P(("data", "model"), None)
    assert specs["odd"] == P()
    assert specs["b"] == P()


def test_zero3_multipod_uses_all_axes():
    specs = zero3_param_pspecs({"w": torch.zeros(1024, 8)}, MESH3)
    assert specs["w"] == P(("pod", "data", "model"), None)


def test_param_pspecs_every_leaf_assigned():
    shapes = _param_shapes("jamba-v0.1-52b", False)
    specs = param_pspecs({k: torch.empty(s, device="meta") for k, s in shapes.items()}, MESH)
    assert sorted(specs) == sorted(shapes)
    for k, s in specs.items():
        for dim, axis in zip(shapes[k], tuple(s) + (None,) * 8):
            if axis is None:
                continue
            n = int(np.prod([MESH.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
            assert dim % n == 0, (shapes[k], s)
