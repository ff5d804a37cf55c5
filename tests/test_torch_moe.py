"""The port's MoE layer and Adafactor against ``repro`` on the CPU.

``moe_apply`` on the smoke configs' MoE shapes in fp32, on ``repro``'s
weights: softmax top-2 (jamba), sigmoid top-2 with a shared expert (kimi),
top-1 with a shared expert (llama4), a case with capacity drops
(``capacity_factor`` 0.5), each checking y and every aux term, and the
gradients against ``jax.grad``.  The per-group dispatch
(``moe_apply_grouped``) against ``jax.vmap`` of ``repro``'s ``moe_apply``
over the groups and against ``repro``'s own ``moe_apply_grouped``.
Adafactor over 3 steps on leaves of rank 1, 2 and 3 against
``adafactor_update``, its state shapes, and its stacked layout against
``repro``'s stacked leaves.  All at 1e-4 relative to the largest entry
(the two frameworks sum products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import moe as jax_moe
from repro.optim.adafactor import adafactor_init as jax_adafactor_init
from repro.optim.adafactor import adafactor_update as jax_adafactor_update
from repro_torch.configs import get_arch
from repro_torch.models import moe
from repro_torch.optim import adafactor_init, adafactor_update
from repro_torch.tree import flatten

TOL = 1e-4
T = 24


def _close(got, want, tol=TOL, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


CASES = {
    # (arch whose smoke config gives the MoE shape, config overrides)
    "softmax_top2": ("jamba-v0.1-52b", {}),
    "sigmoid_top2_shared": ("kimi-k2-1t-a32b", {}),
    "top1_shared": ("llama4-maverick-400b-a17b", {}),
    "capacity_drops": ("jamba-v0.1-52b", {"capacity_factor": 0.5}),
}


def _setup(case, seed=0):
    arch, kw = CASES[case]
    jcfg = jax_get_arch(arch).smoke.replace(dtype=jnp.float32, **kw)
    tcfg = get_arch(arch).smoke.replace(dtype=torch.float32, **kw)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, _to_torch(jp), x


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    jcfg, tcfg, jp, p, x = _setup(case)
    jy, jaux = jax_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), tcfg)
    _close(y, jy, name="y")
    for key in ("load_balance", "router_z", "dropped_frac"):
        _close(aux[key], jaux[key], name=key)
    if case == "capacity_drops":
        assert float(jaux["dropped_frac"]) > 0.1
    else:
        assert float(jaux["dropped_frac"]) < float(CASES["capacity_drops"][1]["capacity_factor"])
    assert ("shared" in p) == bool(tcfg.n_shared_experts)


@pytest.mark.parametrize("case", ["sigmoid_top2_shared", "capacity_drops"])
def test_moe_gradients_match_reference(case):
    """d(sum(y * r) + load_balance + router_z) over x and every weight."""
    jcfg, tcfg, jp, p, x = _setup(case, seed=1)
    r = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jax_moe.moe_apply(params, xx, jcfg)
        return jnp.sum(y * r) + aux["load_balance"] + aux["router_z"]

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: t.requires_grad_(True) for k, t in flatten(p).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    tree = _to_torch(jp)
    for k, t in flatten(tree).items():  # rebuild the tree on the leaves that take gradients
        node = tree
        *head, last = k.split("/")
        for part in head:
            node = node[part]
        node[last] = leaves[k]
    y, aux = moe.moe_apply(tree, xt, tcfg)
    loss = (y * torch.from_numpy(r)).sum() + aux["load_balance"] + aux["router_z"]
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    _close(grads[0], jgx, name="x")
    jflat = flatten(_to_torch(jgp))
    for (key, _), g in zip(leaves.items(), grads[1:]):
        _close(g, jflat[key].numpy(), name=key)


@pytest.mark.parametrize("case", ["softmax_top2", "top1_shared"])
def test_grouped_dispatch_matches_vmap_of_reference(case):
    """Each of G groups routed on its own: ``repro``'s ``moe_apply`` under
    ``jax.vmap`` over the groups (the engine's per-slot decode), at S = 1 as
    the serve engine calls it and at S = 6, where softmax top-2 drops an
    entry (and top-1 too).  Where no entry drops, also ``repro``'s ``moe_apply_grouped`` (y
    and the aux terms over all tokens).  Where one drops, ``repro``'s
    grouped form differs from its flat one: its ``slots_one`` writes each
    dropped entry's token to slot (0, 0) with ``.set``, which takes expert
    0's first kept token out (ROADMAP.md queue 3); the port follows the
    flat form."""
    jcfg, tcfg, jp, p, _ = _setup(case, seed=3)
    for G, S_ in ((2, 1), (4, 1), (3, 6)):
        x = np.random.default_rng(G * 10 + S_).standard_normal((G, S_, jcfg.d_model)).astype(np.float32)
        jy, jaux = jax.vmap(lambda xg: jax_moe.moe_apply(jp, xg, jcfg))(jnp.asarray(x))
        y, aux = moe.moe_apply_grouped(p, torch.from_numpy(x), tcfg)
        _close(y, jy, name=f"vmap G={G} S={S_}")
        _close(aux["dropped_frac"], np.mean(np.asarray(jaux["dropped_frac"])), name="dropped_frac")
        if float(aux["dropped_frac"]) > 0:
            assert S_ == 6
            continue
        gy, gaux = jax_moe.moe_apply_grouped(jp, jnp.asarray(x), jcfg)
        _close(y, gy, name=f"grouped G={G} S={S_}")
        for key in ("load_balance", "router_z", "dropped_frac"):
            _close(aux[key], gaux[key], name=key)


def test_one_token_groups_never_drop_where_a_shared_capacity_does():
    """Two rows that pick the same expert at top-1: routed as one group of
    2 tokens (C = 1 at E = 4) one is dropped; as two groups of 1, neither."""
    _, tcfg, _, p, _ = _setup("top1_shared")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, tcfg.d_model)).astype(np.float32))
    rows = torch.cat([x, x])[:, None]  # [G=2, S=1, d], one expert for both
    _, flat = moe.moe_apply(p, rows[:, 0], tcfg)
    _, grouped = moe.moe_apply_grouped(p, rows, tcfg)
    assert float(flat["dropped_frac"]) == 0.5
    assert float(grouped["dropped_frac"]) == 0.0


# -- Adafactor ---------------------------------------------------------------------


def _adafactor_tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"bias": (12,), "w": (12, 20), "experts": {"gate": (4, 12, 20)}}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)

    return draw(shapes)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_three_steps_match_reference(weight_decay):
    """Leaves of rank 1 (the full second moment), 2 and 3 (an expert bank:
    row and column statistics per expert), 3 steps of decaying beta2 at
    lr 1e-2 with RMS clipping, against ``repro``'s ``adafactor_update``."""
    p0 = _adafactor_tree(0)
    jparams = jax.tree_util.tree_map(jnp.asarray, p0)
    params = _to_torch(p0)
    jstate, state = jax_adafactor_init(jparams), adafactor_init(params)
    want_row = {k: np.asarray(v).shape for k, v in flatten(_to_torch(jstate.v_row)).items()}
    want_col = {k: np.asarray(v).shape for k, v in flatten(_to_torch(jstate.v_col)).items()}
    assert {k: tuple(v.shape) for k, v in state.v_row.items()} == want_row
    assert {k: tuple(v.shape) for k, v in state.v_col.items()} == want_col
    assert want_row == {"bias": (12,), "w": (12,), "experts/gate": (4, 12)}
    assert want_col == {"bias": (), "w": (20,), "experts/gate": (4, 20)}
    for step in range(3):
        g = _adafactor_tree(10 + step)
        jparams, jstate = jax_adafactor_update(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate, 1e-2, weight_decay=weight_decay
        )
        params, state = adafactor_update(params, _to_torch(g), state, 1e-2, weight_decay=weight_decay)
    assert state.step == int(jstate.step) == 3
    jflat = flatten(_to_torch(jparams))
    for key, t in flatten(params).items():
        _close(t, jflat[key].numpy(), name=key)
    for ours, theirs in ((state.v_row, jstate.v_row), (state.v_col, jstate.v_col)):
        for key, t in flatten(_to_torch(theirs)).items():
            _close(ours[key], t.numpy(), name=key)


def test_adafactor_layout_matches_reference_stacked_leaves():
    """Per-layer leaves grouped by a layout into the reference's stacks
    (a norm scale of two blocks is a [2, d] leaf there, factored; an expert
    bank of one block [1, E, d, ff]): the port's update of the unstacked
    leaves equals ``repro``'s of the stacked ones, and its state is
    ``repro``'s state under the reference's paths."""
    rng = np.random.default_rng(7)
    scales = [rng.standard_normal(12).astype(np.float32) for _ in range(2)]
    bank = rng.standard_normal((4, 12, 20)).astype(np.float32)
    table = rng.standard_normal((16, 12)).astype(np.float32)
    params = {"embed": {"table": torch.from_numpy(table.copy())},
              "layers": [{"ln1": {"scale": torch.from_numpy(s.copy())}} for s in scales]
              + [{"moe": {"experts": {"gate": torch.from_numpy(bank.copy())}}}]}
    layout = [
        ("embed/table", ["embed/table"], False),
        ("blocks/0/ln1/scale", ["layers/0/ln1/scale", "layers/1/ln1/scale"], True),
        ("blocks/1/moe/experts/gate", ["layers/2/moe/experts/gate"], True),
    ]
    jparams = {"embed/table": jnp.asarray(table), "blocks/0/ln1/scale": jnp.asarray(np.stack(scales)),
               "blocks/1/moe/experts/gate": jnp.asarray(bank[None])}
    jstate, state = jax_adafactor_init(jparams), adafactor_init(params, layout)
    for step in range(3):
        gs = [rng.standard_normal(12).astype(np.float32) for _ in range(2)]
        gb = rng.standard_normal((4, 12, 20)).astype(np.float32)
        gt = rng.standard_normal((16, 12)).astype(np.float32)
        grads = {"embed": {"table": torch.from_numpy(gt)},
                 "layers": [{"ln1": {"scale": torch.from_numpy(g)}} for g in gs]
                 + [{"moe": {"experts": {"gate": torch.from_numpy(gb)}}}]}
        jgrads = {"embed/table": jnp.asarray(gt), "blocks/0/ln1/scale": jnp.asarray(np.stack(gs)),
                  "blocks/1/moe/experts/gate": jnp.asarray(gb[None])}
        jparams, jstate = jax_adafactor_update(jparams, jgrads, jstate, 3e-2)
        params, state = adafactor_update(params, grads, state, 3e-2, layout=layout)
    _close(params["embed"]["table"], jparams["embed/table"], name="table")
    for i in range(2):
        _close(params["layers"][i]["ln1"]["scale"], np.asarray(jparams["blocks/0/ln1/scale"])[i], name=f"scale {i}")
    _close(params["layers"][2]["moe"]["experts"]["gate"], np.asarray(jparams["blocks/1/moe/experts/gate"])[0])
    for name, _, _ in layout:
        _close(state.v_row[name], jstate.v_row[name], name=name)
        _close(state.v_col[name], jstate.v_col[name], name=name)
    assert tuple(state.v_row["blocks/0/ln1/scale"].shape) == (2,)  # factored over the stack
