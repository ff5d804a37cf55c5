"""The port's checkpoints (``checkpoint/io.py``) and ``train.py``'s
``--ckpt-dir`` / ``--ckpt-every`` against ``repro``'s.

A save and load round trip is bitwise, bf16 leaves included (stored as
their 16 bits); training 3 steps, resuming from the step-3 checkpoint and
training 3 more gives the losses and the parameters of 6 straight steps,
bitwise (the CPU's arithmetic is deterministic); an ``arrays.npz`` of
parameters written by ``repro``'s ``save_checkpoint`` loads into the port
through ``bridge.params_from_repro``, bitwise.
"""

import argparse
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.checkpoint.io import _path_str
from repro.configs import get_arch as jax_get_arch
from repro.models import api as jax_api
from repro_torch import bridge
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.training import create_train_state
from repro_torch.tree import flatten, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work: the suite's other
    workers share the CPU, and spinning thread pools oversubscribe it.
    Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_trees(got, want):
    fg, fw = flatten(got), flatten(want)
    assert list(fg) == list(fw)
    for key in fw:
        assert fg[key].dtype == fw[key].dtype and torch.equal(fg[key], fw[key]), key


@pytest.mark.parametrize("arch,optimizer", [("seamless-m4t-medium", "adamw"), ("kimi-k2-1t-a32b", "adafactor")])
def test_round_trip_is_bitwise(tmp_path, arch, optimizer):
    """A training state (the optimizer's state after one update, so that
    nothing is zero) saved and loaded into a fresh state of the same
    structure, and a bf16 tree."""
    cfg = get_arch(arch).smoke
    params = api.init_params(cfg, seed=1, device="cpu")
    opt = make_optimizer(optimizer, layout=tf.reference_layout(cfg, params))
    state = create_train_state(params, opt)
    torch.manual_seed(0)
    grads = tree_map(torch.randn_like, params)
    state.params, state.opt_state, _ = opt.update(state.params, grads, state.opt_state)
    state.step = 7
    path = save_checkpoint(str(tmp_path), 7, state)
    meta = json.loads((tmp_path / "step_7" / "tree.json").read_text())
    assert meta["step"] == 7 and meta["keys"][0] == "step" and path.endswith("step_7")
    fresh = create_train_state(api.init_params(cfg, seed=2, device="cpu"), opt)
    loaded = load_checkpoint(str(tmp_path), 7, fresh)
    assert loaded.step == 7 and loaded.opt_state.step == state.opt_state.step == 1
    _equal_trees(loaded.params, state.params)
    for field in ("m", "v") if optimizer == "adamw" else ("v_row", "v_col"):
        _equal_trees(getattr(loaded.opt_state, field), getattr(state.opt_state, field))
    bf16 = api.cast_for_serving(params, cfg)
    save_checkpoint(str(tmp_path), 9, {"params": bf16, "note": None})
    assert json.loads((tmp_path / "step_9" / "tree.json").read_text())["dtypes"]["params/embed/table"] == "bfloat16"
    like = {"params": api.cast_for_serving(api.init_params(cfg, seed=3, device="cpu"), cfg), "note": None}
    _equal_trees(load_checkpoint(str(tmp_path), 9, like)["params"], bf16)
    assert latest_step(str(tmp_path)) == 9 and latest_step(str(tmp_path / "none")) is None
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(str(tmp_path), 9, {"params": bf16, "extra": torch.zeros(1)})


def _args(**kw):
    base = dict(
        arch="seamless-m4t-medium", smoke=True, steps=6, batch=2, seq=16, microbatches=2, lr=3e-3, warmup=1,
        seed=0, log_every=10, device="cpu", profile=False, ckpt_dir=None, ckpt_every=0,
    )
    return argparse.Namespace(**{**base, **kw})


def test_resume_equals_a_straight_run(tmp_path):
    """6 straight steps through ``train.main`` (``--ckpt-every 3``), then a
    run that finds only the step-3 checkpoint: it resumes there, and its 3
    steps give the straight run's last 3 losses and its final parameters and
    moments, bitwise, and return the state it saved."""
    straight, resumed = tmp_path / "straight", tmp_path / "resumed"
    out = tmp_path / "train.json"
    rc = train.main([
        "--arch", "seamless-m4t-medium", "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
        "--seq", "16", "--microbatches", "2", "--lr", "3e-3", "--warmup", "1", "--ckpt-dir", str(straight),
        "--ckpt-every", "3", "--out", str(out),
    ])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["resumed_from"] is None and len(s["losses"]) == 6
    assert sorted(p.name for p in straight.iterdir()) == ["step_3", "step_6"]
    shutil.copytree(straight / "step_3", resumed / "step_3")
    r, state = train.train(_args(ckpt_dir=str(resumed)))
    assert r["resumed_from"] == 3 and r["losses"] == s["losses"][3:]
    assert latest_step(str(resumed)) == 6
    cfg = get_arch("seamless-m4t-medium").smoke
    like = create_train_state(api.init_params(cfg, seed=5, device="cpu"), make_optimizer("adamw"))
    a, b = load_checkpoint(str(straight), 6, like), load_checkpoint(str(resumed), 6, like)
    assert a.step == b.step == 6
    _equal_trees(b.params, a.params)
    _equal_trees(b.opt_state.m, a.opt_state.m)
    _equal_trees(b.opt_state.v, a.opt_state.v)
    assert state.step == 6
    _equal_trees(state.params, a.params)


@pytest.mark.parametrize("steps", [6, 4])
def test_rerun_of_a_finished_run_takes_no_step(tmp_path, steps, capsys):
    """A run whose checkpoint directory already holds step 6 (a finished
    6-step run), run again with ``--steps`` 6 or 4: it resumes at step 6,
    takes no step, reports no losses or step times, saves nothing and
    exits 0."""
    ckpt = tmp_path / "ck"
    assert train.main([
        "--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
        "--lr", "3e-3", "--warmup", "1", "--ckpt-dir", str(ckpt),
    ]) == 0
    saved = (ckpt / "step_6" / "arrays.npz").read_bytes()
    out = tmp_path / "rerun.json"
    assert train.main([
        "--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--steps", str(steps), "--batch", "2",
        "--seq", "16", "--lr", "3e-3", "--warmup", "1", "--ckpt-dir", str(ckpt), "--out", str(out),
    ]) == 0
    r = json.loads(out.read_text())
    assert r["resumed_from"] == 6 and r["losses"] == [] and r["step_ms"] == []
    assert r["step_ms_p50"] is None and r["tokens_per_second"] is None
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_6"]
    assert (ckpt / "step_6" / "arrays.npz").read_bytes() == saved
    assert f"nothing to train: resumed at step 6 of --steps {steps}" in capsys.readouterr().out


def _jax_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.asarray(x) for p, x in leaves}


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-2b"])
def test_reference_params_checkpoint_loads_through_the_bridge(tmp_path, arch):
    """``repro``'s ``save_checkpoint`` of its parameters (stacked blocks for
    qwen2-vl, lists for seamless): its ``arrays.npz`` through
    ``params_from_repro`` is the bridged tree, bitwise; the port's own save
    of the bridged tree's ``params_to_repro`` keeps ``repro``'s keys."""
    jcfg, cfg = jax_get_arch(arch).smoke, get_arch(arch).smoke
    jparams = jax_api.init_params(jax.random.PRNGKey(4), jcfg)
    jax_save_checkpoint(str(tmp_path / "jax"), 0, jparams)
    with np.load(tmp_path / "jax" / "step_0" / "arrays.npz") as data:
        flat = {k: data[k] for k in data.files}
    got = bridge.params_from_repro(flat, cfg, device="cpu")
    _equal_trees(got, bridge.params_from_repro(_jax_flat(jparams), cfg, device="cpu"))
    save_checkpoint(str(tmp_path / "port"), 0, bridge.params_to_repro(got, cfg))
    keys = json.loads((tmp_path / "port" / "step_0" / "tree.json").read_text())["keys"]
    assert sorted(keys) == sorted(json.loads((tmp_path / "jax" / "step_0" / "tree.json").read_text())["keys"])
