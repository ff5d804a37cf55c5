"""The port stands alone: no JAX and nothing of ``repro``, and its entry
points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.gpt import GPT_CONFIGS
from repro_torch.data import SyntheticTextDataset
from repro_torch.launch import dryrun_pipeline, fabric_worker, serve_adaptive, serve_decode, train, train_adaptive
from repro_torch.models import api
from repro_torch.serve import ServeEngine

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_PKG = os.path.join(_REPO, "src", "repro_torch")
SMALL = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2, head_dim=80, d_ff=320, vocab_size=512)


def _port_modules() -> list[str]:
    mods = []
    for root, _, files in os.walk(_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), os.path.join(_REPO, "src"))
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.flash_attention.ops" in mods and "repro_torch.kernels.ssd_scan.ops" in mods
    assert "repro_torch.launch.train" in mods and "repro_torch.launch.train_adaptive" in mods
    assert "repro_torch.runtime.executor" in mods and "repro_torch.obs.trace" in mods and len(mods) >= 85
    assert "repro_torch.serve.slo" in mods and "repro_torch.launch.serve_adaptive" in mods
    assert "repro_torch.pipeline.ranks" in mods and "repro_torch.pipeline.rank_checks" in mods
    for mod in ("core.devicespec", "core.calibrate", "launch.op_counts", "launch.dryrun_pipeline"):
        assert f"repro_torch.{mod}" in mods, mod
    fabric = ("messages", "protocols", "barrier", "coordinator", "transport", "worker")
    for mod in ("runtime.fabric", *(f"runtime.fabric.{m}" for m in fabric), "launch.fabric_worker"):
        assert f"repro_torch.{mod}" in mods, mod
    archs = ("qwen1_5_4b", "qwen2_5_14b", "internlm2_20b", "gemma3_12b", "mamba2_780m",
             "jamba_v0_1_52b", "kimi_k2_1t_a32b", "llama4_maverick_400b_a17b", "seamless_m4t_medium", "qwen2_vl_2b")
    for mod in ("configs.base", "configs.io", *(f"configs.{a}" for a in archs), "models.moe", "optim.adafactor",
                "checkpoint", "checkpoint.io"):
        assert f"repro_torch.{mod}" in mods, mod
    for mod in ("distributed", "distributed.sharding", "distributed.spmd", "distributed.rank_checks", "launch.mesh"):
        assert f"repro_torch.{mod}" in mods, mod
    for mod in ("launch.dryrun", "launch.hlo_analysis", "core.viz"):
        assert f"repro_torch.{mod}" in mods, mod
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v is not None]\n"
    )
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def _sources() -> list[str]:
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(_PKG):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def test_no_jax_or_repro_import_in_port_sources():
    offenders = []
    for path in _sources():
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{os.path.relpath(path, _REPO)}:{node.lineno}: {name}")
    assert not offenders, offenders


def test_entry_points_need_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, 4, max_slots=8, max_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main(["--tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_adaptive.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_adaptive.main(["--engine", "--tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_adaptive.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_adaptive.main(["--iterations", "1", "--backend", "spmd"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_adaptive.main(["--iterations", "1", "--fabric", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fabric_worker.main(["--connect", "127.0.0.1:1", "--host", "host0", "--host-index", "0"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticTextDataset(64, 8, 2).batch_at(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_pipeline.main(["--calibrate", "--config", "GPT-Medium"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma3-12b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main(["--config", "qwen2.5-14b", "--tiny", "--requests", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_serving_params(cfg)


def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path):
    """Alone in a directory (and, here, without a card) it exits non-zero
    and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(_REPO, "chip_smoke.py")).read())
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_sharded_step_needs_the_card_and_serving_is_not_ported():
    """``make_spmd_train_step``, ``make_spmd_prefill`` and
    ``make_spmd_serve_step`` on a one-process mesh default to the card;
    with ``device="cpu"`` the serving half (ported since its item of
    ROADMAP.md queue 1 was done) equals the one-process prefill and decode."""
    from repro_torch import distributed
    from repro_torch.launch.mesh import make_local_mesh

    cfg = GPT_CONFIGS["GPT-2.7B"].replace(**SMALL)
    specs = {"tokens": torch.empty(2, 8, device="meta"), "labels": torch.empty(2, 8, device="meta")}
    if not torch.cuda.is_available():
        for make in (distributed.make_spmd_train_step, distributed.make_spmd_prefill):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make(cfg, make_local_mesh(), specs)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.make_spmd_serve_step(cfg, make_local_mesh(), specs, 16)
    step, (state_specs, _) = distributed.make_spmd_train_step(cfg, make_local_mesh(), specs, device="cpu")
    assert state_specs.params["embed"]["table"].device.type == "meta"
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    prefill, (param_specs, _) = distributed.make_spmd_prefill(cfg, make_local_mesh(), {"tokens": tokens}, device="cpu")
    decode, _ = distributed.make_spmd_serve_step(cfg, make_local_mesh(), {"tokens": tokens[:, :1]}, 16, device="cpu")
    assert param_specs["embed"]["table"].device.type == "meta"
    params = prefill.init_params(0)
    want_params = api.init_serving_params(cfg, 0, "cpu")
    torch.testing.assert_close(prefill(params, {"tokens": tokens}), api.prefill_fn(want_params, cfg, {"tokens": tokens}),
                               rtol=0, atol=0)
    cache, want_cache = decode.init_cache(), api.init_cache(cfg, 2, 16, "cpu")
    got, _ = decode(params, cache, 0, {"tokens": tokens[:, :1]})
    want, _ = api.decode_fn(want_params, cfg, want_cache, 0, {"tokens": tokens[:, :1]})
    torch.testing.assert_close(got, want, rtol=0, atol=0)
