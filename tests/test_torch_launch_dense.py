"""The port's entry points on the dense archs of the registry, on the CPU.

``launch.train`` (``--mode spmd``) trains each dense arch's smoke config and
the loss falls; ``serve_decode --config <arch id> --tiny`` completes every
request; ``dryrun_pipeline --calibrate --config qwen1.5-4b`` counts the full
config on ``meta``, prices it on ``specs/h100-sxm.json`` and returns the
tuner's choice.  On the CPU no kernel launches.
"""

import argparse
import json

import numpy as np
import pytest

from repro_torch.configs.base import ALL_ARCH_IDS, get_arch
from repro_torch.launch import dryrun_pipeline, serve_adaptive, serve_decode, train

DENSE = ["qwen2.5-14b", "internlm2-20b", "gemma3-12b", "qwen1.5-4b"]


def test_launchers_take_every_ported_arch():
    for arch in ALL_ARCH_IDS:
        assert arch in serve_adaptive.CONFIG_NAMES
        assert serve_adaptive.build_config(arch, tiny=True) == get_arch(arch).smoke
        assert serve_adaptive.build_config(arch) == get_arch(arch).model
    assert serve_adaptive.build_config("gemma3-12b").head_dim == 256
    assert "GPT-2.7B" in serve_adaptive.CONFIG_NAMES
    assert serve_adaptive.build_config("GPT-2.7B", tiny=True).num_layers == 2
    # the encoder-decoder and vision-language archs build; serving them
    # raises repro's "serving does not support family"
    for arch, family in (("seamless-m4t-medium", "encdec"), ("qwen2-vl-2b", "vlm")):
        with pytest.raises(NotImplementedError, match=f"serving does not support family '{family}'"):
            serve_decode.main(["--config", arch, "--tiny", "--device", "cpu", "--requests", "2", "--prompt-len", "4", "8",
                               "--new-tokens", "2", "3", "--max-len", "16"])


@pytest.mark.parametrize("arch", DENSE)
def test_train_launcher_trains_the_dense_smoke_configs(arch, tmp_path):
    out = tmp_path / "train.json"
    rc = train.main([
        "--arch", arch, "--smoke", "--device", "cpu", "--steps", "10", "--seq", "32", "--batch", "8",
        "--microbatches", "2", "--lr", "3e-3", "--warmup", "2", "--log-every", "5", "--out", str(out),
    ])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["arch"] == arch and s["config"].endswith("-smoke") and s["device"] == "cpu"
    assert s["flash_launches"] == 0 and s["ssd_launches"] == 0
    assert len(s["losses"]) == 10 and np.isfinite(s["losses"] + s["grad_norms"]).all()
    assert s["losses"][-1] < s["losses"][0]
    assert s["leaves_updated"] == s["leaves"] and s["param_norm"][1] != s["param_norm"][0]


def test_train_takes_a_depth_cut():
    args = argparse.Namespace(
        arch="gemma3-12b", smoke=True, batch=2, seq=16, microbatches=1, device="cpu", log_every=10,
        profile=False, steps=2, lr=1e-3, warmup=1, seed=0,
    )
    s, _ = train.train(args, num_layers=6)
    assert s["num_layers"] == 6 and len(s["losses"]) == 2


@pytest.mark.parametrize("arch,prompt", [("qwen2.5-14b", (8, 16)), ("gemma3-12b", (60, 80))])
def test_serve_decode_serves_the_dense_archs(arch, prompt, tmp_path):
    """gemma3-smoke's prompts pass its 64-token window."""
    out = tmp_path / "serve.json"
    rc = serve_decode.main([
        "--config", arch, "--tiny", "--device", "cpu", "--requests", "4", "--prompt-len", *map(str, prompt),
        "--new-tokens", "3", "6", "--max-len", str(prompt[1] + 8), "--out", str(out),
    ])
    assert rc == 0
    s = json.loads(out.read_text())
    assert s["requests_completed"] >= 4 and not s["nonfinite_logits"]
    assert s["config"].endswith("-smoke") and s["num_layers"] == 2
    assert s["weight_bytes"] > 0 and s["cache_bytes"] > 0 and s["setup_max_memory_allocated"] is None
    assert s["flash_launches"] == 0


def test_calibrate_counts_a_dense_arch_and_tunes(tmp_path):
    rec = dryrun_pipeline.main([
        "--calibrate", "--config", "qwen1.5-4b", "--method", "spec", "--device", "cpu", "--stages", "4",
        "--batch", "8", "--microbatches", "4", "--seq", "256", "--out", str(tmp_path),
    ])
    assert rec["config"] == "qwen1.5-4b" and rec["method"] == "spec"
    chosen = rec["tuned"]["chosen"]
    assert chosen["name"] in rec["tuned"]["candidates"] and chosen["kind"]
    assert (tmp_path / "qwen1.5-4b__S4_calibration.json").exists()
