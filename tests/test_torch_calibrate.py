"""The port's calibration (``repro_torch.core.calibrate``,
``launch/op_counts.py``, ``launch/dryrun_pipeline.py``) against ``repro``'s.

* **Every test of ``tests/test_calibrate.py`` on the port**, with
  ``repro``'s ``"hlo"`` method as ``"spec"`` on ``specs/tpu-v5e.json``
  (the same constants as data).
* **FLOP parity**: on that test's tiny config (2 stages, b 2, T 8) and on a
  GPT-family twin of it, each stage's four programs count exactly the FLOPs
  of ``repro``'s ``calibrate_stage_costs(...).profiles[s][p].flops``, but
  for one named difference: on every stage but the last, the port's
  ``bwd_input`` and ``bwd_weight`` bodies compute the stage's output under
  autograd (the root of the gradient), whose last product -- the final
  layer's MLP down projection, 2 * b * T * d_ff * d FLOPs -- XLA drops from
  ``repro``'s vjp program as dead.
* **The slice as a whole**: under a spec with an unbounded HBM bandwidth
  (every program priced by its FLOPs), the port's
  ``dryrun_pipeline.calibrate`` record equals ``repro``'s on every key both
  have -- costs (up to that gap over the peak, at 1e-12 relative), memory,
  the admitted warmup vector, and the tune (its candidates exactly; its
  estimates and choice equal to ``repro``'s search on the port's costs).
* The counters: HBM bytes held to a hand count, K1's FLOP formula held to
  the plain attention's count (and through the kernel, on a card), and the
  programs through K1 against the plain attention: the FLOPs counted are
  the plain attention's, the bytes K1's route's.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs.gpt as jgpt
from repro.core.calibrate import calibrate_stage_costs as jax_calibrate
from repro.models.common import ModelConfig as JaxConfig
from repro.pipeline.stage import StagedModel as JaxStaged
from repro_torch.configs import gpt
from repro_torch.core.calibrate import calibrate_stage_costs, count_programs, count_stage
from repro_torch.core.devicespec import TASK_PROGRAMS, load_device_spec, spec_root
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import dryrun_pipeline
from repro_torch.launch.op_counts import count_ops, tensor_bytes
from repro_torch.models.common import ModelConfig
from repro_torch.pipeline.stage import StagedModel

#: tests/test_calibrate.py's config, and its GPT-family twin
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=256)
TINY_GPT = dict(TINY, name="tiny-gpt", num_kv_heads=4, mlp_act="gelu", norm="layernorm", tie_embeddings=True)
B_MB, T = 2, 8
_V5E = load_device_spec(os.path.join(spec_root(), "tpu-v5e.json"))


def _cfg(**kw) -> ModelConfig:
    return ModelConfig(**{**TINY, **kw}, dtype=torch.float32, param_dtype=torch.float32)


def _jax_cfg(**kw) -> JaxConfig:
    return JaxConfig(**{**TINY, **kw}, dtype=jnp.float32, param_dtype=jnp.float32)


def _roofline(staged, **kw):
    """``repro``'s ``method="hlo"``: its constants are ``specs/tpu-v5e.json``'s."""
    return calibrate_stage_costs(
        staged, micro_batch_size=B_MB, seq_len=T, method="spec", device_spec=_V5E, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def calibration():
    staged = StagedModel.build(_cfg(), 2)
    return staged, _roofline(staged)


# -- tests/test_calibrate.py, on the port ------------------------------------------


def test_calibration_produces_valid_stage_costs(calibration):
    staged, cal = calibration
    S = staged.num_stages
    c = cal.costs
    assert c.num_stages == S
    for arr in (c.fwd_time, c.bwd_time, c.bwd_input_time, c.bwd_weight_time):
        assert len(arr) == S and all(t > 0 for t in arr)
    for s in range(S):
        assert c.bwd_time[s] == pytest.approx(c.bwd_input_time[s] + c.bwd_weight_time[s])
    assert c.fwd_bytes[0] == 2 * 8 * 32 * 4
    assert c.bwd_bytes[-1] == c.fwd_bytes[0]


def test_calibration_is_heterogeneous(calibration):
    """Stage 0's forward carries the embedding lookup; the last stage's
    backward carries the vocab projection."""
    _, cal = calibration
    c = cal.costs
    assert c.fwd_time[0] > c.fwd_time[1]
    assert c.bwd_input_time[-1] > c.bwd_input_time[0]
    assert c.bwd_weight_time[-1] > c.bwd_weight_time[0]


def test_calibration_memory_model_matches_stages(calibration):
    staged, cal = calibration
    mm = cal.memory
    assert len(mm.stages) == staged.num_stages
    for spec in mm.stages:
        assert spec.param_bytes > 0
        assert spec.stage_input_bytes_per_token == 32 * 4
        assert spec.num_layers == staged.layers_per_stage
    from repro_torch.core import ScheduleSpec, largest_admissible_warmup, make_plan

    S = staged.num_stages
    h1 = make_plan(S, 4, spec=ScheduleSpec(kind="zb_h1", micro_batch_size=2))
    base = mm.peak_bytes_per_stage(h1)
    limits = [p + 2.5 * mm.slot_bytes(s, 2, True) for s, p in enumerate(base)]
    w = largest_admissible_warmup(S, 4, 1, 2, 1, True, mm, limits, 8)
    assert max(w) >= 1


def test_calibration_profiles_expose_roofline_terms(calibration):
    _, cal = calibration
    for prof in cal.profiles:
        for kind in TASK_PROGRAMS:
            p = prof[kind]
            assert p.flops > 0 and p.hbm_bytes > 0 and p.seconds > 0
    assert len(cal.summary_rows()) == len(cal.profiles)


def test_calibration_rejects_unknown_method():
    staged = StagedModel.build(_cfg(), 2)
    with pytest.raises(ValueError, match="unknown calibration method"):
        calibrate_stage_costs(staged, 1, 8, method="guess", device="cpu")
    with pytest.raises(ValueError, match="device_spec="):
        calibrate_stage_costs(staged, 1, 8, method="hlo", device="cpu")
    with pytest.raises(ValueError, match="unknown calibration method"):
        calibrate_stage_costs(staged, 1, 8, method="roofline", device="cpu")


def test_spec_method_defaults_to_the_h100_spec():
    """``repro`` requires ``device_spec=``; the port prices on its card's
    spec when none is given."""
    staged = StagedModel.build(_cfg(), 2)
    cal = calibrate_stage_costs(staged, 1, 8, device="cpu")
    assert cal.method == "spec" and cal.device == "h100-sxm" and cal.limits == [80e9, 80e9]


def test_spec_method_fails_closed_on_missing_dtype(calibration):
    from repro_torch.core.devicespec import DeviceSpec, DeviceSpecError

    staged, _ = calibration
    bf16_only = DeviceSpec(
        name="bf16-only", peak_flops={"bf16": 1e15},
        hbm_bandwidth_bytes_per_s=1e12, memory_capacity_bytes=1e10,
        link_bandwidth_bytes_per_s=1e11,
    )
    with pytest.raises(DeviceSpecError, match="no peak_flops entry for dtype 'f32'"):
        calibrate_stage_costs(staged, 2, 8, method="spec", device_spec=bf16_only, device="cpu")


def test_spec_method_reproduces_roofline_bit_for_bit(calibration):
    """The spec read from its file prices as the loaded one, and each
    program at ``max(flops / peak, bytes / bw)`` on its constants."""
    staged, roof = calibration
    spec_cal = calibrate_stage_costs(
        staged, micro_batch_size=2, seq_len=8, method="spec",
        device_spec=os.path.join(spec_root(), "tpu-v5e.json"), device="cpu",
    )
    for field in ("fwd_time", "bwd_time", "bwd_input_time", "bwd_weight_time",
                  "bwd_weight_saved_time", "fwd_bytes", "bwd_bytes"):
        assert getattr(spec_cal.costs, field) == getattr(roof.costs, field)
    assert spec_cal.memory.stages == roof.memory.stages
    peak, bw = _V5E.peak_flops_for("f32"), _V5E.hbm_bandwidth_bytes_per_s
    for prof in roof.profiles:
        for p in prof.values():
            assert p.seconds == max(p.flops / peak, p.hbm_bytes / bw) and p.repeat_seconds == ()
    assert spec_cal.device == roof.device == "tpu-v5e" and spec_cal.dtype == "f32"
    assert spec_cal.limits == roof.limits == [16e9] * staged.num_stages
    assert roof.dtype == "f32" and roof.micro_batch_size == 2


def test_workload_capture_roundtrip_derives_identical_costs(calibration, tmp_path):
    from repro_torch.core.devicespec import (
        WorkloadProfile,
        derive_memory_model,
        derive_stage_costs,
        load_workload_profile,
    )

    _, cal = calibration
    wl = WorkloadProfile.from_calibration(cal, name="tiny-capture")
    path = tmp_path / "tiny-capture.json"
    wl.save(str(path))
    wl2 = load_workload_profile(str(path))
    assert wl2 == wl
    c1, c2 = derive_stage_costs(wl, _V5E), derive_stage_costs(wl2, _V5E)
    assert c1 == c2
    assert c1.fwd_time == cal.costs.fwd_time
    assert c1.bwd_weight_saved_time == cal.costs.bwd_weight_saved_time
    assert derive_memory_model(wl2).stages == cal.memory.stages


# -- FLOP parity and the slice against repro ----------------------------------------


def _gap(cfg, s: int, S: int, program: str) -> float:
    """The port's FLOPs above ``repro``'s: the final layer's MLP down
    projection, computed by the port's backward bodies as part of the stage
    output and dropped by XLA as dead, on every stage but the last."""
    if program in ("bwd_input", "bwd_weight") and s < S - 1:
        return 2.0 * B_MB * T * cfg.d_ff * cfg.d_model
    return 0.0


@pytest.fixture(scope="module", params=[TINY, TINY_GPT], ids=["tiny", "tiny-gpt"])
def both(request):
    kw = {k: v for k, v in request.param.items() if k not in TINY or TINY[k] != v}
    cfg, jcfg = _cfg(**kw), _jax_cfg(**kw)
    jcal = jax_calibrate(JaxStaged.build(jcfg, 2), micro_batch_size=B_MB, seq_len=T)
    return cfg, jcal, _roofline(StagedModel.build(cfg, 2))


def test_flops_match_repro_per_stage_and_program(both):
    cfg, jcal, cal = both
    S = len(cal.profiles)
    for s in range(S):
        for p in TASK_PROGRAMS:
            want = jcal.profiles[s][p].flops + _gap(cfg, s, S, p)
            assert cal.profiles[s][p].flops == want, (s, p)


def test_memory_model_matches_repro(both):
    _, jcal, cal = both
    assert [vars(m) for m in cal.memory.stages] == [vars(m) for m in jcal.memory.stages]
    assert cal.memory.seq_len == jcal.memory.seq_len
    assert cal.costs.fwd_bytes == jcal.costs.fwd_bytes and cal.dtype == jcal.dtype


def test_saved_residual_weight_gradient_skips_the_recompute(both):
    _, _, cal = both
    for prof in cal.profiles:
        assert prof["bwd_weight_saved"].flops < prof["bwd_weight"].flops
        assert prof["bwd_weight_saved"].flops + prof["fwd"].flops <= prof["bwd_weight"].flops


def test_k1_path_counts_the_plain_attention_flops():
    """The stage programs through K1's training entry (its custom operator
    and formula, on ``meta``): the fwd counts the plain attention's FLOPs
    and moves q, k, v and out where the plain attention moves its scores;
    each backward program recomputes the plain attention once a layer, and
    counts its FLOPs and bytes on top of the plain attention's.  The
    calibration counts the plain FLOPs and K1's bytes."""
    cfg = _cfg(**{k: v for k, v in TINY_GPT.items() if k != "name"})
    staged = StagedModel.build(cfg, 2)
    L, H, hd = staged.layers_per_stage, cfg.num_heads, cfg.d_model // cfg.num_heads
    q = torch.empty((B_MB, T, H, hd), dtype=cfg.dtype, device="meta")
    attn = count_ops(lambda: flash_ref.train_attention(q, q, q))
    assert attn.flops == flash_ref.train_attention_flops(B_MB, T, T, H, hd)
    for s in range(2):
        plain = count_programs(dataclasses.replace(staged, plain_attention=True), s, B_MB, T)
        k1 = count_programs(staged, s, B_MB, T)
        assert k1["fwd"].flops == plain["fwd"].flops
        # and the plain output's heads are merged by a copy (read and write)
        assert k1["fwd"].hbm_bytes == plain["fwd"].hbm_bytes - L * (attn.hbm_bytes - 4 * tensor_bytes(q)) - L * (
            2 * tensor_bytes(q)
        )
        for p in ("bwd_input", "bwd_weight", "bwd_weight_saved"):
            assert k1[p].flops == plain[p].flops + L * attn.flops, p
        # W(SR) replays B's graph: the plain attention kept its probabilities
        assert k1["bwd_weight_saved"].hbm_bytes == plain["bwd_weight_saved"].hbm_bytes + L * attn.hbm_bytes
        counted = count_stage(staged, s, B_MB, T)
        assert {p: (c.flops, c.hbm_bytes) for p, c in counted.items()} == {
            p: (plain[p].flops, k1[p].hbm_bytes) for p in TASK_PROGRAMS
        }


def _import_repro_dryrun():
    """``repro``'s module sets XLA_FLAGS for 256 host devices at import;
    restore the variable so that nothing later in this process sees it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun_pipeline as jdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdry


def test_slice_record_matches_repro(tmp_path, monkeypatch):
    import repro.core as J
    from repro.core.calibrate import Calibration as JaxCalibration

    jdry = _import_repro_dryrun()
    cfg, jcfg = _cfg(**{k: v for k, v in TINY_GPT.items() if k != "name"}), _jax_cfg(
        **{k: v for k, v in TINY_GPT.items() if k != "name"}
    )
    monkeypatch.setattr(jdry, "_config", lambda name: jcfg)
    monkeypatch.setattr(dryrun_pipeline, "_config", lambda name: cfg)
    payload = _V5E.to_json()
    payload.update(name="flop-bound", hbm_bandwidth_bytes_per_s=1e30)
    spec_path = tmp_path / "flop-bound.json"
    spec_path.write_text(json.dumps(payload))
    S = 2
    want = jdry.calibrate("tiny", S, B_MB, T, str(tmp_path / "jax"), device_spec=str(spec_path))
    got = dryrun_pipeline.calibrate("tiny", S, B_MB, T, str(tmp_path / "port"), device_spec=str(spec_path), device="cpu")
    assert json.loads((tmp_path / "port" / "tiny__S2_calibration.json").read_text()) == json.loads(json.dumps(got))
    assert got["method"] == "spec" and got["card"] == "cpu"

    peak = _V5E.peak_flops_for("f32")
    for key in set(want) & set(got) - {"tuned"}:
        if key.endswith("_time"):
            program = key[: -len("_time")]
            for s in range(S):
                gap = _gap(cfg, s, S, program)
                assert got[key][s] == pytest.approx(want[key][s] + gap / peak, rel=1e-12, abs=0), (key, s)
        else:
            assert got[key] == want[key], key

    # the tune: the same candidates, and repro's search on the port's costs
    assert got["tuned"]["candidates"] == want["tuned"]["candidates"]
    assert got["tuned"]["global_batch"] == want["tuned"]["global_batch"]
    jspec = J.load_device_spec(str(spec_path))
    jcosts = J.StageCosts(
        fwd_time=got["fwd_time"],
        bwd_time=[bi + bw for bi, bw in zip(got["bwd_input_time"], got["bwd_weight_time"])],
        fwd_bytes=got["fwd_bytes"], bwd_bytes=got["fwd_bytes"],
        bwd_input_time=got["bwd_input_time"], bwd_weight_time=got["bwd_weight_time"],
        bwd_weight_saved_time=got["bwd_weight_saved_time"],
    )
    jmem = jax_calibrate(JaxStaged.build(jcfg, S), micro_batch_size=B_MB, seq_len=T).memory
    jcal = JaxCalibration(costs=jcosts, memory=jmem, profiles=[], limits=jspec.limit_curve(S))
    assert got["tuned"] == jdry._tune_on_spec(jcal, jspec, S, B_MB)


# -- the counters ------------------------------------------------------------------------


def test_hbm_bytes_match_a_hand_count():
    """One matmul plus a bias, fp32: mm reads x [4, 8] and w [8, 16] and
    writes y [4, 16]; the add reads y and b [16] and writes y again."""
    x, w, b = torch.ones(4, 8), torch.ones(8, 16), torch.ones(16)
    c = count_ops(lambda: x @ w + b)
    assert c.flops == 2 * 4 * 16 * 8
    assert c.hbm_bytes == 4 * ((4 * 8 + 8 * 16 + 4 * 16) + (4 * 16 + 16 + 4 * 16))
    # views and allocations move nothing; the same program on meta counts the same
    xm, wm, bm = (t.to("meta") for t in (x, w, b))
    assert count_ops(lambda: (xm.T.T @ wm + bm).reshape(2, 2, 16)) == c
    assert count_ops(lambda: torch.empty(1000, 1000, device="meta").view(-1)).hbm_bytes == 0


ATTN_CASES = [
    # (B, T, S, H, K, hd): GQA, T < S, the chunked plain path from 2048 up
    (2, 24, 24, 4, 2, 16),
    (1, 10, 30, 4, 4, 16),
    (1, 2100, 2100, 2, 1, 8),
]


def _attn_counts(fn, q, k, v, go):
    with FlopCounterMode(display=False) as fwd_only:
        fn(q, k, v)
    with FlopCounterMode(display=False) as both:
        torch.autograd.grad(fn(q, k, v), (q, k, v), go)
    return fwd_only.get_total_flops(), both.get_total_flops()


@pytest.mark.parametrize("B,T,S,H,K,hd", ATTN_CASES, ids=["gqa", "t_lt_s", "chunked"])
def test_k1_flop_formula_matches_the_plain_attention(B, T, S, H, K, hd):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).requires_grad_(True)
               for sh in ((B, T, H, hd), (B, S, K, hd), (B, S, K, hd)))
    go = torch.from_numpy(rng.standard_normal((B, T, H, hd)).astype(np.float32))
    plain = _attn_counts(flash_ref.train_attention, q, k, v, go)
    through = _attn_counts(flash_ops.flash_attention_train, q, k, v, go)
    assert plain[0] == flash_ref.train_attention_flops(B, T, S, H, hd)
    # the backward recomputes the forward: one forward more than the plain attention
    assert through == (plain[0], plain[1] + plain[0])


@pytest.mark.gpu
def test_k1_flop_formula_through_the_kernel_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    B, T, H, hd = 2, 1024, 32, 80
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, T, H, hd), generator=g, device="cuda").to(torch.bfloat16).requires_grad_(True)
               for _ in range(3))
    go = torch.randn((B, T, H, hd), generator=g, device="cuda").to(torch.bfloat16)
    before = flash_ops.launches
    through = _attn_counts(flash_ops.flash_attention_train, q, k, v, go)
    assert flash_ops.launches == before + 2
    plain = _attn_counts(flash_ref.train_attention, q, k, v, go)
    assert through == (plain[0], plain[1] + plain[0])
    assert through[0] == flash_ref.train_attention_flops(B, T, T, H, hd)


def test_gpt_2_7b_forward_counts_the_closed_form():
    """Full width and depth, counted on meta: each stage's ``fwd`` is
    L_s * (2 * (4 d^2 + 2 d d_ff) * b T + 4 b H T^2 hd); the embedding is a
    gather (no products), and the last stage's head runs in its backward
    programs (2 d V b T of forward there)."""
    cfg = gpt.GPT_CONFIGS["GPT-2.7B"]
    S, b, t = 4, 2, 1024
    L = cfg.num_layers // S
    layer = 2 * (4 * cfg.d_model**2 + 2 * cfg.d_model * cfg.d_ff) * b * t + 4 * b * cfg.num_heads * t * t * cfg.hd
    staged = StagedModel.build(cfg, S, plain_attention=True)
    for s in (0, S - 1):
        counts = count_stage(staged, s, b, t)
        assert counts["fwd"].flops == L * layer
        assert counts["bwd_weight_saved"].flops < counts["bwd_weight"].flops
    assert L * layer == 2_748_779_069_440


# -- wall clock and the CLI ------------------------------------------------------------


def test_wallclock_on_cpu_times_every_program():
    staged = StagedModel.build(_cfg(), 2)
    cal = calibrate_stage_costs(staged, 2, 8, method="wallclock", device="cpu")
    assert cal.device == "cpu" and cal.method == "wallclock" and cal.limits is None
    spec = calibrate_stage_costs(staged, 2, 8, device="cpu")
    for prof, sprof in zip(cal.profiles, spec.profiles):
        for p in TASK_PROGRAMS:
            assert prof[p].seconds > 0 and np.isfinite(prof[p].seconds)
            assert prof[p].flops == sprof[p].flops


def test_wallclock_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    staged = StagedModel.build(_cfg(), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_stage_costs(staged, 2, 8, method="wallclock")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_pipeline.main(["--calibrate", "--method", "wallclock", "--config", "GPT-Medium"])


def test_cli_spec_on_gpt_medium(tmp_path):
    record = dryrun_pipeline.main([
        "--calibrate", "--config", "GPT-Medium", "--stages", "4", "--batch", "8", "--microbatches", "4",
        "--seq", "1024", "--device", "cpu", "--method", "spec", "--out", str(tmp_path),
    ])
    on_disk = json.loads((tmp_path / "GPT-Medium__S4_calibration.json").read_text())
    assert on_disk == json.loads(json.dumps(record))
    assert record["device"] == "h100-sxm" and record["dtype"] == "bf16" and record["card"] == "cpu"
    assert record["bwd_input_time"][-1] > max(record["bwd_input_time"][1:-1])
    assert record["bwd_weight_time"][-1] > max(record["bwd_weight_time"][1:-1])
    assert all(ws < w for ws, w in zip(record["bwd_weight_saved_time"], record["bwd_weight_time"]))
    assert record["tuned"]["chosen"]["name"] in record["tuned"]["candidates"]
    from repro_torch.core.devicespec import WorkloadProfile, derive_stage_costs

    costs = derive_stage_costs(WorkloadProfile.from_json(record["workload"]), load_device_spec(
        os.path.join(spec_root(), "h100-sxm.json")))
    assert costs.fwd_time == record["fwd_time"] and costs.bwd_weight_saved_time == record["bwd_weight_saved_time"]
    with pytest.raises(SystemExit):
        dryrun_pipeline.main(["--config", "GPT-Medium", "--device", "cpu"])
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 6"):
        dryrun_pipeline.main(["--calibrate", "--config", "qwen2.5-14b", "--device", "cpu"])


def test_gpt_stage_costs_and_unet_match_repro():
    for name in gpt.GPT_CONFIGS:
        for S, b in ((4, 2), (8, 1)):
            got = gpt.gpt_stage_costs(gpt.GPT_CONFIGS[name], S, b, 1024, chip_flops=123e12)
            want = jgpt.gpt_stage_costs(jgpt.GPT_CONFIGS[name], S, b, 1024, chip_flops=123e12)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for name, fn in gpt.UNET_COSTS.items():
        assert dataclasses.asdict(fn(4)) == dataclasses.asdict(jgpt.UNET_COSTS[name](4))
    with pytest.raises(TypeError):
        gpt.gpt_stage_costs(gpt.GPT_CONFIGS["GPT-Medium"], 4, 2)  # no default chip rate
