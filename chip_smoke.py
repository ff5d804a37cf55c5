"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only device,build,kernels

Phases, in order (any failure exits non-zero, and no result line is printed):

1. device       the card's name and power limit, as nvidia-smi reports them
2. build        nvcc builds the CUDA kernels (K1 flash attention, K2 SSD scan)
                from the sources in this checkout, one nvcc per source, in
                parallel
3. kernels      each kernel against its plain PyTorch version on the card, at
                the main paths' shapes and at the edge cases (each case logs
                the route it took: "mma", tensor cores, or "fma"), then timed
                beside the plain version and the PyTorch library call
                (yardstick only; K2 has none); K1 at all three serving
                lengths
4. model        a 2-layer, full-width GPT-2.7B: prefill + 4 decode steps
                through K1 and through the plain attention; logits and greedy
                tokens agree
5. train-model  a 2-layer, full-width mamba2-780m: loss and gradients of one
                micro-batch through K2 and through the plain SSD agree
6. serve        GPT-2.7B at full width and depth served through
                ``repro_torch.launch.serve_decode``: 16 requests over 8 slots
                on an M=4 x b=2 grid; every request completes, no NaN, and K1
                ran once per layer per prefill
7. train        mamba2-780m at full width and depth trained through
                ``repro_torch.launch.train``: 6 steps of batch 8 x 1024 tokens
                in M=2 micro-batches; K2 ran once per layer per micro-batch,
                and the loss is finite and falls, with finite gradient norms
8. pipeline-model
                a 4-layer, full-width GPT-2.7B in S=2 stages, M=4 micro-batches
                of 1 x 512 tokens: the reference pipeline engine's loss and
                gradients under kfkb k=1, kfkb k=2, zb_h1 (saved residuals),
                zb_h2 (w=2), interleaved (v=2) and interleaved_zb (v=2)
                against autograd of the unpipelined ``full_loss``; the K1
                path against the plain attention; K1 launches in every run
                equal the attention forwards of the plan's grid
                (M*L*(2S-1)/S under kfkb)
9. pipeline     GPT-2.7B at full width and depth trained through
                ``repro_torch.launch.train.run_pipeline``: S=4 stages under
                kfkb k=2, M=8 micro-batches of 1 x 1024 tokens, 6 steps and
                one profiled step; the loss is finite and falls, and K1 ran
                M*L*(2S-1)/S = 448 times a step
10. adaptive    Ada-Grouper's plan-switch loop: GPT-2.7B at full width and
                depth trained through ``repro_torch.launch.train_adaptive``'s
                Fig-10 scenario (S=4, M=4 micro-batches of 2 x 1024 tokens,
                the tuner choosing among 1F1B, 2F2B, ZB-H1, ZB-H2(w=2) and
                interleaved-ZB(v=2) on a simulated regime network, 14
                iterations, seed 0).  The decision trail equals the one the
                decision layer computes without an engine; >= 2 kind
                switches, one restacking across v = 1 <-> 2; warm switches
                under 5% of an iteration; precompile hit rate >= 0.8 and no
                cold miss; finite losses; K1 launched in every iteration as
                often as the plan's grid says; and the switched and
                restacked state's gradients agree with autograd of the
                unpipelined ``full_loss``

The line before the last is a JSON object with every kernel's figures (K1's
also per main path: serving, pipeline training and the adaptive loop, each at
its own shape);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = (
    "device", "build", "kernels", "model", "train-model", "serve", "train", "pipeline-model", "pipeline", "adaptive",
)

#: published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

#: kernel vs plain version, as allclose(atol=tol, rtol=tol).  bf16/fp16 (the
#: mma route): the FLASH_CASES tolerance of repro's kernel tests (one output
#: rounding plus P rounded to the input type at another point of the
#: softmax; the tensor cores multiply the same 16-bit operands exactly and
#: sum in fp32).  fp32 (the fma route): both sides compute in fp32 and
#: differ only in summation order and exp, a few ulp of the fp32 output.
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}
#: kernel vs plain version, as ||out - want|| / ||want|| over the whole
#: output.  The allclose above lets a small |out| row (most rows at T = 512
#: average hundreds of v rows) be off by far more than a rounding; the norm
#: ratio holds the bulk of the output.  bf16/fp16: two unit roundoffs (each
#: side rounds every probability once, at different points of the softmax,
#: then the output).  fp32: ~30 unit roundoffs of summation order and expf.
#: Unit roundoff: bf16 3.9e-3, fp16 4.9e-4, fp32 6.0e-8.
REL_TOL = {torch.bfloat16: 8e-3, torch.float16: 1e-3, torch.float32: 2e-6}
#: model check, kernel vs plain attention: logits after 2 bf16 layers; a
#: hidden-state rounding flip moves a logit by a few bf16 ulps (7.8e-3 at 1.0)
MODEL_TOL = 5e-2

# (name, B, T, S, H, K, hd, dtype, causal, window); the first three are the
# serving shapes of GPT-2.7B prefill (333 tests the ragged tile edge), the
# fourth one micro-batch of the pipeline phase, the fifth one of the
# adaptive phase
FLASH_CASES = [
    ("gpt2.7b_t128", 1, 128, 128, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_t333", 1, 333, 333, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_t512", 1, 512, 512, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_train_t1024", 1, 1024, 1024, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_train_b2_t1024", 2, 1024, 1024, 32, 32, 80, torch.bfloat16, True, None),
    ("fp32", 1, 333, 333, 8, 8, 80, torch.float32, True, None),
    ("fp16", 2, 200, 200, 8, 8, 80, torch.float16, True, None),
    ("t_lt_s", 1, 100, 333, 32, 32, 80, torch.bfloat16, True, None),
    ("window", 1, 512, 512, 32, 32, 80, torch.bfloat16, True, 128),
    ("gqa", 2, 333, 333, 32, 8, 80, torch.bfloat16, True, None),
    ("noncausal", 1, 200, 333, 8, 8, 80, torch.bfloat16, False, None),
    ("hd64", 1, 333, 333, 16, 16, 64, torch.bfloat16, True, None),
    ("hd96", 1, 333, 333, 16, 16, 96, torch.bfloat16, True, None),
    ("hd128", 1, 333, 333, 16, 16, 128, torch.bfloat16, True, None),
    ("fp16_window", 1, 333, 333, 8, 8, 80, torch.float16, True, 100),
]
TIMED_CASE = "gpt2.7b_t512"
#: K1's shape on each main path: the longest serving prefill, one pipeline
#: micro-batch, one adaptive micro-batch
PATH_CASES = {"serve": TIMED_CASE, "pipeline": "gpt2.7b_train_t1024", "adaptive": "gpt2.7b_train_b2_t1024"}
#: the shapes K1 is timed at, each beside SDPA and its bound
TIMED_FLASH = ("gpt2.7b_t128", "gpt2.7b_t333", "gpt2.7b_t512", "gpt2.7b_train_t1024", "gpt2.7b_train_b2_t1024")

#: K2 vs plain version, as ||out - want|| / ||want||.  fp32 out (the fma
#: route, fp32 throughout): the two differ in summation order only, over up
#: to 2N + Q = 320 terms per output, each off by about an ulp (unit roundoff
#: 6.0e-8): 2e-5.  bf16 out: both sides round their results to bf16 once,
#: so they differ by one bf16 ulp where the results straddle a rounding
#: boundary and agree elsewhere: under one unit roundoff, 3.9e-3.  The mma
#: route rounds the fp32 operands of three products to TF32 (2^-11
#: relative, under the bf16 output's 2^-9), which moves its fp32 result by
#: ~3e-4 and so more values across a bf16 boundary: ~1.1e-3 by the CPU
#: emulation in tests/test_torch_ssd_scan.py.
SSD_REL_TOL = {torch.bfloat16: 3.9e-3, torch.float32: 2e-5}
_F32, _BF16 = torch.float32, torch.bfloat16
# (name, B, T, H, P, N, Q, x dtype, B/C dtype); "mamba2-780m_train" is one
# micro-batch of the train phase, with x/B/C as strided views of a conv
# output and dt, A as the model draws them at init; the "ssd_cases" rows are
# tests/test_kernels.py::SSD_CASES
SSD_KERNEL_CASES = [
    ("mamba2-780m_train", 4, 1024, 48, 64, 128, 64, _BF16, _BF16),
    ("mamba2-780m_fp32", 1, 512, 16, 64, 128, 64, _F32, _F32),
    ("mamba2-smoke_bf16", 4, 128, 16, 32, 32, 8, _BF16, _BF16),
    ("mamba2-smoke_fp32", 4, 128, 16, 32, 32, 8, _F32, _F32),
    ("ssd_cases_0", 2, 32, 4, 16, 8, 8, _F32, _F32),
    ("ssd_cases_1", 1, 64, 2, 32, 16, 16, _F32, _F32),
    ("ssd_cases_2", 2, 64, 4, 64, 128, 32, _F32, _F32),
    ("ssd_cases_3", 2, 32, 4, 16, 8, 8, _BF16, _F32),
    ("ssd_cases_4", 1, 16, 8, 8, 4, 16, _F32, _F32),
    # the mma route's edges: two chunks, two P slices a head; the (64, 128,
    # 32) row in bf16; x bf16 with B/C fp32 at the training shape (fma route)
    ("mamba2-780m_t128", 2, 128, 8, 64, 128, 64, _BF16, _BF16),
    ("ssd_cases_2_bf16", 2, 64, 4, 64, 128, 32, _BF16, _BF16),
    ("mamba2-780m_mixed", 1, 128, 4, 64, 128, 64, _BF16, _F32),
]
SSD_TIMED_CASE = "mamba2-780m_train"
#: train-model check, K2 vs plain SSD, 2 bf16 layers at full width.  The
#: SSD outputs differ by one bf16 ulp in some elements (see SSD_REL_TOL; on
#: the mma route in more of them); that perturbs everything downstream by a
#: relative ~4e-3 at most, and the mean over 4,096 tokens averages it out of
#: the loss.  Loss: relative 1e-3.
#: Gradients (one global ||g_k - g_p|| / ||g_p|| over every leaf): 2e-2,
#: five bf16 unit roundoffs.
TRAIN_MODEL_LOSS_TOL = 1e-3
TRAIN_MODEL_GRAD_TOL = 2e-2
#: the train phase: mamba2-780m, batch 8 x 1024 tokens in M = 2 micro-batches
TRAIN_ARGS = dict(steps=6, batch=8, seq=1024, microbatches=2, lr=1e-3, warmup=2)
#: pipeline-model check, the engine against autograd of the unpipelined
#: full_loss, both through K1 and in bf16: the same operations on the same
#: bf16 values, so the two differ only in the order of fp32 accumulation
#: over micro-batches (the gradients) and stages.  Loss: relative 1e-3;
#: gradients, one global ||g_e - g_o|| / ||g_o|| over every leaf: 1e-3.
PIPE_ENGINE_LOSS_TOL = 1e-3
PIPE_ENGINE_GRAD_TOL = 1e-3
#: pipeline-model check, the engine through K1 against the engine through the
#: plain attention: the train-model phase's limits (the kernel's bf16
#: output differs from the plain version's by one rounding in some
#: elements; see REL_TOL).
PIPE_K1_LOSS_TOL = TRAIN_MODEL_LOSS_TOL
PIPE_K1_GRAD_TOL = TRAIN_MODEL_GRAD_TOL
#: the pipeline-model cut of GPT-2.7B: (layers, S, M, b, T), and its plans
#: as ScheduleSpec keyword sets
PIPE_MODEL = (4, 2, 4, 1, 512)
PIPE_MODEL_PLANS = (
    dict(kind="kfkb", k=1),
    dict(kind="kfkb", k=2),
    dict(kind="zb_h1", k=1, zb_policy="saved_residual"),
    dict(kind="zb_h2", extra_warmup=2),
    dict(kind="interleaved", k=2, num_virtual=2),
    dict(kind="interleaved_zb", num_virtual=2),
)
#: the pipeline phase: GPT-2.7B at full size in S = 4 stages under kfkb k = 2,
#: batch 8 x 1024 tokens in M = 8 micro-batches (b = 1)
PIPE_STAGES, PIPE_K = 4, 2
PIPE_ARGS = dict(steps=6, batch=8, seq=1024, microbatches=8, lr=1e-4, warmup=2)
#: the adaptive phase: repro's Fig-10 scenario (train_adaptive.build_fig10_scenario)
#: with GPT-2.7B at full size, sequences of 1024 tokens, 14 coordinator iterations
ADAPTIVE_ARGS = dict(gpt="GPT-2.7B", seq_len=1024, seed=0)
ADAPTIVE_ITERATIONS = 14
#: adaptive check, the engine's gradients on the switched and restacked state
#: against autograd of full_loss: pipeline-model's limit (both through K1 in
#: bf16, the same operations on the same values, fp32 sums in another order)
ADAPTIVE_GRAD_TOL = PIPE_ENGINE_GRAD_TOL


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 oracles in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": smi,
    }


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    mods = (flash_ops, ssd_ops)
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, all at once
        builds = list(pool.map(build.build, [m.SOURCE for m in mods]))
    for m, b in zip(mods, builds):
        m._kernel()  # load and bind it
        log(f"build {os.path.relpath(b.source, ROOT)}: {b.seconds:.1f} s")
        for line in b.ptxas_lines():
            log(f"  {line}")
        for name, n in _hmma_counts(b.library).items():
            log(f"  HMMA {n:5d}  {name}")


def _hmma_counts(library) -> dict:
    """Tensor-core instructions (HMMA) per kernel in the built library's SASS,
    where the toolkit has cuobjdump; empty otherwise."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("  (no cuobjdump: HMMA counts not shown)")
        return {}
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HMMA" in line:
            counts[name] += 1
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if os.path.exists(filt) and counts:
        names = subprocess.run([filt], input="\n".join(counts), capture_output=True, text=True).stdout.split("\n")
        counts = {(n.strip() or k): counts[k] for k, n in zip(counts, names)}
    return counts


def _qkv(B, T, S, H, K, hd, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device="cuda", dtype=torch.float32).to(dtype)  # noqa: E731
    return mk(B, T, H, hd), mk(B, S, K, hd), mk(B, S, K, hd)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: the summed device time of the kernels that
    ``iters`` calls launch, traced by torch.profiler, over ``iters``.  Unlike
    _time_ms it leaves out the host's share of a call."""
    from repro_torch.launch.profiling import device_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    return device_profile(run, torch.device("cuda"), {})["device_ms"] / iters


def _flash_bound_ms(B, T, S, H, K, hd, dtype, causal, window) -> tuple[float, str]:
    """max(bytes / HBM rate, FLOPs / peak) for the pairs this mask keeps."""
    from repro_torch.kernels.flash_attention import ref

    pairs = int(ref.causal_window_mask(T, S, causal, window).sum())
    flops = 4.0 * hd * pairs * B * H  # q.k and p.v, 2 FLOP per MAC
    nbytes = (2 * B * T * H * hd + 2 * B * S * K * hd) * torch.finfo(dtype).bits / 8
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _flash_kernels() -> dict:
    from repro_torch.kernels.flash_attention import ops, ref

    timed = {}
    for name, B, T, S, H, K, hd, dtype, causal, window in FLASH_CASES:
        q, k, v = _qkv(B, T, S, H, K, hd, dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        diff = out.float() - want.float()
        err = float(diff.abs().max())
        rel = float(diff.norm() / want.float().norm())
        tol, rel_tol = TOL[dtype], REL_TOL[dtype]
        excess = float((diff.abs() - tol * want.float().abs()).max())
        ok = bool(torch.isfinite(out).all()) and excess <= tol and rel <= rel_tol
        log(f"flash {name:14s} B={B} T={T} S={S} H={H} K={K} hd={hd} "
            f"{str(dtype).split('.')[-1]} causal={causal} window={window} route {ops.route(dtype)}: "
            f"max_abs_err {err:.3e} (allclose atol=rtol={tol:g}), "
            f"rel_norm_err {rel:.3e} (<= {rel_tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version on {name}")
        if name in TIMED_FLASH:
            timed[name] = (B, T, S, H, K, hd, dtype, causal, window, q, k, v, err)

    # device time from the profiler (the kernel's own time); per-call wall
    # time from CUDA events around back-to-back calls, which includes the
    # host's share of each call where the host is the slower side
    times = {}
    for name in TIMED_FLASH:
        B, T, S, H, K, hd, dtype, causal, window, q, k, v, err = timed[name]
        flash = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
        plain = lambda: ref.attention(q, k, v, causal=causal, window=window)  # noqa: E731
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
        ms, plain_ms, library_ms = _device_ms(flash), _device_ms(plain), _device_ms(sdpa)
        call_ms, sdpa_call_ms = _time_ms(flash), _time_ms(sdpa)
        bound_ms, bound_by = _flash_bound_ms(B, T, S, H, K, hd, dtype, causal, window)
        log(f"flash timing at {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
            f"(device time); per call {call_ms:.4f} ms, sdpa {sdpa_call_ms:.4f} ms (events); "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        times[name] = (err, ms, plain_ms, library_ms, bound_ms, bound_by)
    # what one layer's attention costs a pipeline step's backward task: K1
    # forward, then the backward that recomputes and differentiates the plain
    # version
    q, k, v = (t.detach().requires_grad_(True) for t in timed[PATH_CASES["pipeline"]][9:12])
    go = torch.randn(q.shape, device="cuda").to(q.dtype)
    train_ms = _time_ms(lambda: torch.autograd.grad(ops.flash_attention_train(q, k, v), (q, k, v), go), iters=5)
    log(f"flash forward (K1) + backward (plain recompute) at {PATH_CASES['pipeline']}: {train_ms:.4f} ms")

    def figures(name):
        err, ms, plain_ms, library_ms, bound_ms, bound_by = times[name]
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": None,  # filled from the serve, pipeline and adaptive phases (the main paths)
        **figures(TIMED_CASE),
        # each main path's launches (filled from its phase) and figures at its shape
        "per_path": {
            path: {"shape": name, "launches": None, **figures(name)} for path, name in PATH_CASES.items()
        },
    }


def _ssd_inputs(B, T, H, P, N, x_dtype, bc_dtype, seed=0):
    """x/B/C as strided views of one conv output [B, T, H*P + 2N] (as
    ``mamba_train`` passes them); dt in the init range [0.001, 0.1] and
    A = -(1..H), as ``mamba_init`` draws them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    conv = torch.randn((B, T, H * P + 2 * N), generator=g, device="cuda")
    xs, bcs = conv.to(x_dtype), conv.to(bc_dtype)  # one tensor when the types agree
    x = xs[..., : H * P].reshape(B, T, H, P)
    Bm = bcs[..., H * P : H * P + N].reshape(B, T, 1, N)
    Cm = bcs[..., H * P + N :].reshape(B, T, 1, N)
    dt = 0.001 + 0.099 * torch.rand((B, T, H), generator=g, device="cuda")
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    return x, dt, A, Bm, Cm


def _ssd_bound_ms(B, T, H, P, N, Q, x_dtype, bc_dtype) -> tuple[float, str]:
    """max(bytes / HBM rate, FLOPs / peak): x, dt, A, B, C read once and y
    written once; per (b, h, chunk) the causal triangle of C B^T and of
    S w, plus C h^T and the state update, 2 FLOP per MAC, at the peak of
    x's type."""
    xb, bcb = torch.finfo(x_dtype).bits / 8, torch.finfo(bc_dtype).bits / 8
    nbytes = 2 * B * T * H * P * xb + 4 * B * T * H + 2 * B * T * N * bcb + 4 * H
    tri = Q * (Q + 1) / 2
    flops = B * H * (T // Q) * 2.0 * (tri * N + tri * P + 2 * Q * P * N)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[x_dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ssd_kernels() -> dict:
    from repro_torch.kernels.ssd_scan import ops, ref

    timed = None
    for name, B, T, H, P, N, Q, x_dtype, bc_dtype in SSD_KERNEL_CASES:
        x, dt, A, Bm, Cm = _ssd_inputs(B, T, H, P, N, x_dtype, bc_dtype)
        out = ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        want = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)
        torch.cuda.synchronize()
        diff = out.float() - want.float()
        err = float(diff.abs().max())
        rel = float(diff.norm() / want.float().norm())
        rel_tol = SSD_REL_TOL[x_dtype]
        ok = bool(torch.isfinite(out).all()) and rel <= rel_tol
        path = ops.route(x_dtype, bc_dtype, P, N, Q)
        log(f"ssd {name:18s} B={B} T={T} H={H} P={P} N={N} Q={Q} x {str(x_dtype).split('.')[-1]} "
            f"B/C {str(bc_dtype).split('.')[-1]} route {path}: max_abs_err {err:.3e}, "
            f"rel_norm_err {rel:.3e} (<= {rel_tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"SSD kernel disagrees with its plain version on {name}")
        if name == SSD_TIMED_CASE:
            timed = (B, T, H, P, N, Q, x_dtype, bc_dtype, x, dt, A, Bm, Cm, err)

    B, T, H, P, N, Q, x_dtype, bc_dtype, x, dt, A, Bm, Cm, err = timed
    ssd = lambda: ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
    plain = lambda: ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
    ms, plain_ms = _device_ms(ssd), _device_ms(plain, iters=5)
    call_ms = _time_ms(ssd)
    bound_ms, bound_by = _ssd_bound_ms(B, T, H, P, N, Q, x_dtype, bc_dtype)
    log(f"ssd timing at {SSD_TIMED_CASE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device time); "
        f"per call {call_ms:.4f} ms (events); no library call, bound {bound_ms:.4f} ms ({bound_by})")
    # what one layer's SSD costs a training step: K2 forward, then the
    # backward that recomputes and differentiates the plain version
    inputs = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    gy = torch.randn(x.shape, device="cuda").to(x.dtype)
    train_ms = _time_ms(lambda: torch.autograd.grad(ops.ssd_chunked(*inputs, chunk=Q), inputs, gy), iters=5)
    log(f"ssd forward (K2) + backward (plain recompute) at {SSD_TIMED_CASE}: {train_ms:.4f} ms")
    return {
        "name": "ssd_chunked_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:65",
        "launches": None,  # filled from the train phase (the main path)
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no single PyTorch call computes the chunked SSD
    }


def phase_kernels() -> dict:
    return {"flash": _flash_kernels(), "ssd": _ssd_kernels()}


def phase_model() -> None:
    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.models import api

    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=2)
    params = api.cast_for_serving(api.init_params(cfg, seed=0, device="cuda"), cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 512), generator=g, device="cuda")
    steps = 4

    def run(plain: bool, feed=None):
        cache = api.init_cache(cfg, 1, 576, device="cuda")
        logits, cache = api.prefill_with_cache(
            params, cfg, cache, {"tokens": prompt}, plain_attention=plain
        )
        out = [logits[:, -1].float()]
        for i in range(steps):
            tok = feed[i] if feed is not None else out[-1].argmax(-1, keepdim=True)
            logits, cache = api.decode_fn(params, cfg, cache, 512 + i, {"tokens": tok})
            out.append(logits[:, -1].float())
        torch.cuda.synchronize()
        return out

    kern = run(False)
    feed = [x.argmax(-1, keepdim=True) for x in kern[:steps]]
    plain = run(True, feed)
    for i, (a, b) in enumerate(zip(kern, plain)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite logits at step {i}")
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, atol=MODEL_TOL, rtol=MODEL_TOL)
        ta, tb = int(a.argmax()), int(b.argmax())
        top2 = b[0].topk(2).values
        gap = float(top2[0] - top2[1])
        log(f"model step {i} ({'prefill' if i == 0 else 'decode'}): logits max_abs_err "
            f"{err:.3e} (atol=rtol={MODEL_TOL}), greedy {ta} vs {tb}, top-2 gap {gap:.3e}")
        if not ok:
            raise AssertionError(f"kernel and plain logits disagree at step {i}")
        if ta != tb:
            if gap >= MODEL_TOL:
                raise AssertionError(f"greedy tokens differ at step {i} with gap {gap}")
            log(f"  greedy disagreement at step {i} within tolerance (gap {gap:.3e})")
    del params
    torch.cuda.empty_cache()


def phase_train_model() -> None:
    from unittest import mock

    from repro_torch.configs.mamba2_780m import FULL
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import api
    from repro_torch.tree import flatten, tree_map

    cfg = FULL.replace(num_layers=2)
    params = api.init_params(cfg, seed=0, device="cuda")
    micro_batch = TRAIN_ARGS["batch"] // TRAIN_ARGS["microbatches"]
    b = SyntheticTextDataset(cfg.vocab_size, TRAIN_ARGS["seq"], micro_batch).batch_at(0, "cuda")
    batch = {"tokens": b.tokens, "labels": b.labels}

    def loss_and_grads():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = api.loss_fn(leaves, cfg, batch)
        grads = torch.autograd.grad(loss, list(flatten(leaves).values()))
        torch.cuda.synchronize()
        return float(loss.detach()), [g.float() for g in grads]

    n0 = ops.launches
    loss_k, grads_k = loss_and_grads()
    if ops.launches - n0 != cfg.num_layers:
        raise AssertionError(f"K2 ran {ops.launches - n0} times in a {cfg.num_layers}-layer forward")
    with mock.patch.object(ops, "ssd_chunked", ref.ssd_chunked):  # the plain SSD, under autograd
        loss_p, grads_p = loss_and_grads()
    finite = math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k + grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    num = math.sqrt(sum(float((a - b).square().sum()) for a, b in zip(grads_k, grads_p)))
    den = math.sqrt(sum(float(b.square().sum()) for b in grads_p))
    grad_rel = num / den
    log(f"train-model mamba2-780m (2 layers, d_model {cfg.d_model}, bf16), one micro-batch "
        f"{micro_batch} x {TRAIN_ARGS['seq']}: loss K2 {loss_k:.6f} plain {loss_p:.6f} "
        f"(rel {loss_rel:.3e} <= {TRAIN_MODEL_LOSS_TOL:g}), gradients rel_norm_err {grad_rel:.3e} "
        f"(<= {TRAIN_MODEL_GRAD_TOL:g}), finite {finite}")
    if not finite or loss_rel > TRAIN_MODEL_LOSS_TOL or grad_rel > TRAIN_MODEL_GRAD_TOL:
        raise AssertionError("loss or gradients through K2 disagree with the plain SSD")
    del params, grads_k, grads_p
    torch.cuda.empty_cache()


def phase_train() -> int:
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.launch import train

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "train.json")
        argv = ["--arch", "mamba2-780m", "--seed", "0", "--log-every", "1", "--device", "cuda", "--out", out]
        for k, v in TRAIN_ARGS.items():
            argv += [f"--{k}", str(v)]
        ops.launches = 0
        rc = train.main(argv)
        launches = ops.launches
        with open(out) as f:
            s = json.load(f)
    if rc != 0:
        raise AssertionError(f"train exited {rc}")
    want = s["num_layers"] * s["microbatches"] * s["steps"]
    log(f"train mamba2-780m ({s['num_layers']} layers, d_model {s['d_model']}, "
        f"{s['param_count']:,} parameters): {s['steps']} steps of {s['batch']} x {s['seq']} in "
        f"M={s['microbatches']}; loss {s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}; step p50 "
        f"{s['step_ms_p50']:.1f} ms (first {s['step_ms'][0]:.1f} ms), "
        f"{s['tokens_per_second']:,.0f} tokens/s, max_memory_allocated "
        f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  losses {[round(v, 4) for v in s['losses']]}")
    log(f"  grad norms {[round(v, 4) for v in s['grad_norms']]}")
    log(f"SSD launches on the training path: {launches} "
        f"({s['num_layers']} layers x {s['microbatches']} micro-batches x {s['steps']} steps = {want})")
    if launches != want or s["ssd_launches"] != want:
        raise AssertionError("the training path did not run K2 once per layer per micro-batch")
    if not all(math.isfinite(v) for v in s["losses"] + s["grad_norms"]):
        raise AssertionError("non-finite loss or gradient norm")
    if not s["losses"][-1] < s["losses"][0]:
        raise AssertionError("the loss did not fall")
    return launches


def phase_serve() -> int:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve_decode

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "serve.json")
        argv = [
            "--config", "GPT-2.7B", "--slots", "8", "--microbatches", "4",
            "--requests", "16", "--prompt-len", "128", "512", "--new-tokens", "16", "48",
            "--max-len", "576", "--seed", "0", "--device", "cuda", "--out", out,
        ]
        ops.launches = 0
        rc = serve_decode.main(argv)
        launches = ops.launches
        with open(out) as f:
            s = json.load(f)
    if rc != 0:
        raise AssertionError(f"serve_decode exited {rc}")
    log(f"serve GPT-2.7B ({s['num_layers']} layers, d_model {s['d_model']}): "
        f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']} tokens, "
        f"prefill p50 {s['prefill_ms_p50']:.2f} ms, decode tick p50 {s['decode_tick_ms_p50']:.2f} ms, "
        f"{s['tokens_per_second']:.1f} tokens/s, max_memory_allocated "
        f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"flash launches on the serving path: {launches} "
        f"(prefill calls {s['prefill_calls']} x {s['num_layers']} layers)")
    if s["requests_completed"] != s["requests"]:
        raise AssertionError("not every request completed")
    if s["nonfinite_logits"]:
        raise AssertionError("non-finite logits during serving")
    if launches != s["prefill_calls"] * s["num_layers"] or launches == 0:
        raise AssertionError("the serving path did not run the flash kernel once per layer per prefill")
    return launches


def _rel_norm_err(got: list, want: list) -> float:
    """One global ||got - want|| / ||want|| over lists of tensors."""
    num = math.sqrt(sum(float((a.float() - b.float()).square().sum()) for a, b in zip(got, want)))
    return num / math.sqrt(sum(float(b.float().square().sum()) for b in want))


def phase_pipeline_model() -> None:
    import dataclasses

    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.core import ScheduleSpec, make_plan
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.pipeline import StagedModel, reference_pipeline_grads
    from repro_torch.pipeline.engine import stage_body_runs
    from repro_torch.tree import flatten, tree_map

    L, S, M, b, T = PIPE_MODEL
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=L)  # bf16 compute, fp32 parameters
    data = SyntheticTextDataset(cfg.vocab_size, T, M * b).batch_at(0, "cuda")
    tokens, labels = data.tokens.reshape(M, b, T), data.labels.reshape(M, b, T)

    def engine(staged, params, plan):
        loss, grads = reference_pipeline_grads(staged, params, tokens, labels, plan)
        torch.cuda.synchronize()
        return float(loss), [g for ps in grads for g in flatten(ps).values()]

    def oracle(staged, params):
        """Autograd of the mean of the unpipelined full_loss over the micro-batches."""
        leaves = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in params]
        flat = [g for ps in leaves for g in flatten(ps).values()]
        loss, grads = 0.0, [torch.zeros_like(g) for g in flat]
        for m in range(M):
            lm = staged.full_loss(leaves, tokens[m], labels[m]) / M
            for acc, g in zip(grads, torch.autograd.grad(lm, flat, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
            loss += float(lm.detach())
        torch.cuda.synchronize()
        return loss, grads

    cache = {}
    for kw in PIPE_MODEL_PLANS:
        plan = make_plan(S, M, spec=ScheduleSpec(**kw))
        V = plan.total_virtual_stages
        if V not in cache:
            staged = StagedModel.build(cfg, V)
            params = staged.init_all_stages(torch.Generator(device="cuda").manual_seed(0))
            cache.clear()  # one model on the card at a time
            cache[V] = (staged, params, oracle(staged, params))
        staged, params, (loss_o, grads_o) = cache[V]
        ops.launches = 0
        loss_e, grads_e = engine(staged, params, plan)
        launches = ops.launches
        finite = math.isfinite(loss_e) and all(bool(torch.isfinite(g).all()) for g in grads_e)
        loss_rel = abs(loss_e - loss_o) / abs(loss_o)
        grad_rel = _rel_norm_err(grads_e, grads_o)
        log(f"pipeline-model GPT-2.7B ({L} layers, d_model {cfg.d_model}, bf16) S={S} M={M} b={b} T={T} "
            f"plan {plan.name}: loss engine {loss_e:.6f} full_loss {loss_o:.6f} (rel {loss_rel:.3e} <= "
            f"{PIPE_ENGINE_LOSS_TOL:g}), gradients rel_norm_err {grad_rel:.3e} (<= {PIPE_ENGINE_GRAD_TOL:g}), "
            f"K1 launches {launches}, finite {finite}")
        if not finite or loss_rel > PIPE_ENGINE_LOSS_TOL or grad_rel > PIPE_ENGINE_GRAD_TOL:
            raise AssertionError(f"the engine under {plan.name} disagrees with autograd of full_loss")
        want = stage_body_runs(plan) * L // V  # M*L*(2S-1)/S under kfkb
        if kw["kind"] == "kfkb" and want != M * L * (2 * S - 1) // S:
            raise AssertionError(f"the grid of {plan.name} has {want} attention forwards, not M*L*(2S-1)/S")
        if launches != want:
            raise AssertionError(f"K1 ran {launches} times under {plan.name}, the grid has {want} attention forwards")
        if kw == dict(kind="kfkb", k=2):  # the K1 path against the plain attention
            loss_p, grads_p = engine(dataclasses.replace(staged, plain_attention=True), params, plan)
            loss_rel = abs(loss_e - loss_p) / abs(loss_p)
            grad_rel = _rel_norm_err(grads_e, grads_p)
            log(f"pipeline-model {plan.name}, K1 against the plain attention: loss {loss_e:.6f} vs "
                f"{loss_p:.6f} (rel {loss_rel:.3e} <= {PIPE_K1_LOSS_TOL:g}), gradients rel_norm_err "
                f"{grad_rel:.3e} (<= {PIPE_K1_GRAD_TOL:g})")
            if loss_rel > PIPE_K1_LOSS_TOL or grad_rel > PIPE_K1_GRAD_TOL:
                raise AssertionError("the pipeline through K1 disagrees with the plain attention")
            del grads_p
        del grads_e
    cache.clear()
    torch.cuda.empty_cache()


def phase_pipeline() -> int:
    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.core import ScheduleSpec
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train

    cfg = GPT_CONFIGS["GPT-2.7B"]
    ops.launches = 0
    s = train.run_pipeline(
        cfg, PIPE_STAGES, ScheduleSpec(kind="kfkb", k=PIPE_K), seed=0, log_every=1, device="cuda",
        profile=True, **PIPE_ARGS,
    )
    launches = ops.launches
    S, M, L, steps = s["stages"], s["microbatches"], s["num_layers"], s["steps"]
    per_step = M * L * (2 * S - 1) // S
    p = s["profile"]
    log(f"pipeline GPT-2.7B ({L} layers, d_model {s['d_model']}, vocab {s['vocab_size']}, "
        f"{s['param_count']:,} parameters) in S={S} stages, plan {s['plan']}: {steps} steps of "
        f"{s['batch']} x {s['seq']} in M={M}; loss {s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}; "
        f"step p50 {s['step_ms_p50']:.1f} ms (first {s['step_ms'][0]:.1f} ms), "
        f"{s['tokens_per_second']:,.0f} tokens/s, max_memory_allocated "
        f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"  losses {[round(v, 4) for v in s['losses']]}")
    log(f"  grad norms {[round(v, 4) for v in s['grad_norms']]}")
    log(f"  profiled step: wall {p['wall_ms']:.3f} ms, device busy {p['device_ms']:.3f} ms "
        f"({100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms "
        f"({100 * p['flash_ms'] / p['device_ms']:.1f}% of the device time)")
    for op in p["top"]:
        log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    log(f"flash launches on the pipeline path: {launches} over {steps} + 2 steps (the timed steps, then "
        f"the profiled step run once untraced and once traced); {s['flash_launches']} in the timed "
        f"steps, M*L*(2S-1)/S = {per_step} a step")
    if s["flash_launches"] != per_step * steps or launches != per_step * (steps + 2):
        raise AssertionError("the pipeline path did not run K1 M*L*(2S-1)/S times a step")
    if not all(math.isfinite(v) for v in s["losses"] + s["grad_norms"]):
        raise AssertionError("non-finite loss or gradient norm")
    if not s["losses"][-1] < s["losses"][0]:
        raise AssertionError("the loss did not fall")
    return launches


def phase_adaptive() -> int:
    import gc

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train_adaptive

    ops.launches = 0
    sc = train_adaptive.build_fig10_scenario(device="cuda", **ADAPTIVE_ARGS)
    summary = sc.coordinator.run(ADAPTIVE_ITERATIONS)
    launches = ops.launches
    s = train_adaptive.summarize(sc, summary)
    sc.runtime.cache.wait_idle()
    sc.runtime.cache.shutdown()
    cfg, rt = sc.cfg, sc.runtime
    log(f"adaptive {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}) in S="
        f"{rt.num_stages} stages, global batch {sc.global_batch} x {rt.seq_len}: {s['iterations']} iterations, "
        f"{s['kind_switches']} kind switches, precompile hit rate {s['precompile_hit_rate']:.2f} "
        f"(cache {s['cache']}), warm switch {100 * s['warm_switch_latency_frac']:.3f}% of an iteration")
    log("  decision trail: " + ", ".join(f"t={d['t']} {d['chosen']}" for d in s["decision_trail"]))
    log(f"  losses {s['losses']}")
    for e in s["switch_events"]:
        log(f"  switch at iteration {e['iteration']}: {e['from_plan'] or '-'} -> {e['to_plan']}, "
            f"{1e3 * e['seconds']:.3f} ms, restacked {e['restacked']}, warm {e['warm']}")
    for i, r in enumerate(s["per_iteration"]):
        log(f"  iteration {i:2d} {r['plan']:22s} {1e3 * r['seconds']:9.1f} ms, loss {r['loss']:.4f}, K1 "
            f"{r['flash_launches']} (grid: {r['attention_forwards']}), max_memory_allocated "
            f"{r['max_memory_allocated'] / 2**30:.2f} GiB")
    for name, p in s["per_plan"].items():
        log(f"  plan {name}: {p['iterations']} iterations, step p50 {p['step_ms_p50']:.1f} ms, "
            f"max_memory_allocated {p['max_memory_allocated'] / 2**30:.2f} GiB, K1 a step {p['flash_launches']}")
    log(f"flash launches on the adaptive path: {launches}")
    want_trail = train_adaptive.engine_free_decision_trail(
        ADAPTIVE_ITERATIONS, num_stages=rt.num_stages, seed=ADAPTIVE_ARGS["seed"]
    )
    if s["decision_trail"] != want_trail:
        raise AssertionError(f"the decision trail differs from the engine-free one: {want_trail}")
    if s["kind_switches"] < 2 or not any(e["restacked"] for e in s["switch_events"]):
        raise AssertionError("fewer than two kind switches, or none across the v = 1 <-> 2 boundary")
    if not s["warm_switch_latency_frac"] < 0.05:
        raise AssertionError("a warm switch took 5% of an iteration or more")
    if s["precompile_hit_rate"] < 0.8 or s["cache"]["cold_misses"]:
        raise AssertionError("precompile hit rate under 0.8, or a cold miss")
    if not all(math.isfinite(v) for v in s["losses"]):
        raise AssertionError("non-finite loss")
    for i, r in enumerate(s["per_iteration"]):
        if r["flash_launches"] != r["attention_forwards"]:
            raise AssertionError(f"iteration {i}: K1 ran {r['flash_launches']} times, the grid of "
                                 f"{r['plan']} has {r['attention_forwards']} attention forwards")
    if launches != sum(r["flash_launches"] for r in s["per_iteration"]):
        raise AssertionError("K1 launches outside the iterations of the adaptive path")
    # where the final plan's step time goes: one more step, untimed by the
    # profiler and then traced
    from repro_torch.launch.profiling import device_profile

    batch = sc.dataset.batch_at(1000, rt.device)
    wall_ms = 1e3 * rt.run_iteration(batch.tokens, batch.labels).seconds
    prof = device_profile(lambda: rt.run_iteration(batch.tokens, batch.labels), rt.device, {"flash": "flash_fwd"})
    log(f"  profiled step of {rt.current_table.plan.name}: wall {wall_ms:.3f} ms, device busy "
        f"{prof['device_ms']:.3f} ms ({100 * prof['device_ms'] / wall_ms:.1f}%), K1 {prof['flash_ms']:.3f} ms "
        f"({100 * prof['flash_ms'] / prof['device_ms']:.1f}% of the device time)")
    for op in prof["top"][:8]:
        log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    # the switched and restacked state's gradients; the optimizer state and
    # the last gradients go first, to leave room for the oracle's
    rt.state.opt_state = rt.last_grads = None
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_adaptive.grad_parity(sc)
    log(f"adaptive gradients on the final state ({rt.current_table.plan.name}, v={rt.current_v}, after "
        f"{sum(e.restacked for e in rt.switch_events)} restacks) against autograd of full_loss: "
        f"rel_norm_err {parity['rel_norm_err']:.3e} (<= {ADAPTIVE_GRAD_TOL:g}), max_abs_err "
        f"{parity['max_abs_err']:.3e}, finite {parity['finite']}")
    if not parity["finite"] or parity["rel_norm_err"] > ADAPTIVE_GRAD_TOL:
        raise AssertionError("the engine's gradients on the switched state disagree with autograd of full_loss")
    del sc, rt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=",".join(PHASES), help="comma-separated phases to run")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    unknown = set(only) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    device = phase_device()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    kernels = {}
    for name in PHASES[1:]:
        if name not in only:
            continue
        t = time.perf_counter()
        log(f"== phase {name}")
        if name == "build":
            phase_build()
        elif name == "kernels":
            kernels = phase_kernels()
        elif name == "model":
            phase_model()
        elif name == "train-model":
            phase_train_model()
        elif name == "serve":
            launches = phase_serve()
            if kernels:
                kernels["flash"]["per_path"]["serve"]["launches"] = launches
        elif name == "train":
            launches = phase_train()
            if kernels:
                kernels["ssd"]["launches"] = launches
        elif name == "pipeline-model":
            phase_pipeline_model()
        elif name == "pipeline":
            launches = phase_pipeline()
            if kernels:
                kernels["flash"]["per_path"]["pipeline"]["launches"] = launches
        elif name == "adaptive":
            launches = phase_adaptive()
            if kernels:
                kernels["flash"]["per_path"]["adaptive"]["launches"] = launches
        log(f"== phase {name} done in {time.perf_counter() - t:.1f} s")
    log(f"all phases {time.perf_counter() - t0:.1f} s")
    if set(only) != set(PHASES):
        return 0  # a partial run prints no result
    kernels["flash"]["launches"] = sum(p["launches"] for p in kernels["flash"]["per_path"].values())
    log(json.dumps({"kernels": [kernels["flash"], kernels["ssd"]]}))
    log(device["smi"])
    log(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
