"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only device,build,kernels

Phases, in order (any failure exits non-zero, and no result line is printed):

1. device   the card's name and power limit, as nvidia-smi reports them
2. build    nvcc builds the CUDA kernels from the sources in this checkout
3. kernels  each kernel against its plain PyTorch version on the card, at the
            serving shapes and at the edge cases, then timed beside the plain
            version and the PyTorch library call (yardstick only)
4. model    a 2-layer, full-width GPT-2.7B: prefill + 4 decode steps through
            the kernel and through the plain attention; logits and greedy
            tokens agree
5. serve    GPT-2.7B at full width and depth served through
            ``repro_torch.launch.serve_decode``: 16 requests over 8 slots on
            an M=4 x b=2 grid; every request completes, no NaN, and the
            flash kernel ran once per layer per prefill

The line before the last is a JSON object with every kernel's figures; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "model", "serve")

#: published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

#: kernel vs plain version, as allclose(atol=tol, rtol=tol).  bf16/fp16: the
#: FLASH_CASES tolerance of repro's kernel tests (one output rounding plus
#: P rounded to the input type at another point of the softmax).  fp32: both
#: sides compute in fp32 and differ only in summation order and exp, a few
#: ulp of the fp32 output.
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
# serving shapes of GPT-2.7B prefill (333 tests the ragged tile edge)
FLASH_CASES = [
    ("gpt2.7b_t128", 1, 128, 128, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_t333", 1, 333, 333, 32, 32, 80, torch.bfloat16, True, None),
    ("gpt2.7b_t512", 1, 512, 512, 32, 32, 80, torch.bfloat16, True, None),
    ("fp32", 1, 333, 333, 8, 8, 80, torch.float32, True, None),
    ("fp16", 2, 200, 200, 8, 8, 80, torch.float16, True, None),
    ("t_lt_s", 1, 100, 333, 32, 32, 80, torch.bfloat16, True, None),
    ("window", 1, 512, 512, 32, 32, 80, torch.bfloat16, True, 128),
    ("gqa", 2, 333, 333, 32, 8, 80, torch.bfloat16, True, None),
    ("noncausal", 1, 200, 333, 8, 8, 80, torch.bfloat16, False, None),
    ("hd64", 1, 333, 333, 16, 16, 64, torch.bfloat16, True, None),
    ("hd96", 1, 333, 333, 16, 16, 96, torch.bfloat16, True, None),
    ("hd128", 1, 333, 333, 16, 16, 128, torch.bfloat16, True, None),
]
TIMED_CASE = "gpt2.7b_t512"


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
    from repro_torch.kernels.flash_attention import ops

    b = build.build(ops.SOURCE)
    ops._kernel()  # load and bind it
    log(f"build {os.path.relpath(b.source, ROOT)}: {b.seconds:.1f} s")
    for line in b.ptxas_lines():
        log(f"  {line}")


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


def _flash_bound_ms(B, T, S, H, K, hd, dtype, causal, window) -> tuple[float, str]:
    """max(bytes / HBM rate, FLOPs / peak) for the pairs this mask keeps."""
    from repro_torch.kernels.flash_attention import ref

    pairs = int(ref.causal_window_mask(T, S, causal, window).sum())
    flops = 4.0 * hd * pairs * B * H  # q.k and p.v, 2 FLOP per MAC
    nbytes = (2 * B * T * H * hd + 2 * B * S * K * hd) * torch.finfo(dtype).bits / 8
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels() -> dict:
    from repro_torch.kernels.flash_attention import ops, ref

    timed = None
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
            f"{str(dtype).split('.')[-1]} causal={causal} window={window}: "
            f"max_abs_err {err:.3e} (allclose atol=rtol={tol:g}), "
            f"rel_norm_err {rel:.3e} (<= {rel_tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version on {name}")
        if name == TIMED_CASE:
            timed = (B, T, S, H, K, hd, dtype, causal, window, q, k, v, err)

    B, T, S, H, K, hd, dtype, causal, window, q, k, v, err = timed
    ms = _time_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
    plain_ms = _time_ms(lambda: ref.attention(q, k, v, causal=causal, window=window))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    )
    bound_ms, bound_by = _flash_bound_ms(B, T, S, H, K, hd, dtype, causal, window)
    log(f"flash timing at {TIMED_CASE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:99",
        "launches": None,  # filled from the serve phase (the main path)
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


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
    kernel = None
    for name in PHASES[1:]:
        if name not in only:
            continue
        t = time.perf_counter()
        log(f"== phase {name}")
        if name == "build":
            phase_build()
        elif name == "kernels":
            kernel = phase_kernels()
        elif name == "model":
            phase_model()
        elif name == "serve":
            launches = phase_serve()
            if kernel is not None:
                kernel["launches"] = launches
        log(f"== phase {name} done in {time.perf_counter() - t:.1f} s")
    log(f"all phases {time.perf_counter() - t0:.1f} s")
    if set(only) != set(PHASES):
        return 0  # a partial run prints no result
    log(json.dumps({"kernels": [kernel]}))
    log(device["smi"])
    log(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
