"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --only device,build,kernels

Phases, in order (any failure exits non-zero, and no result line is printed):

1. device       the card's name and power limit, as nvidia-smi reports them,
                and the host: its CPU model, logical cores, and the torch,
                CUDA and Python versions (every wall time below is the
                host's as much as the card's)
2. build        nvcc builds the CUDA kernels (K1 flash attention, K2 SSD scan)
                from the sources in this checkout, one nvcc per source, in
                parallel
3. kernels      each kernel against its plain PyTorch version on the card, at
                the main paths' shapes and at the edge cases (each case logs
                the route it took: "mma", tensor cores, or "fma"), then timed
                beside the plain version and the PyTorch library call
                (yardstick only; K2 has none); K1 at all four serving
                lengths (16 tokens: serve-adaptive's prompts, under one
                query tile) and at the dense archs' shapes: gemma3-12b's
                local (window 1024) and global layers at hd 256 with 16
                heads over 8 (T 1536; T 2048 for train-dense), qwen2.5-14b's
                GQA prefill (40 heads over 8 at hd 128, B 2 x T 512), hd 256
                on fp32 (the fma route) and fp16; the MoE and hybrid archs:
                kimi-k2's GQA 64 over 8 at hd 112 (T 512, and T 2048 for
                train-moe), hd 112 on fp32 (the fma route), jamba's 32 over
                8 at hd 128 (T 512); the encoder-decoder and VLM archs:
                seamless-m4t-medium's bidirectional encoder (B 4 x T 128,
                16 heads of 64), causal decoder (T 1024) and cross attention
                (T 1024 over S 128, not causal), qwen2-vl-2b's GQA 12 over
                2 at hd 128 (B 2 x T 2048); K2 at jamba's (P 64, N 16, Q
                64) with 128 heads (T 2048, and fp32); the build logs each
                kernel's registers and spill bytes (nvcc -Xptxas -v)
4. model        a 2-layer, full-width GPT-2.7B: prefill + 4 decode steps
                through K1 and through the plain attention; logits and greedy
                tokens agree; each layer's K1 output in the prefill, at every
                position, holds the plain version on that layer's q/k/v, and
                K1 on the same inputs with a planted fault (KV heads shifted
                by one; on a windowed layer, the window dropped) must fail
                that gate
4a. model-dense
                the same check at full width on the dense archs:
                qwen2.5-14b cut to 2 layers (a prefill of 300 tokens) and
                gemma3-12b cut to one 5:1 period of 6 layers (a prefill of
                1100 tokens, past the 1024-token window, so the local
                layers' ring buffers wrap), 4 decode steps each; K1 once per
                layer of each prefill; the logits held to an fp32 run, and
                the per-layer gate and its planted faults as in ``model``
5. train-model  a 2-layer, full-width mamba2-780m: loss and gradients of one
                micro-batch through K2 and through the plain SSD agree (the
                gradient gap under 2e-2 and under 1.5 x that of K2's sound
                peer, the plain SSD forward in TF32; a planted fault fails)
6. serve        GPT-2.7B at full width and depth (32 layers) served through
                ``repro_torch.launch.serve_decode``: 16 requests over 8 slots
                on an M=4 x b=2 grid (repro's static 1F1B baseline, admissions
                on its simulated prices); every request completes, no NaN,
                and K1 ran once per layer per prefill
6a. serve-adaptive
                Ada-Grouper's adaptive serving: ``launch/serve_adaptive``'s
                adaptive-vs-static comparison (repro's Fig-10 serving world,
                24 requests, seed 0, ticks priced on specs/h100-sxm.json)
                with GPT-2.7B (full width, 16 layers) behind each run, every tuner
                decision switched live into the engine through the
                stateless PlanRuntime.  Gates: every request completes with
                exactly its max_new_tokens; no non-finite logit; every
                simulated number (the decision trail, the quantiles) equals
                the engine-free run's, and the trail crosses >= 2 kinds; the
                bursty and exclusive regimes end on different plans; each
                plan built once (cache misses = distinct plans dispatched,
                every later switch a hit); K1 = prefills x 16 layers; every
                request's first token equal in both runs.  The simulated
                TTFT/token-latency p99 and SLO attainment, and the measured
                prefill and per-plan decode tick p50, wall tokens/s, switch
                seconds, peak memory and a traced tick are printed.  Last,
                the engines are dropped: torch.cuda.memory_allocated must
                fall before any garbage collection (no reference cycle
                keeps an engine's weights)
6b. serve-ssm   mamba2-780m at full width and depth (48 layers) through
                ``serve_decode`` (8 slots,
                M=4, 8 requests, prompts 16-32, 16-32 new tokens, max_len
                64): every request completes, no non-finite logit, K2 never
                runs (SSM serving is the recurrence); one request's fused
                prefill bitwise equal, logits and state, to stepping
                mamba_decode over its prompt on the card; a traced tick
6c. serve-dense
                qwen1.5-4b, qwen2.5-14b, internlm2-20b and gemma3-12b at
                full width and half depth (20, 24, 24, 24 layers), one
                after the other, through ``serve_decode
                --config <arch id>`` (8 slots on M=4 x b=2, 8 requests,
                16-32 new tokens; prompts 128-512 and max_len 544, gemma3's
                1024-1536 past its window and max_len 1568), the weights
                drawn and cast a layer at a time: every request completes
                with finite logits; K1 = prefills x layers; the peak, setup
                and serving, under the bf16 weights + the cache + 4 GiB;
                once serve_decode returned, memory_allocated is back within
                256 MiB of where it was, before any collection; a traced
                decode tick and longest-prompt prefill of each are printed
7. train        mamba2-780m at full width and depth trained through
                ``repro_torch.launch.train``: 6 steps of batch 8 x 1024 tokens
                in M=2 micro-batches; K2 ran once per layer per micro-batch,
                and the loss is finite and falls, with finite gradient norms
7a. train-dense
                ``launch.train.train`` (--mode spmd) at full width, 4 steps
                and one traced: gemma3-12b cut to 6 layers (b 1 x T 2048,
                M=1: past the window, the global layer included) and
                qwen1.5-4b cut to 24 of 40 layers (b 2 x T 1024, M=2);
                finite losses and clip norms; every parameter leaf changed
                by the steps; K1 = layers x micro-batches x steps (the
                backward recomputes the plain attention)
7b. model-moe
                the model check at full width on the MoE and hybrid archs:
                jamba-v0.1-52b cut to one 8-layer period (attention at layer
                4, MoE on the odd layers), kimi-k2 to its dense prefix layer
                and one MoE layer (384 experts, top-8 sigmoid, a shared
                expert), llama4-maverick to 2 layers (dense, then 128
                experts top-1 with a shared expert); a prefill of 300 tokens
                and 4 decode steps through K1 and through the plain
                attention: K1 once per attention layer, each layer's K1
                output and its planted fault as in ``model``, greedy tokens
                equal (a top-2 tie reported), the logits reported (a
                rounding may move a token across a top-k boundary); each
                MoE layer's prefill output held to a per-expert fp32 loop
                on a routing recomputed apart from the port's (top-k of the
                fp32 scores, weights the scores over their sum, entries
                kept by a running count per expert against the capacity),
                its dropped_frac equal to the count's, and the loop with
                the experts shifted by one (a planted fault) rejected
7c. serve-moe   the three at full width through ``serve_decode`` (8 slots on
                M=4 x b=2, 8 requests, 16-32 new tokens; each decode row
                routed as its own MoE group): jamba cut to 16 layers (two
                periods, prompts 16-32: its Mamba layers prefill a token at
                a time), kimi-k2 and llama4 at 2 layers (prompts 128-512),
                the weights drawn and cast an expert bank at a time; every
                request completes with finite logits; K1 = prefills x
                attention layers; the serving peak under the bf16 weights +
                cache + 1.5 GiB, the setup's under that plus one fp32 expert
                bank; nothing left allocated once serving returns; a traced
                tick and longest-prompt prefill of each
7d. train-moe   ``launch.train.train`` at full width, one device, 4 steps and
                2 traced of b 1 x T 2048: jamba cut to layers 0-4 with 4 of
                its 16 experts (AdamW), kimi-k2 to 2 layers with 16 of its
                384 experts (Adafactor, top-8 kept); finite losses, clip
                norms and MoE terms; every parameter leaf changed; K1 and
                K2 launches = attention and Mamba2 layers x steps; first,
                jamba's first micro-batch through K2 and through the plain
                SSD (the loss under train-model's limit, the gradient gap
                under 1.5 x that of K2's sound peer, the plain SSD forward in
                TF32, and a planted fault failing it; the MoE routing of the
                other runs pinned to K2's, the moved top-k choices printed)
7e. model-encdec-vlm
                seamless-m4t-medium and qwen2-vl-2b at full size (bf16,
                seed 0): a forward of B 2 x T 512 target tokens over 64
                source frames (seamless), and of 512 patch embeddings at
                three M-RoPE position streams (qwen2-vl: a 16 x 16 image
                grid, then text), through K1 and through the plain
                attention, both held to an fp32 run of the same weights
                (K1's largest logit error at most MODEL_ORACLE_FACTOR x the
                plain bf16 run's, over every position); K1 once per encoder,
                decoder and cross attention layer (12 + 12 + 12; 28); each
                layer's K1 output held to the plain version with the
                planted faults rejected, as in ``model``; then
                MODEL_ENCDEC_VLM_DECODE tokens stepped through
                ``api.decode_fn`` (seamless against the memory of
                ``_encode(src)``, qwen2-vl over token embeddings at equal
                streams) held to the teacher-forced forward under the same
                gate, greedy tokens equal (or a top-2 gap under MODEL_TOL);
                decode launches no K1
7f. train-encdec-vlm
                ``launch.train.train`` at full size and depth, AdamW at lr
                1e-4, 4 steps and 2 traced: seamless-m4t-medium (b 4 x T
                1024 over 128 frames) and qwen2-vl-2b (b 2 x T 2048);
                finite losses and clip norms, the first batch's loss lower
                after the steps than before them (the steps' own losses,
                each on its own batch, part by more than 3 updates at lr
                1e-4 move them), every leaf changed, K1 = layers x
                micro-batches x steps by kind
                (encoder, decoder, cross); then the checkpoint check:
                qwen2-vl-2b at full width cut to CKPT_CHECK's depth trained
                4 steps with ``--ckpt-every 2``, its last checkpoint
                removed, and the run resumed from step 2: the resumed
                losses and final parameter norm equal the unbroken run's,
                bitwise
8. pipeline-model
                a 4-layer, full-width GPT-2.7B in S=2 stages, M=4 micro-batches
                of 1 x 512 tokens: the reference pipeline engine's loss and
                gradients under kfkb k=1, kfkb k=2, zb_h1 (saved residuals),
                zb_h2 (w=2), interleaved (v=2) and interleaved_zb (v=2)
                against autograd of the unpipelined ``full_loss``; the K1
                path against the plain attention; K1 launches in every run
                equal the attention forwards of the plan's grid
                (M*L*(2S-1)/S under kfkb)
9. pipeline     GPT-2.7B at full width cut to GPT_LAYERS = 16 trained through
                ``repro_torch.launch.train.run_pipeline`` on the one-process
                reference engine (``engine="reference"``): S=4 stages under
                kfkb k=2, M=8 micro-batches of 1 x 1024 tokens, 6 steps and
                one profiled step; the loss is finite and falls, and K1 ran
                M*L*(2S-1)/S = 224 times a step
10. calibrate   GPT-2.7B at full width and depth calibrated through
                ``repro_torch.launch.dryrun_pipeline.calibrate`` (S=4, the
                adaptive phase's micro-batch b=2 x T=1024, seed 0), once
                priced on specs/h100-sxm.json (the four task programs of each
                stage counted on the meta device, the offline tune) and once
                timed with CUDA events on the card (K1 in every stage
                forward).  Gates: finite, positive counts and seconds; each
                program counted through K1 on the card moves the bytes the
                record counted on meta, and counts the FLOPs counted through
                the plain attention (fwd) or those plus one plain attention
                forward a layer (the backward programs' recompute); each fwd
                equals its closed form; the last stage's bwd_input and
                bwd_weight exceed every middle stage's and bwd_weight_saved <
                bwd_weight everywhere, under both methods; K1 launched
                S * L/S * 4 programs * (warmup + repeats) times in the
                wall-clock run.  Spec and wall-clock ms per program with the
                spread of the timed runs, the warmup vectors and the
                tuner's choice on both costs are printed
11. adaptive    Ada-Grouper's plan-switch loop: GPT-2.7B at full width cut
                to GPT_LAYERS = 16 trained through
                ``repro_torch.launch.train_adaptive``'s
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
12. ranks-model the multi-rank engine (one process per stage) on the
                pipeline-model cut (4 layers, full width, S=2 ranks, M=4 x
                1 x 512) under pipeline-model's plans and zbv: the gradients
                gathered to rank 0 against autograd of ``full_loss``, and
                beside the one-process engine's; K1 launches summed over the
                ranks equal the grid's attention forwards
13. ranks       GPT-2.7B at full width trained through
                ``repro_torch.launch.train.run_pipeline`` on S=4 ranks (kfkb
                k=2, M=8 micro-batches of 1 x 1024 tokens, 6 steps, seed 0),
                all 32 layers on four cards, cut to RANKS_ONE_CARD_LAYERS =
                8 on one: the first loss equals the one-process engine's at
                that depth, the loss falls, K1 ran M*L*(2S-1)/S times a step
                summed over the ranks (112 at 8 layers);
                the transport, the card count and each rank's breakdown
                (compute, blocked in receives and sends, staging copies,
                the replicated reduce, read from CUDA events) are printed,
                and one more step, traced on rank 0.  With one card the
                ranks run under gloo through pinned host buffers and share
                the card by time-slicing: a correctness check on the card,
                not a deployment's step time.  Under four cards they run
                under NCCL, a card each.
14. adaptive-ranks-model
                PlanRuntime's spmd backend on GPT-2.7B at full width cut to
                8 layers, S=4 ranks, M=4 micro-batches of 2 x 1024 tokens,
                one iteration each of kfkb k=1, zb_h1, interleaved_zb v=2,
                zbv and kfkb k=1, at lr 0 but for the last step's 1e-3 (the
                restacks move layers at v 1 -> 2, looped -> V-shaped at
                v = 2, and 2 -> 1): each iteration's loss, and its params,
                m, v and gradients each apart, against the one-process
                engine with the copies' gradients summed (compared through
                random projections of every leaf, gathered to rank 0), the
                last step's update too; the last gradients against autograd
                of full_loss; K1
                launches summed over the ranks equal the grid's attention
                forwards
15. adaptive-ranks
                the adaptive phase's Fig-10 scenario through
                ``train_adaptive.run_fig10_spmd`` on S=4 ranks (one card:
                gloo, the ranks time-slicing it; four cards: NCCL, a card a
                rank; ADAPTIVE_RANKS_ONE_CARD_LAYERS cuts the depth on one
                card): the decision trail equals the engine-free one; >= 2
                kind switches, restacks both ways; precompile hit rate >=
                0.8 and no cold miss; finite losses, the first equal to the
                one-process loop's at the same depth (the adaptive phase's,
                or its first iteration run here); K1 summed over the ranks
                as often as each iteration's grid says; the final state's
                gradients, gathered to rank 0 with the optimizer state
                freed, against autograd of full_loss.  Per plan the step
                p50 and each rank's
                breakdown, per switch its seconds and each rank's bytes, and
                the warm-switch fraction (not gated: the restack goes
                through gloo's host buffers on one card) are printed.
16. fabric      Ada-Grouper's coordinator-worker fabric in one process:
                ``train_adaptive.build_fabric_fleet`` with two GPT-2.7B
                hosts at full width cut to FABRIC_LAYERS = 8 layers (S=4, M=4 x
                2 x 1024, each a whole replica on its own data shard),
                driven by ``run_fabric_rounds`` for FABRIC_ROUNDS rounds
                under a scripted trail kfkb k=1 -> ZB-H2(w=2) ->
                interleaved_zb (v=2) -> kfkb k=1, then a spec that the
                first host to see it refuses; the tuner runs on the hosts'
                wall times beside it (its decisions printed, not gated).
                Gates: every committed epoch applied on both hosts at its
                boundary; every telemetry window's spec the incumbent at its
                iteration; the refused epoch an ABORT, both hosts on the
                incumbent; 3 commits and 1 abort; the v-changing switches
                restack; finite losses; K1 launches in each host's each
                iteration equal to its grid's attention forwards, and the
                phase's total their sum.  Then the fleet is freed and host0's
                shard runs alone in a fresh runtime, switched by hand at the
                same boundaries: its losses within 5e-6 of host0's and its
                parameter digest within a relative 1e-6 (repro's limits;
                bitwise expected, the largest difference printed).  Barrier latency, each host's prepare-to-vote
                seconds, switch seconds, per-plan step p50 and peak memory
                a host are printed
17. fabric-tcp  the fabric across processes: a ``CoordinatorListener`` here
                and two ``python -m repro_torch.launch.fabric_worker``
                processes on the card (GPT-2.7B at full width cut to
                FABRIC_TCP_LAYERS = 8 layers, S=4), one scripted switch kfkb
                k=1 -> interleaved_zb (v=2).  Gates: both workers exit 0
                within FABRIC_TCP_TIMEOUT and none is left running; one
                commit, applied at the same boundary on both, both ending on
                the target; 2 x FABRIC_TCP_ITERATIONS telemetry windows;
                finite losses; each worker's K1 launches equal to its grid's
                attention forwards.  Both share the card by time-slicing:
                their wall times are a check, not a deployment's
18. spmd        repro's sharded train step (distributed/spmd.py) on
                qwen2.5-14b at full width, four ranks on a (2, 2) ("data",
                "model") mesh, one process a rank (SPMD_FOUR: a card a rank,
                NCCL, all 48 layers, zero3 then tp_fsdp with per-layer remat,
                b 8 x T 2048 in M=2, 4 steps and one traced; SPMD_ONE: gloo
                through pinned host buffers on one card, 2 layers, one step
                of b 4 x T 512 in M=1 under zero3 and under tp_fsdp with
                gather_params_once).  Gates: every rank's
                local shards are the rules' shapes; the ranks agree on the
                loss; on one card the loss and clip norm equal the
                one-process make_train_step's over the same row groups, and
                each leaf group's step-1 update and AdamW m and v (digests;
                AdamW at eps SPMD_DIGEST_EPS); on four cards (no card holds
                the training state) the first loss equals a one-process
                forward on the serving weights, and zero3's and tp_fsdp's
                losses and clip norms agree step by step (SPMD_CROSS_TOL);
                finite losses and norms; K1 per rank = layers x
                micro-batches x steps x 2
                (the remat runs each forward again); on four cards every
                rank's peak under 80 GiB.  Per rank: step p50, tokens/s,
                max_memory_allocated, and a step's seconds in gathers,
                reduce-scatters, all-reduces, staging and the rest

Every rank is a fresh process whose kernel counters start at 0; it reads
them after its run and returns them.

The line before the last is a JSON object with every kernel's figures (K1's
also per main path: serving, adaptive serving, pipeline training, the
calibration, the adaptive loop, the ranks, the adaptive loop on the
ranks, the fabric in one process and across two, the sharded step, the
dense archs' model check, serving and training, the MoE and hybrid archs', and the
encoder-decoder and VLM archs' model check and training, each at its own
shape; K2's per main path: train and train-moe);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
import gc
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = (
    "device", "build", "kernels", "model", "model-dense", "train-model", "serve", "serve-adaptive", "serve-ssm",
    "serve-dense", "train", "train-dense", "model-moe", "serve-moe", "train-moe", "model-encdec-vlm",
    "train-encdec-vlm", "pipeline-model", "pipeline", "calibrate", "adaptive", "ranks-model", "ranks", "adaptive-ranks-model",
    "adaptive-ranks", "fabric", "fabric-tcp", "spmd",
)

#: the device spec of one H100 SXM (published dense peaks at its 700 W
#: limit), read by the port's loader: bytes/s of HBM, and FLOP/s per input
#: type with TF32 (the tensor cores on fp32 operands rounded to 10 mantissa
#: bits) apart
H100_SPEC = os.path.join(ROOT, "specs", "h100-sxm.json")

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
#: model-dense: the absolute limit above does not carry to other logit
#: scales and depths (qwen2.5-14b's untied head over d 5120 gives logits of
#: rms 1.43, gemma3-12b's 6 layers and 262,144 logits a longer tail: on an
#: H100 the K1 and plain bf16 runs part by 0.0625 and 0.087 at their
#: prefills, 2-3 bf16 ulps at |logit| 4-8).  So both bf16 runs are held to an fp32 run of the
#: same weights: K1's largest logit error there at most twice the plain
#: version's.  Both round the probabilities to bf16 once, at other points
#: of the softmax, so their errors are of one size; a wrong mask, window or
#: KV head would put K1's at the logits' own scale (rms ~1.2-1.4)
MODEL_ORACLE_FACTOR = 2.0
#: model and model-dense: greedy decode steps after the prefill
MODEL_DECODE_STEPS = 4
#: model-dense: (arch, layers, prompt tokens) at full width: qwen2.5-14b cut
#: to 2 layers (GQA 40 over 8 at hd 128, QKV bias); gemma3-12b cut to one
#: 5:1 period of 6 layers, its prompt past the 1024-token window so that the
#: local layers' ring buffers wrap
MODEL_DENSE = (("qwen2.5-14b", 2, 300), ("gemma3-12b", 6, 1100))

# (name, B, T, S, H, K, hd, dtype, causal, window); the first is the
# serve-adaptive phase's prefill (16 tokens, under one query tile), the next
# three the serving shapes of GPT-2.7B prefill (333 tests the ragged tile
# edge), then one micro-batch of the pipeline phase and one of the adaptive
# phase
FLASH_CASES = [
    ("gpt2.7b_t16", 1, 16, 16, 32, 32, 80, torch.bfloat16, True, None),
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
    # the dense archs: gemma3-12b's local (window 1024) and global layers at
    # hd 256 with 16 heads over 8 KV heads, past the window so that the loop
    # range cuts tiles on both sides, and one train-dense micro-batch;
    # qwen2.5-14b's serving prefill (GQA 40 over 8 at hd 128); hd 256 on the
    # fma route (fp32) and on fp16 with T < S
    ("gemma3-12b_local_t1536", 1, 1536, 1536, 16, 8, 256, torch.bfloat16, True, 1024),
    ("gemma3-12b_global_t1536", 1, 1536, 1536, 16, 8, 256, torch.bfloat16, True, None),
    ("gemma3-12b_train_t2048", 1, 2048, 2048, 16, 8, 256, torch.bfloat16, True, 1024),
    ("qwen2.5-14b_gqa_b2_t512", 2, 512, 512, 40, 8, 128, torch.bfloat16, True, None),
    ("fp32_hd256", 1, 200, 200, 4, 2, 256, torch.float32, True, 64),
    ("fp16_hd256_t_lt_s", 1, 100, 333, 8, 4, 256, torch.float16, True, None),
    # the MoE and hybrid archs: kimi-k2's GQA 64 over 8 at hd 112 (its
    # serving prefill, and one train-moe micro-batch), hd 112 on the fma
    # route (fp32), jamba's attention layers (32 over 8 at hd 128)
    ("kimi-k2_gqa_t512", 1, 512, 512, 64, 8, 112, torch.bfloat16, True, None),
    ("kimi-k2_train_t2048", 1, 2048, 2048, 64, 8, 112, torch.bfloat16, True, None),
    ("fp32_hd112", 1, 200, 200, 8, 1, 112, torch.float32, True, None),
    ("jamba_gqa_t512", 1, 512, 512, 32, 8, 128, torch.bfloat16, True, None),
    # the encoder-decoder and VLM archs at their train-encdec-vlm shapes:
    # seamless-m4t-medium's bidirectional encoder (128 frames), causal
    # decoder and cross attention (1024 queries over 128 frames, not
    # causal), all 16 heads of 64; qwen2-vl-2b's GQA 12 over 2 (r = 6) at hd 128
    ("seamless_enc_b4_t128", 4, 128, 128, 16, 16, 64, torch.bfloat16, False, None),
    ("seamless_dec_b4_t1024", 4, 1024, 1024, 16, 16, 64, torch.bfloat16, True, None),
    ("seamless_cross_b4_t1024_s128", 4, 1024, 128, 16, 16, 64, torch.bfloat16, False, None),
    ("qwen2-vl_gqa6_b2_t2048", 2, 2048, 2048, 12, 2, 128, torch.bfloat16, True, None),
    # the spmd phase's qwen2.5-14b on one rank's rows: one row of T 2048 (zero3
    # on four cards)
    ("qwen2.5-14b_spmd_t2048", 1, 2048, 2048, 40, 8, 128, torch.bfloat16, True, None),
]
TIMED_CASE = "gpt2.7b_t512"
#: the serve-adaptive phase's GPT-2.7B, at full width cut to 16 of its 32
#: layers; the pipeline and adaptive phases' too, and the ranks' on fewer
#: cards than ranks (the cuts that keep the whole script inside its time
#: limit on a slower host; PERF.md, section 4).  The serve phase runs all 32
GPT_LAYERS = 16
#: K1's shape on each main path: the longest serving prefill, the adaptive
#: serving prefill, one pipeline micro-batch, one calibrated or adaptive
#: micro-batch, one micro-batch on the ranks
PATH_CASES = {
    "serve": TIMED_CASE, "serve-adaptive": "gpt2.7b_t16", "pipeline": "gpt2.7b_train_t1024",
    "calibrate": "gpt2.7b_train_b2_t1024", "adaptive": "gpt2.7b_train_b2_t1024",
    "ranks": "gpt2.7b_train_t1024", "adaptive-ranks": "gpt2.7b_train_b2_t1024",
    "fabric": "gpt2.7b_train_b2_t1024", "fabric-tcp": "gpt2.7b_train_b2_t1024",
    "model-dense": "gemma3-12b_local_t1536", "serve-dense": "qwen2.5-14b_gqa_b2_t512",
    "train-dense": "gemma3-12b_train_t2048",
    "model-moe": "kimi-k2_gqa_t512", "serve-moe": "kimi-k2_gqa_t512", "train-moe": "kimi-k2_train_t2048",
    "model-encdec-vlm": "seamless_cross_b4_t1024_s128", "train-encdec-vlm": "qwen2-vl_gqa6_b2_t2048",
    "spmd": "qwen2.5-14b_spmd_t2048",
}
#: the shapes K1 is timed at, each beside SDPA and its bound
TIMED_FLASH = (
    "gpt2.7b_t16", "gpt2.7b_t128", "gpt2.7b_t333", "gpt2.7b_t512", "gpt2.7b_train_t1024", "gpt2.7b_train_b2_t1024",
    "gemma3-12b_local_t1536", "gemma3-12b_global_t1536", "gemma3-12b_train_t2048", "qwen2.5-14b_gqa_b2_t512",
    "fp32_hd256", "kimi-k2_gqa_t512", "kimi-k2_train_t2048", "fp32_hd112", "jamba_gqa_t512",
    "seamless_enc_b4_t128", "seamless_dec_b4_t1024", "seamless_cross_b4_t1024_s128", "qwen2-vl_gqa6_b2_t2048",
    "qwen2.5-14b_spmd_t2048",
)
#: the traces _device_ms takes before it gives up on a trace with no kernel
DEVICE_TRACES = 3

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
    # jamba-v0.1-52b's Mamba layers (P 64, N 16, Q 64; 128 heads): one
    # train-moe micro-batch (mma route, 4 warps a block), and fp32 (fma)
    ("jamba_train", 1, 2048, 128, 64, 16, 64, _BF16, _BF16),
    ("jamba_fp32", 1, 256, 8, 64, 16, 64, _F32, _F32),
]
SSD_TIMED_CASE = "mamba2-780m_train"
#: K2's shape on each main path: mamba2-780m's train phase, jamba's train-moe
SSD_PATH_CASES = {"train": SSD_TIMED_CASE, "train-moe": "jamba_train"}
#: train-model check, K2 vs plain SSD, 2 bf16 layers at full width.  The
#: SSD outputs differ by one bf16 ulp in some elements (see SSD_REL_TOL; on
#: the mma route in more of them); that perturbs everything downstream by a
#: relative ~4e-3 at most, and the mean over 4,096 tokens averages it out of
#: the loss.  Loss: relative 1e-3.
#: Gradients (one global ||g_k - g_p|| / ||g_p|| over every leaf): 2e-2,
#: five bf16 unit roundoffs.
TRAIN_MODEL_LOSS_TOL = 1e-3
TRAIN_MODEL_GRAD_TOL = 2e-2
#: K2's gradient gap against that of its sound peer: the plain SSD whose
#: forward runs its products in TF32 (each layer's output as far from the
#: fp32 plain as K2's: 1.148e-3 against 1.149e-3 at jamba's shape) under the
#: same backward.  A bf16 model carries any change of rounding in an SSD's
#: output into every layer after it, so the gap is the model's, not K2's:
#: on H100 the plain SSD at chunk 32 (the same math in another fp32 order)
#: reads a gap well above 0, of the peer's order,
#: and so does the plain SSD with dt rounded to bf16, while K2 with a planted
#: fault (head 0's output taken from head 1) reads several times the peer's
#: (the readings: PERF.md, section 6).  The gate is K2 <= 1.5 x the peer, and
#: the fault must fail it.
K2_PEER_FACTOR = 1.5
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
#: the pipeline phase: GPT-2.7B (full width, GPT_LAYERS) in S = 4 stages under kfkb k = 2,
#: batch 8 x 1024 tokens in M = 8 micro-batches (b = 1)
PIPE_STAGES, PIPE_K = 4, 2
PIPE_ARGS = dict(steps=6, batch=8, seq=1024, microbatches=8, lr=1e-4, warmup=2)
#: the calibrate phase: GPT-2.7B at full size in S = 4 stages, the adaptive
#: phase's micro-batch (b = 2 x T = 1024); the config's fp32 parameters and
#: bf16 compute, drawn from seed 0 (core/calibrate.py's SEED); the two
#: methods it runs
CALIBRATE_ARGS = dict(config="GPT-2.7B", S=4, b_mb=2, seq=1024)
CALIBRATE_METHODS = ("spec", "wallclock")
#: calibrate check, each stage's fwd FLOPs against the closed form (relative)
CALIBRATE_FLOPS_TOL = 1e-9
#: the serve-adaptive phase: launch/serve_adaptive's comparison (repro's
#: Fig-10 serving world, seed 0, ticks priced on specs/h100-sxm.json) with
#: GPT-2.7B (full width, GPT_LAYERS) behind each run (its ENGINE_ARGS: 4 stages, 8
#: slots, max_len 80; 16-token prompts, 16-48 new tokens)
SERVE_ADAPTIVE_ARGS = dict(max_requests=24, regime="fig10", seed=0, device_spec="h100-sxm")
#: the serve-ssm phase: mamba2-780m at full width and depth through
#: serve_decode; its prompts 16-32 tokens, since SSM serving prefills a token
#: at a time (~1.25 ms a token a layer)
SERVE_SSM_ARGS = {
    "config": "mamba2-780m", "slots": 8, "microbatches": 4, "requests": 8, "seed": 0, "max-len": 64,
    "prompt-len": (16, 32), "new-tokens": (16, 32),
}
#: the adaptive phase: repro's Fig-10 scenario (train_adaptive.build_fig10_scenario)
#: with GPT-2.7B (full width, GPT_LAYERS), sequences of 1024 tokens, 14 coordinator iterations
#: serve-dense: each dense arch at full width through serve_decode, 8 slots
#: on an M=4 x b=2 grid, 8 requests; gemma3-12b's prompts pass its window
SERVE_DENSE_ARGS = {"slots": 8, "microbatches": 4, "requests": 8, "seed": 0, "new-tokens": (16, 32)}
#: (arch, layers, prompt tokens, max_len): each at full width and half its
#: depth (gemma3-12b: four 5:1 periods)
SERVE_DENSE = (
    ("qwen1.5-4b", 20, (128, 512), 544),
    ("qwen2.5-14b", 24, (128, 512), 544),
    ("internlm2-20b", 24, (128, 512), 544),
    ("gemma3-12b", 24, (1024, 1536), 1568),
)
#: serve-dense's memory gate: the peak over the bf16 weights plus the cache
SERVE_DENSE_HEADROOM = 4 * 2**30
#: what may stay allocated once serve_decode returned, before any collection
SERVE_DENSE_LEFT = 2**28
#: train-dense: (arch, layers, batch, seq, micro-batches), 4 steps each at
#: full width: gemma3-12b cut to one 5:1 period (T past the window, the
#: global layer included); qwen1.5-4b cut to 24 of its 40 layers (its full
#: depth's ~63 GB of fp32 state and AdamW moments, plus casts, activations
#: and logits, come too close to the card's 80 GB)
TRAIN_DENSE = (("gemma3-12b", 6, 1, 2048, 1), ("qwen1.5-4b", 24, 2, 1024, 2))
TRAIN_DENSE_ARGS = dict(steps=4, lr=1e-4, warmup=1, seed=0)
#: model-moe: (arch, layers, prompt tokens) at full width: jamba-v0.1-52b cut
#: to one 8-layer period (attention at layer 4, MoE on the odd layers, 13.27 B
#: parameters), kimi-k2 to its dense prefix layer and one MoE layer (19.58 B),
#: llama4-maverick to 2 layers, dense then MoE (18.55 B)
MODEL_MOE = (("jamba-v0.1-52b", 8, 300), ("kimi-k2-1t-a32b", 2, 300), ("llama4-maverick-400b-a17b", 2, 300))
#: model-moe, each MoE layer's bf16 output against the per-expert fp32 loop
#: over the same kept (token, expert) pairs, as ||y - y_ref|| / ||y_ref||:
#: the layer rounds to bf16 after the gate and up products, their SwiGLU
#: product, the down product and the weighting (2^-9 relative each) and sums
#: the k outputs and the shared expert in bf16; five bf16 unit roundoffs
MOE_REL_TOL = 2e-2
#: serve-moe: (arch, layers, prompt tokens, max_len) at full width through
#: serve_decode, 8 slots on M=4 x b=2, 8 requests, 16-32 new tokens:
#: jamba-v0.1-52b cut to two 8-layer periods (26.00 B parameters, 52.0 GB of
#: bf16; all 32 layers, 103 GB, do not fit one card), its prompts 16-32
#: tokens since its Mamba layers prefill a token at a time (~1.25 ms a token a
#: layer); kimi-k2 and llama4-maverick at 2 layers (39.2 and 37.1 GB of bf16)
SERVE_MOE = (
    ("jamba-v0.1-52b", 16, (16, 32), 64),
    ("kimi-k2-1t-a32b", 2, (128, 512), 544),
    ("llama4-maverick-400b-a17b", 2, (128, 512), 544),
)
#: serve-moe's memory gate: the serving peak over the bf16 weights plus the
#: cache (the setup peak may add one fp32 expert bank, drawn and cast a bank
#: at a time and freed before serving)
SERVE_MOE_HEADROOM = 3 * 2**29
#: train-moe: (arch, layers, experts, batch, seq) at full width, 4 steps and
#: 2 more traced, M=1: jamba-v0.1-52b cut to layers 0-4 (attention at 4, MoE
#: at 1 and 3) with 16 -> 4 experts, top-2 kept (2.92 B, AdamW); kimi-k2 at 2
#: layers with 384 -> 16 experts, top-8 kept (3.37 B, Adafactor)
TRAIN_MOE = (("jamba-v0.1-52b", 5, 4, 1, 2048), ("kimi-k2-1t-a32b", 2, 16, 1, 2048))
TRAIN_MOE_ARGS = dict(steps=4, lr=1e-4, warmup=1, seed=0)

#: model-encdec-vlm: (arch, batch, target tokens) at full size; seamless's
#: source is T / 8 frames, as repro's input specs give it
MODEL_ENCDEC_VLM = (("seamless-m4t-medium", 2, 512), ("qwen2-vl-2b", 2, 512))
#: model-encdec-vlm: tokens stepped through decode_fn from an empty cache
#: (neither family has a fused prefill) and held to the teacher-forced
#: forward: a prompt, then MODEL_DECODE_STEPS more
MODEL_ENCDEC_VLM_DECODE = 12 + MODEL_DECODE_STEPS
#: model-encdec-vlm: qwen2-vl's image, a grid of this many patches a side
#: at temporal position 0; the text after it continues from the grid's side
VLM_GRID = 16

#: train-encdec-vlm: (arch, batch, seq, micro-batches) at full size and depth
TRAIN_ENCDEC_VLM = (("seamless-m4t-medium", 4, 1024, 1), ("qwen2-vl-2b", 2, 2048, 1))
TRAIN_ENCDEC_VLM_ARGS = dict(steps=4, lr=1e-4, warmup=1, seed=0)
#: train-encdec-vlm's checkpoint check: qwen2-vl-2b at full width cut to one
#: layer (its 233 M-parameter embedding is most of the 3.5 GB a checkpoint
#: writes), b 1 x T 256, 4 steps, a checkpoint every 2
CKPT_CHECK = dict(arch="qwen2-vl-2b", layers=1, batch=1, seq=256, steps=4, every=2)

ADAPTIVE_ARGS = dict(gpt="GPT-2.7B", seq_len=1024, seed=0)
ADAPTIVE_ITERATIONS = 14
#: adaptive check, the engine's gradients on the switched and restacked state
#: against autograd of full_loss: pipeline-model's limit (both through K1 in
#: bf16, the same operations on the same values, fp32 sums in another order)
ADAPTIVE_GRAD_TOL = PIPE_ENGINE_GRAD_TOL
#: ranks-model: pipeline-model's cut and plans, plus zbv (its V-shaped
#: placement sends on both ring directions and keeps the turn in the process)
RANKS_MODEL_PLANS = PIPE_MODEL_PLANS + (dict(kind="zbv"),)
#: the ranks phase: the pipeline phase's workload (S, k, PIPE_ARGS), one
#: process per stage; on one card (a check: gloo, the ranks time-slicing
#: it) GPT-2.7B at full width cut to 8 layers, which pays for the spmd
#: phase's time (PERF.md, section 4)
RANKS_STAGES, RANKS_K = PIPE_STAGES, PIPE_K
RANKS_ONE_CARD_LAYERS = 8
#: adaptive-ranks-model: GPT-2.7B at full width cut to 8 layers (S * v = 8
#: divides it) on S = 4 ranks, one iteration of each plan of the walk, on the
#: adaptive phase's batches (M = 4 micro-batches of 2 x 1024 tokens)
ADAPTIVE_RANKS_MODEL_LAYERS = 8
ADAPTIVE_RANKS_MODEL_WALK = (
    dict(kind="kfkb", k=1), dict(kind="zb_h1"), dict(kind="interleaved_zb", num_virtual=2), dict(kind="zbv"),
    dict(kind="kfkb", k=1),
)
#: adaptive-ranks-model, the ranks against the one-process engine with the
#: copies' gradients summed: the same task bodies on the same bf16 values,
#: so the gradients agree bitwise; the clip norm adds its per-rank sums in
#: another order, which moves the clip scale by an ulp, and with it m and v
#: (read 0.9e-7 to 2.2e-7 on the H100) and the update (5.1e-7).  Each of
#: params, m, v, the gradients and the last step's update is held apart, as
#: one relative error over its leaves (estimated from DIGEST_PROJECTIONS
#: random projections of each leaf; see _digests): 1e-5, 20x the largest
#: sound reading, where a leaf lost or misplaced reads its share of its
#: kind's norm
ADAPTIVE_RANKS_STATE_TOL = 1e-5
DIGEST_PROJECTIONS = 4
#: adaptive-ranks-model's learning rate: 0 at every step of the walk but the
#: last, where it is 1e-3.  So the parameters keep their draw bitwise up to
#: the last step, every iteration's gradients are taken at the same values
#: on both sides, the moments accumulate them and the restacks move all
#: three, and the last step checks the update itself from equal states.  At
#: a constant 1e-3 two correct runs part after one step: parameters an ulp
#: apart round to other bf16 weights (_lr_witness measures it in one
#: process; PERF.md, section 6)
ADAPTIVE_RANKS_MODEL_LR = 1e-3
#: adaptive-ranks: the adaptive phase's Fig-10 scenario on S = 4 ranks, at
#: full depth with a card per rank; on one card cut to 8 layers at full
#: width (S * v = 8 divides it): at 32 the four processes ran the card out
#: of its 79.18 GiB in an AdamW update (rank 0 held 17.69 GiB; PERF.md,
#: section 6), and 16 left no time for the spmd phase
ADAPTIVE_RANKS_ONE_CARD_LAYERS = 8
#: the fabric phase: two hosts, each a whole GPT-2.7B replica at full width
#: (the adaptive phase's stages and batches, seed 0) cut to 8 layers.  A host
#: holds fp32 parameters, gradients and AdamW m, v (16 B a parameter), and
#: every virtual stage its own copy of the 128.7 M-parameter embedding: at 16
#: layers 26.4 GiB a host under kfkb and 34.1 GiB under interleaved_zb (8
#: copies), two of which with one host's step in flight pass the card's 79.2
#: GiB; 12 layers do not split over S * v = 8 virtual stages.  At 8: 17.0 and
#: 24.7 GiB a host
FABRIC_ARGS = dict(num_hosts=2, num_stages=4, gpt="GPT-2.7B", seq_len=1024, seed=0)
FABRIC_LAYERS = 8
#: the scripted trail after the initial kfkb k=1, as ScheduleSpec keywords (b
#: = 2 added); the last is a kind no host can lower, which the first host to
#: see its PREPARE refuses
FABRIC_TRAIL = (
    dict(kind="zb_h2", extra_warmup=2), dict(kind="interleaved_zb", num_virtual=2), dict(kind="kfkb", k=1),
    dict(kind="bogus"),
)
#: rounds: with the fleet's boundary lead of 2, a switch lands 3 rounds after
#: its decision, and the refusal's boundary is round 12
FABRIC_ROUNDS = 13
#: fabric-tcp: two worker processes at full width cut to 8 layers (S * v = 8
#: divides it), 4 iterations, the switch at the boundary of iteration 2
FABRIC_TCP_LAYERS = 8
FABRIC_TCP_ITERATIONS = 4
FABRIC_TCP_TIMEOUT = 600
#: the fabric phase's oracle against host0: each loss (absolute) and the
#: parameter digest's l2 (relative), repro's limits in tests/test_fabric.py.
#: One card and one code path: bitwise equality is expected, and the largest
#: difference is printed
FABRIC_LOSS_TOL, FABRIC_DIGEST_TOL = 5e-6, 1e-6


#: the spmd phase: qwen2.5-14b at full width (d_model 5120, 40 heads of 128
#: over 8 KV heads, d_ff 13824, vocabulary 152064, an untied head; 14 770 M
#: parameters, 236 GB of training state at 16 B a parameter, so no one card
#: holds it) through repro's sharded step on a (2, 2) ("data", "model") mesh,
#: one process a rank.  Four cards (NCCL, a card a rank): all 48 layers with
#: per-layer remat, zero3 then tp_fsdp, b 8 x T 2048 in M = 2 (each
#: micro-batch's 4 rows over all four ranks under zero3), 4 steps and one
#: traced.  One card (gloo through pinned host buffers, four ranks
#: time-slicing it; a check): cut to 2 layers, one step of b 4 x T 512 in M =
#: 1 under zero3 (a row a rank) and under tp_fsdp with gather_params_once
#: (two rows a rank).  Each micro-batch gathers the 152064-row embedding and
#: head and reduce-scatters their gradients through gloo, 23-54 s a
#: micro-batch, most of the phase (PERF.md, sections 4 to 6): so the
#: accumulation over micro-batches and the second AdamW step run on four
#: cards and on the CPU only, and so does tp_fsdp without gather_params_once
SPMD_ARCH = "qwen2.5-14b"
SPMD_MESH = {"data": 2, "model": 2}
SPMD_FOUR = dict(layers=None, batch=8, seq=2048, M=2, steps=4, traced=True, runs=(
    dict(strategy="zero3"), dict(strategy="tp_fsdp", remat_blocks=True)))
SPMD_ONE = dict(layers=2, batch=4, seq=512, M=1, steps=1, traced=False, runs=(
    dict(strategy="zero3"), dict(strategy="tp_fsdp", gather_params_once=True)))
SPMD_LR = 1e-4
#: the ranks' losses and clip norms against the one-process step's (one
#: card) or the first loss against a one-process forward on the serving
#: weights (four cards), relative: the same bf16 products, on a rank's rows
#: instead of the micro-batch's (a GEMM of other rows may round otherwise),
#: means over the ranks in fp32: the ranks phase's limit against its
#: one-process engine
SPMD_LOSS_TOL = PIPE_ENGINE_LOSS_TOL
#: four cards: zero3's losses and clip norms against tp_fsdp's at each step,
#: relative.  Their rows split otherwise (a row a rank against two), so the
#: bf16 products round otherwise and the states drift apart: at 4 steps the
#: losses differed by at most 3.3e-5 and the norms by 1.05e-3 (PERF.md,
#: section 6); the limits are ten times that
SPMD_CROSS_TOL = {"loss": 3e-4, "grad_norm": 1e-2}
#: one card, after step 1: each leaf group's parameter update and AdamW
#: moments m and v against the one-process step's over the same row groups
#: (M times the rank's share of a micro-batch: a rank's rows are then one
#: micro-batch, the same bf16 products, and only the fp32 sums go in
#: another order), as the relative error of a fixed projection of each group
#: (_spmd_digests).  The update is lr times m / (sqrt(v) + eps) elementwise,
#: so it is the loosest of the three
SPMD_DIGEST_TOL = {"update": 1e-3, "m": 1e-4, "v": 1e-4}
#: AdamW's eps where the digests are compared (one card).  At 1e-8 an element
#: whose gradient is a sum that cancels moves by +-lr whatever its size, so
#: the fp32 sums' order alone moved zero3's update digest by 7.4e-4 at M = 2
#: (PERF.md, section 6); at 1e-3 such an element moves by lr times its
#: gradient over eps, as the CPU test of the step sets it
SPMD_DIGEST_EPS = 1e-3


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
    log(f"host: {_cpu_model()}, {os.cpu_count()} logical cores; torch {torch.__version__} cuda "
        f"{torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 oracles in full fp32
    torch.backends.cudnn.allow_tf32 = False
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "smi": smi,
    }


def _cpu_model() -> str:
    """The host CPU as the kernel reports its first processor: the model
    name, else (where it is missing or reads "unknown", as in some virtual
    machines) the vendor, family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip().lower()] = value.strip()
    except OSError as e:
        return f"{platform.processor() or platform.machine()} (/proc/cpuinfo: {e})"
    if info.get("model name", "unknown") != "unknown":
        return info["model name"]
    fields = [f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model", "cpu mhz") if k in info]
    return ", ".join(fields) or f"{platform.machine()} ({len(info)} cpuinfo fields, none naming the model)"


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
        hmma = _hmma_counts(b.library)
        ptxas = b.ptxas_summary()
        for name, r in zip(_demangle(list(ptxas)), ptxas.values()):
            log(f"  {r.get('registers', '?'):>3} registers, stack {r.get('stack', '?')} B, spill stores "
                f"{r.get('spill_stores', '?')} B, loads {r.get('spill_loads', '?')} B, HMMA "
                f"{hmma.get(name, '?'):>4}  {name}")


def _demangle(names: list) -> list:
    """C++ names through cu++filt, where the toolkit has it; else as given."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not (os.path.exists(filt) and names):
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.split("\n")
    return [(n.strip() or k) for k, n in zip(names, out)]


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
    return dict(zip(_demangle(list(counts)), counts.values()))


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
    _time_ms it leaves out the host's share of a call.  A trace that holds
    no kernel lost its device events (the serve-shape K1 and one SDPA have
    read 0 on the H100) and is taken again, up to DEVICE_TRACES times."""
    from repro_torch.launch.profiling import device_profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    for _ in range(DEVICE_TRACES):
        ms = device_profile(run, torch.device("cuda"), {})["device_ms"] / iters
        if ms > 0:
            return ms
    raise AssertionError(f"{DEVICE_TRACES} traces recorded no device time")


def _h100():
    """The H100's spec (specs/h100-sxm.json through the port's loader) and a
    function from a torch dtype to its peak FLOP/s."""
    from repro_torch.core.devicespec import dtype_key, load_device_spec

    spec = load_device_spec(H100_SPEC)
    return spec, lambda dtype: spec.peak_flops_for(dtype_key(dtype))


def _flash_bound_ms(B, T, S, H, K, hd, dtype, causal, window) -> tuple[float, str]:
    """max(bytes / HBM rate, FLOPs / peak) for the pairs this mask keeps."""
    from repro_torch.kernels.flash_attention import ref

    spec, peak = _h100()
    pairs = int(ref.causal_window_mask(T, S, causal, window).sum())
    flops = 4.0 * hd * pairs * B * H  # q.k and p.v, 2 FLOP per MAC
    nbytes = (2 * B * T * H * hd + 2 * B * S * K * hd) * torch.finfo(dtype).bits / 8
    t_bytes, t_ops = nbytes / spec.hbm_bandwidth_bytes_per_s, flops / peak(dtype)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _flash_agrees(out, want) -> tuple[bool, float, float]:
    """K1's output against its plain version's: (within TOL as an allclose
    and REL_TOL as a norm ratio, max_abs_err, rel_norm_err)."""
    diff = out.float() - want.float()
    err = float(diff.abs().max())
    rel = float(diff.norm() / want.float().norm())
    tol = TOL[out.dtype]
    excess = float((diff.abs() - tol * want.float().abs()).max())
    return bool(torch.isfinite(out).all()) and excess <= tol and rel <= REL_TOL[out.dtype], err, rel


def _flash_kernels() -> dict:
    from repro_torch.kernels.flash_attention import ops, ref

    timed = {}
    for name, B, T, S, H, K, hd, dtype, causal, window in FLASH_CASES:
        q, k, v = _qkv(B, T, S, H, K, hd, dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = ref.attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ok, err, rel = _flash_agrees(out, want)
        log(f"flash {name:14s} B={B} T={T} S={S} H={H} K={K} hd={hd} "
            f"{str(dtype).split('.')[-1]} causal={causal} window={window} route {ops.route(dtype)}: "
            f"max_abs_err {err:.3e} (allclose atol=rtol={TOL[dtype]:g}), "
            f"rel_norm_err {rel:.3e} (<= {REL_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
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
        # the same function in one library call: native GQA, and a window
        # as a boolean mask (SDPA has no window argument)
        mask = None if window is None else ref.causal_window_mask(T, S, causal, window, q.device)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=K != H
        )
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
    S w, plus C h^T and the state update, 2 FLOP per MAC, each product at
    the peak of the type it runs in.  The mma route (ssd_fwd.cu) runs C B^T
    on bf16 operands and the other three on TF32; the fma route runs all
    four in fp32 FMA."""
    from repro_torch.kernels.ssd_scan import ops

    spec, peak = _h100()
    xb, bcb = torch.finfo(x_dtype).bits / 8, torch.finfo(bc_dtype).bits / 8
    nbytes = 2 * B * T * H * P * xb + 4 * B * T * H + 2 * B * T * N * bcb + 4 * H
    tri = Q * (Q + 1) / 2
    triples = B * H * (T // Q)
    cb, rest = triples * 2.0 * tri * N, triples * 2.0 * (tri * P + 2 * Q * P * N)
    if ops.route(x_dtype, bc_dtype, P, N, Q) == "mma":
        t_ops = cb / peak(torch.bfloat16) + rest / spec.peak_flops_for("tf32")
    else:
        t_ops = (cb + rest) / peak(torch.float32)
    t_bytes = nbytes / spec.hbm_bandwidth_bytes_per_s
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ssd_kernels() -> dict:
    from repro_torch.kernels.ssd_scan import ops, ref

    timed = {}
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
        if name in SSD_PATH_CASES.values():
            timed[name] = (B, T, H, P, N, Q, x_dtype, bc_dtype, x, dt, A, Bm, Cm, err)

    figures = {}
    for name, (B, T, H, P, N, Q, x_dtype, bc_dtype, x, dt, A, Bm, Cm, err) in timed.items():
        ssd = lambda: ops.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
        plain = lambda: ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=Q)  # noqa: E731
        ms, plain_ms = _device_ms(ssd), _device_ms(plain, iters=5)
        call_ms = _time_ms(ssd)
        bound_ms, bound_by = _ssd_bound_ms(B, T, H, P, N, Q, x_dtype, bc_dtype)
        log(f"ssd timing at {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (device time); "
            f"per call {call_ms:.4f} ms (events); no library call, bound {bound_ms:.4f} ms ({bound_by})")
        # what one layer's SSD costs a training step: K2 forward, then the
        # backward that recomputes and differentiates the plain version
        inputs = [t.detach().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        gy = torch.randn(x.shape, device="cuda").to(x.dtype)
        train_ms = _time_ms(lambda: torch.autograd.grad(ops.ssd_chunked(*inputs, chunk=Q), inputs, gy), iters=5)
        log(f"ssd forward (K2) + backward (plain recompute) at {name}: {train_ms:.4f} ms")
        figures[name] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call computes the chunked SSD
        }
    return {
        "name": "ssd_chunked_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_fwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:65",
        "launches": None,  # the sum over the main paths (the train and train-moe phases)
        **figures[SSD_TIMED_CASE],
        "per_path": {
            path: {"shape": name, "launches": None, **figures[name]} for path, name in SSD_PATH_CASES.items()
        },
    }


def phase_kernels() -> dict:
    return {"flash": _flash_kernels(), "ssd": _ssd_kernels()}


def phase_model() -> None:
    from repro_torch.configs.gpt import GPT_CONFIGS

    _model_check(GPT_CONFIGS["GPT-2.7B"].replace(num_layers=2), 512)


def _oracle_errors(kern, plain, truth) -> tuple[bool, float, float]:
    """(within the model-dense gate, K1's and the plain bf16 run's largest
    logit error against the fp32 run)."""
    err_k, err_p = float((kern - truth).abs().max()), float((plain - truth).abs().max())
    return err_k <= max(MODEL_ORACLE_FACTOR * err_p, MODEL_TOL), err_k, err_p


def _greedy_gate(got, truth, what: str) -> int:
    """Greedy tokens of ``got`` [..., V] against ``truth``'s at every
    position: equal, or ``truth``'s top-2 gap under MODEL_TOL; returns the
    disagreements within that gap."""
    top2 = truth.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    differ = got.argmax(-1) != truth.argmax(-1)
    if bool((differ & (gap >= MODEL_TOL)).any()):
        raise AssertionError(f"{what}: greedy tokens differ where the top-2 gap is >= {MODEL_TOL}")
    return int(differ.sum())


def _model_check(cfg, prompt_len: int, oracle: bool = False, moe_gate: bool = False) -> int:
    """``cfg`` served through K1 and through the plain attention: a prefill
    of ``prompt_len`` tokens, then MODEL_DECODE_STEPS greedy decode steps
    (the plain run fed the kernel run's tokens).  Without ``oracle``: logits
    within MODEL_TOL.  With it, the same weights also run in fp32 through
    the plain attention, and the K1 run's largest logit error against that
    run is at most MODEL_ORACLE_FACTOR times the plain bf16 run's (or
    MODEL_TOL).  Either way the greedy tokens are equal, or their top-2 gap
    is under MODEL_TOL.  Then each layer's K1 output in the prefill, at every
    position, is held to the plain version on the q/k/v the layer gave K1
    (:func:`_layer_gate`).  With ``moe_gate`` (an MoE config) the logits are
    reported and not gated: a rounding of K1 against the plain attention may
    move a token across a router's top-k boundary; instead each MoE layer's
    prefill output is held to a per-expert loop in fp32 (:func:`_moe_gate`).
    Returns K1's launches in the kernel run."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import layer_specs
    from repro_torch.tree import tree_map

    steps = MODEL_DECODE_STEPS
    params = api.init_serving_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g, device="cuda")

    def run(cfg, params, plain: bool, feed=None):
        cache = api.init_cache(cfg, 1, prompt_len + 64, device="cuda")
        logits, cache = api.prefill_with_cache(
            params, cfg, cache, {"tokens": prompt}, plain_attention=plain
        )
        out = [logits[:, -1].float()]
        for i in range(steps):
            tok = feed[i] if feed is not None else out[-1].argmax(-1, keepdim=True)
            logits, cache = api.decode_fn(params, cfg, cache, prompt_len + i, {"tokens": tok})
            out.append(logits[:, -1].float())
        torch.cuda.synchronize()
        return out

    flash, calls = ops.flash_attention, []

    def capture(q, k, v, causal=True, window=None):  # each layer's K1 call of the prefill
        out = flash(q, k, v, causal=causal, window=window)
        calls.append((q, k, v, causal, window, out))
        return out

    moe_apply, moe_calls = moe_mod.moe_apply, []

    def capture_moe(p, x, cfg_, capacity_factor=None):  # each MoE layer's call of the prefill
        y, aux = moe_apply(p, x, cfg_, capacity_factor)
        if x.shape[0] == prompt_len:  # batch 1: the prefill's (a decode step routes 1 token)
            cf = cfg_.capacity_factor if capacity_factor is None else capacity_factor
            moe_calls.append((p, x.detach().clone(), y.detach().clone(), float(aux["dropped_frac"]), cf))
        return y, aux

    n0 = ops.launches
    with mock.patch.object(ops, "flash_attention", capture), mock.patch.object(moe_mod, "moe_apply", capture_moe):
        kern = run(cfg, params, False)
    launches = ops.launches - n0
    feed = [x.argmax(-1, keepdim=True) for x in kern[:steps]]
    plain = run(cfg, params, True, feed)
    truth = [None] * len(kern)
    if oracle:  # the same (bf16-rounded) weights, everything else in fp32
        params32 = tree_map(lambda t: t.float(), params)
        truth = run(cfg.replace(dtype=torch.float32), params32, True, feed)
        del params32
    attn_layers = sum(spec.kind == "attn" for spec in layer_specs(cfg))
    log(f"model {cfg.name} ({cfg.num_layers} layers, {attn_layers} attention, d_model {cfg.d_model}, hd {cfg.hd}, "
        f"{cfg.num_heads} heads over {cfg.num_kv_heads}, windows {cfg.window_pattern or cfg.attn_window}, "
        f"experts {cfg.num_experts} top-{cfg.num_experts_per_tok}), prefill of {prompt_len} "
        f"tokens + {steps} decode steps: K1 launches {launches}")
    if launches != attn_layers or len(calls) != attn_layers:
        raise AssertionError(f"K1 ran {launches} times in a prefill of {attn_layers} attention layers")
    for i, (a, b, t) in enumerate(zip(kern, plain, truth)):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite logits at step {i}")
        err = float((a - b).abs().max())
        rel = float((a - b).norm() / b.norm())
        ta, tb = int(a.argmax()), int(b.argmax())
        top2 = b[0].topk(2).values
        gap = float(top2[0] - top2[1])
        what = f"model step {i} ({'prefill' if i == 0 else 'decode'}): logits max_abs_err {err:.3e}, rel_norm_err {rel:.3e}"
        if moe_gate:
            ok = True
            what += " (reported: routing may part)"
        elif t is None:
            ok = torch.allclose(a, b, atol=MODEL_TOL, rtol=MODEL_TOL)
            what += f" (atol=rtol={MODEL_TOL})"
        else:
            ok, err_k, err_p = _oracle_errors(a, b, t)
            what += (f"; against fp32: K1 {err_k:.3e}, plain bf16 {err_p:.3e} "
                     f"(K1 <= max({MODEL_ORACLE_FACTOR:g} x plain, {MODEL_TOL}))")
        log(f"{what}, greedy {ta} vs {tb}, top-2 gap {gap:.3e}")
        if not ok:
            raise AssertionError(f"kernel and plain logits disagree at step {i}")
        if _greedy_gate(a, b, f"model step {i}"):
            log(f"  greedy disagreement at step {i} within tolerance (gap {gap:.3e})")
    _layer_gate(calls, flash)
    if moe_gate:
        _moe_gate(cfg, moe_calls)
    del params, calls, moe_calls
    torch.cuda.empty_cache()
    return launches


def _moe_gate(cfg, calls: list) -> None:
    """Each MoE layer's prefill output against an independent per-expert loop
    on the card, in fp32.  The routing is recomputed here, apart from the
    port's: the top-k experts of the fp32 router scores (sigmoid or softmax
    per ``cfg.router_scoring``), their weights the top-k scores over their
    sum, and the entries kept by a running count per expert in token order
    against the capacity C = floor(T*k*cf/E) + 1.  Over the kept entries each
    expert's SwiGLU is applied to its tokens with fp32 weights and sums and
    weighted, plus the shared expert.  The output is held under MOE_REL_TOL
    and the layer's ``dropped_frac`` to the count's; the same loop with every
    expert's weights taken from the next expert (a planted fault) must fail
    the first."""
    import torch.nn.functional as F

    E, k = cfg.num_experts, cfg.num_experts_per_tok
    for layer, (p, x, y, dropped, cf) in enumerate(calls):
        T, d = x.shape
        logits = x.float() @ p["router"]["w"].float()
        scores = torch.sigmoid(logits) if cfg.router_scoring == "sigmoid" else torch.softmax(logits, dim=-1)
        top = scores.topk(k, dim=-1)
        idx, w = top.indices, top.values / top.values.sum(-1, keepdim=True)
        C = int(T * k * cf // E) + 1
        seen, kept = [0] * E, []
        for e in idx.flatten().tolist():  # token-major: token t's k choices in slot order
            kept.append(seen[e] < C)
            seen[e] += 1
        keep = torch.tensor(kept, device=x.device).view(T, k)
        count_dropped = 1.0 - sum(kept) / len(kept)
        ex, xf = p["experts"], x.float()

        def loop(shift):
            out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
            for e in torch.unique(idx[keep]).tolist():
                tok, slot = ((idx == e) & keep).nonzero(as_tuple=True)
                we = (e + shift) % E
                h = F.silu(xf[tok] @ ex["gate"][we].float()) * (xf[tok] @ ex["up"][we].float())
                out.index_add_(0, tok, (h @ ex["down"][we].float()) * w[tok, slot, None])
            if "shared" in p:
                sh = p["shared"]
                h = F.silu(xf @ sh["gate"]["w"].float()) * (xf @ sh["up"]["w"].float())
                out += h @ sh["down"]["w"].float()
            return out

        want = loop(0)
        rel = float((y.float() - want).norm() / want.norm())
        rel_fault = float((loop(1) - want).norm() / want.norm())
        log(f"  MoE layer {layer}: {T} tokens, top-{k} of {E} ({cfg.router_scoring}), capacity {C}; dropped_frac "
            f"{dropped:.4f}, by the running count {count_dropped:.4f}; output vs per-expert fp32 loop "
            f"rel_norm_err {rel:.3e} (<= {MOE_REL_TOL:g}); planted fault (experts shifted by one) rel_norm_err "
            f"{rel_fault:.3e} {'rejected' if rel_fault > MOE_REL_TOL else 'FAIL (unseen)'}")
        if rel > MOE_REL_TOL or not math.isfinite(rel):
            raise AssertionError(f"MoE layer {layer} disagrees with the per-expert loop")
        if abs(dropped - count_dropped) > 1e-6:
            raise AssertionError(f"MoE layer {layer}: dropped_frac {dropped} against the running count's {count_dropped}")
        if rel_fault <= MOE_REL_TOL:
            raise AssertionError(f"the MoE gate passes a planted fault at layer {layer}")


def _layer_gate(calls: list, flash) -> None:
    """Each prefill layer's K1 output, at every position, against the plain
    version on that layer's own q/k/v, under the kernels phase's TOL and
    REL_TOL.  The gate is then shown to see the faults the logits can hide:
    K1 on the same inputs with the KV heads shifted by one (a wrong GQA
    mapping), and, on a layer whose window is shorter than its keys, with the
    window dropped, must each fail it.  These launches are comparisons and
    fall outside the path's count."""
    from repro_torch.kernels.flash_attention import ref

    for layer, (q, k, v, causal, window, out) in enumerate(calls):
        want = ref.attention(q, k, v, causal=causal, window=window)
        ok, err, rel = _flash_agrees(out, want)
        faults = {"KV heads shifted": flash(q, k.roll(1, 2), v.roll(1, 2), causal=causal, window=window)}
        if window is not None and window < k.shape[1]:
            faults["window dropped"] = flash(q, k, v, causal=causal, window=None)
        seen = {name: _flash_agrees(bad, want) for name, bad in faults.items()}
        log(f"  layer {layer} (window {window}): K1 vs plain over {q.shape[1]} positions max_abs_err {err:.3e}, "
            f"rel_norm_err {rel:.3e} (<= {REL_TOL[q.dtype]:g}) {'ok' if ok else 'FAIL'}; planted faults: "
            + ", ".join(f"{name} rel_norm_err {r[2]:.3e} {'FAIL (unseen)' if r[0] else 'rejected'}"
                        for name, r in seen.items()))
        if not ok:
            raise AssertionError(f"K1 disagrees with the plain attention at layer {layer}")
        if any(r[0] for r in seen.values()):
            raise AssertionError(f"the layer gate passes a planted fault at layer {layer}")


def phase_model_dense() -> int:
    from repro_torch.configs import get_arch

    launches = 0
    for arch, layers, prompt_len in MODEL_DENSE:
        launches += _model_check(get_arch(arch).model.replace(num_layers=layers), prompt_len, oracle=True)
    return launches


def phase_train_model() -> None:
    from repro_torch.configs.mamba2_780m import FULL

    _k2_against_plain(FULL.replace(num_layers=2), TRAIN_ARGS["batch"] // TRAIN_ARGS["microbatches"],
                      TRAIN_ARGS["seq"], "train-model", grad_tol=TRAIN_MODEL_GRAD_TOL)


def _ssd_forward_as(fwd):
    """``ssd_chunked`` with ``fwd(x, dt, A, Bm, Cm, chunk)`` as its forward
    and K2's backward (the plain SSD's gradient at the saved inputs)."""
    from repro_torch.kernels.ssd_scan import ops

    class SSD(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, Bm, Cm, chunk):
            ctx.save_for_backward(x, dt, A, Bm, Cm)
            ctx.chunk = chunk
            return fwd(x, dt, A, Bm, Cm, chunk)

        backward = staticmethod(ops._SSDChunked.backward)

    return lambda x, dt, A, Bm, Cm, chunk=64: SSD.apply(x, dt, A, Bm, Cm, chunk)


def _ssd_tf32(x, dt, A, Bm, Cm, chunk):
    """The plain SSD with its products in TF32: K2's sound peer."""
    from repro_torch.kernels.ssd_scan import ref

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _ssd_head_fault(k2):
    """The forward of ``k2`` (K2's wrapper) with a planted fault: head 0's
    output taken from head 1."""

    def fwd(x, dt, A, Bm, Cm, chunk):
        y = k2(x, dt, A, Bm, Cm, chunk=chunk)
        y[:, :, 0] = y[:, :, 1]
        return y

    return fwd


def _k2_against_plain(cfg, micro_batch: int, seq: int, what: str, grad_tol: float | None = None) -> None:
    """The loss and gradients of one micro-batch (seed 0's first) through K2
    and through the plain SSD under autograd: the loss under
    TRAIN_MODEL_LOSS_TOL, the gradient gap under K2_PEER_FACTOR times that
    of K2's sound peer (the plain SSD forward in TF32, :func:`_ssd_tf32`) and
    under ``grad_tol`` where given; K2 runs once per Mamba2 layer.  Printed
    beside it: the plain SSD at chunk 32 and with dt rounded to bf16 (sound
    controls, the first in fp32, the second with K2's backward), each
    Mamba2 layer's SSD output in the K2 run against the plain run's, and K2's
    and the peer's forward on K2's inputs against the plain's.  K2 with a
    planted fault (:func:`_ssd_head_fault`) must fail the gate.  An MoE layer
    in every run after K2's follows K2's routing (its experts, ranks and
    drops; the weights recomputed from its own router scores), so that the
    runs part only by the SSD: a rounding may move a token across a top-k
    boundary, and the number of (token, slot) choices that moved is
    printed."""
    from unittest import mock

    from repro_torch.data import SyntheticTextDataset
    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.models import api
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.common import layer_specs
    from repro_torch.tree import flatten, tree_map

    params = api.init_params(cfg, seed=0, device="cuda")
    b = SyntheticTextDataset(cfg.vocab_size, seq, micro_batch, seed=0).batch_at(0, "cuda")
    batch = {"tokens": b.tokens, "labels": b.labels}
    route, routes, moved = moe_mod.route, [], [0]

    def record(p, x, cfg_, capacity_factor=None):
        r = route(p, x, cfg_, capacity_factor)
        routes.append({key: r[key] for key in ("idx", "rank", "keep")})
        return r

    def pinned(count: bool = False):  # count: the plain run's moved choices
        queue = list(routes)

        def pin(p, x, cfg_, capacity_factor=None):
            r, rec = route(p, x, cfg_, capacity_factor), queue.pop(0)
            moved[0] += int((r["idx"] != rec["idx"]).sum()) if count else 0
            scores = torch.sigmoid(r["logits"]) if cfg_.router_scoring == "sigmoid" else r["probs"]
            w = scores.gather(-1, rec["idx"])
            return {**r, **rec, "w": w / w.sum(-1, keepdim=True).clamp(min=1e-9)}

        return pin

    def loss_and_grads(ssd, route_fn, outs):
        def capture(x, dt, A, Bm, Cm, chunk=64):
            y = ssd(x, dt, A, Bm, Cm, chunk=chunk)
            outs.append((x.detach(), dt.detach(), A.detach(), Bm.detach(), Cm.detach(), chunk, y.detach()))
            return y

        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with mock.patch.object(ops, "ssd_chunked", capture), mock.patch.object(moe_mod, "route", route_fn):
            loss, _ = api.loss_fn(leaves, cfg, batch)
            grads = torch.autograd.grad(loss, list(flatten(leaves).values()))
        torch.cuda.synchronize()
        return float(loss.detach()), [g.float() for g in grads]

    names = list(flatten(params))
    mamba = sum(spec.kind == "mamba" for spec in layer_specs(cfg))
    n0, outs_k, outs_p = ops.launches, [], []
    loss_k, grads_k = loss_and_grads(ops.ssd_chunked, record, outs_k)
    if ops.launches - n0 != mamba:
        raise AssertionError(f"K2 ran {ops.launches - n0} times in a forward of {mamba} Mamba2 layers")
    loss_p, grads_p = loss_and_grads(ref.ssd_chunked, pinned(True), outs_p)  # the plain SSD, under autograd
    den = math.sqrt(sum(float(g.square().sum()) for g in grads_p))

    def gap(grads):
        sq = [float((a - b).square().sum()) for a, b in zip(grads, grads_p)]
        return math.sqrt(sum(sq)) / den, sq

    finite = math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k + grads_p)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel, sq = gap(grads_k)
    del grads_k
    layers = []
    for (x, dt, A, Bm, Cm, chunk, y), (*_, y_p) in zip(outs_k, outs_p):
        want = ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk).float()
        layers.append((_rel_norm_err([y], [want]), _rel_norm_err([_ssd_tf32(x, dt, A, Bm, Cm, chunk)], [want]),
                       _rel_norm_err([y], [y_p])))
    del outs_k, outs_p
    controls = {}
    def chunk32(x, dt, A, Bm, Cm, chunk=64):
        return ref.ssd_chunked(x, dt, A, Bm, Cm, chunk=32)

    def dt_bf16(x, dt, A, Bm, Cm, chunk):
        return ref.ssd_chunked(x, dt.bfloat16().float(), A, Bm, Cm, chunk=chunk)

    for name, ssd in (("peer", _ssd_forward_as(_ssd_tf32)), ("chunk 32", chunk32),
                      ("dt bf16", _ssd_forward_as(dt_bf16)),
                      ("fault", _ssd_forward_as(_ssd_head_fault(ops.ssd_chunked)))):
        loss_c, grads_c = loss_and_grads(ssd, pinned(), [])
        controls[name] = gap(grads_c)[0]
        finite = finite and math.isfinite(loss_c)
        del grads_c
    limit = K2_PEER_FACTOR * controls["peer"]
    top = sorted(zip(sq, names), reverse=True)[:3]
    log(f"  each Mamba2 layer's SSD on K2's inputs against the plain in fp32: K2 / the TF32 peer "
        + ", ".join(f"{k:.3e} / {t:.3e}" for k, t, _ in layers) + "; its output in the K2 run against the plain "
        "run's: " + ", ".join(f"{d:.3e}" for *_, d in layers))
    log(f"  the leaves with the largest share of ||g_K2 - g_plain||^2: "
        + ", ".join(f"{name} {100 * v / max(sum(sq), 1e-30):.1f}%" for v, name in top))
    moe_note = f", routing pinned to K2's ({moved[0]} top-k choices moved)" if cfg.num_experts else ""
    abs_note = f" and <= {grad_tol:g}" if grad_tol is not None else ""
    log(f"{what} {cfg.name} ({cfg.num_layers} layers, {mamba} Mamba2, d_model {cfg.d_model}, bf16), one "
        f"micro-batch {micro_batch} x {seq}: loss K2 {loss_k:.6f} plain {loss_p:.6f} "
        f"(rel {loss_rel:.3e} <= {TRAIN_MODEL_LOSS_TOL:g}), gradients rel_norm_err {grad_rel:.4e} "
        f"(<= {K2_PEER_FACTOR:g} x the TF32 peer's {controls['peer']:.4e} = {limit:.4e}{abs_note}); "
        f"controls: plain at chunk 32 {controls['chunk 32']:.4e}, plain with dt rounded to bf16 "
        f"{controls['dt bf16']:.4e}, K2 with head 0 from head 1 (planted fault) "
        f"{controls['fault']:.4e} {'rejected' if controls['fault'] > limit else 'FAIL (unseen)'}; "
        f"finite {finite}{moe_note}")
    if not finite or loss_rel > TRAIN_MODEL_LOSS_TOL or grad_rel > limit:
        raise AssertionError("loss or gradients through K2 disagree with the plain SSD")
    if grad_tol is not None and grad_rel > grad_tol:
        raise AssertionError("gradients through K2 disagree with the plain SSD")
    if controls["fault"] <= limit:
        raise AssertionError("the K2 gradient gate passes a planted fault")
    del params, grads_p
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


def _serve(argv: list, num_layers: int) -> dict:
    """``serve_decode``'s run of ``argv`` with the config cut to ``num_layers``:
    its summary (the caller gates completion and finite logits)."""
    from repro_torch.launch import serve_decode

    return serve_decode.serve(serve_decode.build_parser().parse_args(argv), num_layers=num_layers)


def phase_serve() -> int:
    from repro_torch.kernels.flash_attention import ops

    argv = [
        "--config", "GPT-2.7B", "--slots", "8", "--microbatches", "4",
        "--requests", "16", "--prompt-len", "128", "512", "--new-tokens", "16", "48",
        "--max-len", "576", "--seed", "0", "--device", "cuda",
    ]
    ops.launches = 0
    s = _serve(argv, None)  # all 32 layers
    launches = ops.launches
    log(f"serve GPT-2.7B ({s['num_layers']} layers, d_model {s['d_model']}): "
        f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']} tokens, "
        f"prefill p50 {s['prefill_ms_p50']:.2f} ms, decode tick p50 {s['decode_tick_ms_p50']:.2f} ms, "
        f"{s['tokens_per_second_wall']:.1f} tokens/s (wall), max_memory_allocated "
        f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
    log(f"flash launches on the serving path: {launches} "
        f"(prefill calls {s['prefill_calls']} x {s['num_layers']} layers)")
    if s["requests_completed"] < s["requests"]:
        raise AssertionError("not every request completed")
    if s["nonfinite_logits"]:
        raise AssertionError("non-finite logits during serving")
    if launches != s["prefill_calls"] * s["num_layers"] or launches == 0:
        raise AssertionError("the serving path did not run the flash kernel once per layer per prefill")
    return launches


def _plans_built_once(engine) -> dict:
    """The engine's compile cache against the plans it was switched to: each
    plan built once (a miss), every later switch to it a hit."""
    stats = engine.runtime.cache.stats
    plans = [e.to_plan for e in engine.runtime.switch_events]
    if stats.cold_misses != len(set(plans)) or stats.warm_hits != len(plans) - len(set(plans)):
        raise AssertionError(f"compile cache {stats} over the plans dispatched {plans}")
    return {"switches": len(plans), "plans": sorted(set(plans)), "misses": stats.cold_misses,
            "hits": stats.warm_hits}


def phase_serve_adaptive() -> int:
    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import serve_adaptive as sa
    from repro_torch.launch.serve_decode import where_time_goes
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import flatten

    args = SERVE_ADAPTIVE_ARGS
    free = sa.compare_adaptive_static(**args)  # the decision layer alone
    regimes = sa.chosen_specs_by_regime(
        max(12, args["max_requests"] // 3), seed=args["seed"], device_spec=args["device_spec"]
    )
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=GPT_LAYERS)
    first = ServeEngine(cfg, seed=0, device="cuda", **sa.ENGINE_ARGS)
    engines = (first, ServeEngine(cfg, params=first.params, device="cuda", **sa.ENGINE_ARGS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launches = 0
    out = sa.compare_adaptive_static(**args, engines=engines)
    launches = ops.launches
    peak = torch.cuda.max_memory_allocated()
    a, s = out["adaptive"], out["static"]
    spec = f"specs/{args['device_spec']}.json"
    log(f"serve-adaptive {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}), {sa.ENGINE_ARGS}, "
        f"{args['max_requests']} requests, regime {args['regime']}, seed {args['seed']}")
    log("  decision trail: " + ", ".join(f"t={d['t']} {d['chosen']}" for d in a["decision_trail"]))
    log(f"  kinds chosen {a['kinds_chosen']}; bursty final {regimes['bursty']['final']}, "
        f"exclusive final {regimes['exclusive']['final']}")
    for key, what in (("ttft_p99", "TTFT p99"), ("token_latency_p99", "token-latency p99")):
        log(f"  {what} (simulated, priced on {spec}): adaptive {1e3 * a[key]:.3f} ms, static {1e3 * s[key]:.3f} ms")
    log(f"  SLO attainment (simulated, {spec}): adaptive {a['slo_attainment']:.3f}, static {s['slo_attainment']:.3f}")
    for run, r, eng in (("adaptive", a, engines[0]), ("static", s, engines[1])):
        sw = sorted(r["switch_seconds"])
        per_plan = ", ".join(f"{n} {ms:.3f}" for n, ms in r["decode_tick_ms_p50_by_plan"].items())
        log(f"  {run} (measured): {r['requests_completed']} requests, {r['tokens']:.0f} tokens, {r['ticks']} ticks "
            f"({r['prefill_calls']} prefills); prefill p50 {r['prefill_ms_p50']:.3f} ms at T = 16, decode tick p50 "
            f"{r['decode_tick_ms_p50']:.3f} ms ({per_plan}), {r['tokens_per_second_wall']:.2f} tokens/s (wall), "
            f"switch seconds median {1e3 * sw[len(sw) // 2]:.4f} ms, max {1e3 * sw[-1]:.4f} ms; "
            f"cache {_plans_built_once(eng)}")
    log(f"  max_memory_allocated {peak / 2**30:.2f} GiB (both engines, one weight copy)")
    log(f"  whole outputs equal in {out['outputs_equal_share']:.3f} of the {out['requests_completed_by_both']} "
        f"requests both runs completed (printed, not gated: the batches differ); first tokens equal "
        f"{out['first_tokens_equal']}")
    want_launches = (a["prefill_calls"] + s["prefill_calls"]) * cfg.num_layers
    log(f"flash launches on the serve-adaptive path: {launches} ((prefill calls {a['prefill_calls']} + "
        f"{s['prefill_calls']}) x {cfg.num_layers} layers = {want_launches})")
    for run, r in (("adaptive", a), ("static", s)):
        if not r["requests_completed_exactly"] == r["requests_completed"] >= args["max_requests"]:
            raise AssertionError(f"{run}: not every request completed with exactly its max_new_tokens")
        if r["nonfinite_logits"]:
            raise AssertionError(f"{run}: non-finite logits")
        if {k: v for k, v in r.items() if k in free[run]} != free[run]:
            raise AssertionError(f"{run}: the simulated summary differs from the engine-free run's")
    if len(a["kinds_chosen"]) < 2:
        raise AssertionError("the adaptive trail crosses fewer than two kinds")
    if regimes["bursty"]["final"] == regimes["exclusive"]["final"]:
        raise AssertionError("the bursty and exclusive regimes end on the same plan")
    if launches != want_launches or launches == 0:
        raise AssertionError("the serve-adaptive path did not run K1 once per layer per prefill")
    if not out["first_tokens_equal"]:
        raise AssertionError("a request's first token differs between the adaptive and static runs")
    # where a decode tick's and a 16-token prefill's time goes (after the
    # counts were read: these launches are not the path's)
    for name, p in where_time_goes(engines[0], 16).items():
        log(f"  traced {name} ({engines[0].runtime.current_table.plan.name}): wall {p['wall_ms']:.3f} ms, device "
            f"{p['device_ms']:.3f} ms (busy {100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms")
        for op in p["top"][:6]:
            log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    # the engines go: no reference cycle holds one, so their weights and
    # caches are freed at once, before any garbage collection (none may run
    # in between)
    weights = sum(t.numel() * t.element_size() for t in flatten(first.params).values())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.disable()
    try:
        del first, engines, eng
        dropped = torch.cuda.memory_allocated()
    finally:
        gc.enable()
    gc.collect()
    collected = torch.cuda.memory_allocated()
    log(f"  engines dropped: memory_allocated {before / 2**30:.3f} GiB -> {dropped / 2**30:.3f} GiB before any "
        f"garbage collection, {collected / 2**30:.3f} GiB after one (one weight copy: {weights / 2**30:.3f} GiB)")
    if before - dropped < weights:
        raise AssertionError("dropping the serve engines did not free their weights without a garbage collection")
    return launches


def phase_serve_ssm() -> None:
    from repro_torch.configs.mamba2_780m import FULL
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve_decode
    from repro_torch.launch.profiling import device_profile
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine

    argv = ["--device", "cuda"]
    for k, v in SERVE_SSM_ARGS.items():
        argv += [f"--{k}", *map(str, v if isinstance(v, tuple) else (v,))]
    ssd_ops.launches = 0
    s = _serve(argv, None)  # all 48 layers
    k2 = ssd_ops.launches
    log(f"serve-ssm {s['config']} ({s['num_layers']} layers, d_model {s['d_model']}), {s['slots']} slots on "
        f"{s['grid']}: {s['requests_completed']}/{s['requests']} requests, {s['tokens']:.0f} tokens, prefill p50 "
        f"{s['prefill_ms_p50']:.2f} ms, decode tick p50 {s['decode_tick_ms_p50']:.2f} ms, "
        f"{s['tokens_per_second_wall']:.2f} tokens/s (wall), max_memory_allocated "
        f"{s['max_memory_allocated'] / 2**30:.2f} GiB; K2 launches {k2}")
    if s["requests_completed"] < s["requests"] or s["nonfinite_logits"]:
        raise AssertionError("not every request completed, or a non-finite logit")
    gc.collect()  # serve_decode's engine, before this phase builds its own
    if k2 != 0:
        raise AssertionError("K2 ran on the SSM serving path, which is the recurrence")
    # one request's fused prefill against stepping mamba_decode over its
    # prompt, on the card: the logits and every state leaf, bitwise
    cfg = FULL
    engine = ServeEngine(cfg, 4, SERVE_SSM_ARGS["slots"], SERVE_SSM_ARGS["max-len"], seed=0, device="cuda")
    prompt = engine.default_prompt(0, SERVE_SSM_ARGS["prompt-len"][0])
    fused = api.init_cache(cfg, 1, SERVE_SSM_ARGS["max-len"], device="cuda")
    logits, fused = api.prefill_with_cache(engine.params, cfg, fused, {"tokens": prompt})
    stepped = api.init_cache(cfg, 1, SERVE_SSM_ARGS["max-len"], device="cuda")
    for i in range(prompt.shape[1]):
        step_logits, stepped = api.decode_fn(engine.params, cfg, stepped, i, {"tokens": prompt[:, i : i + 1]})
    torch.cuda.synchronize()
    same = torch.equal(logits, step_logits) and all(
        torch.equal(a["ssm"][k], b["ssm"][k]) for a, b in zip(fused["layers"], stepped["layers"]) for k in a["ssm"]
    )
    log(f"serve-ssm fused prefill of {prompt.shape[1]} tokens vs {prompt.shape[1]} decode steps on the card: "
        f"logits and {2 * cfg.num_layers} state leaves bitwise equal {same}")
    if not same:
        raise AssertionError("the fused SSM prefill is not bitwise equal to token stepping")
    # where a decode tick's time goes
    engine.switch_to(serve_decode.static_candidate(4, engine.max_slots, SERVE_SSM_ARGS["microbatches"]).plan.lower())

    def tick():
        engine.decode_tick([])
        engine.synchronize()

    tick()
    t0 = time.perf_counter()
    tick()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    prof = device_profile(tick, engine.device, {})
    log(f"  traced decode tick: wall {wall_ms:.3f} ms, device {prof['device_ms']:.3f} ms "
        f"(busy {100 * prof['device_ms'] / wall_ms:.1f}%)")
    for op in prof["top"][:6]:
        log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")


def phase_serve_dense() -> int:
    from repro_torch.kernels.flash_attention import ops

    launches = 0
    for arch, layers, prompt_len, max_len in SERVE_DENSE:
        before = torch.cuda.memory_allocated()
        argv = ["--config", arch, "--prompt-len", *map(str, prompt_len), "--max-len", str(max_len),
                "--device", "cuda", "--profile"]
        for k, v in SERVE_DENSE_ARGS.items():
            argv += [f"--{k}", *map(str, v if isinstance(v, tuple) else (v,))]
        n0 = ops.launches
        s = _serve(argv, layers)
        n = ops.launches - n0
        left = torch.cuda.memory_allocated() - before  # the engine dropped, no collection yet
        launches += n
        limit = s["weight_bytes"] + s["cache_bytes"] + SERVE_DENSE_HEADROOM
        peak = max(s["setup_max_memory_allocated"], s["max_memory_allocated"])
        log(f"serve-dense {arch} ({s['num_layers']} layers, d_model {s['d_model']}), {s['slots']} slots on "
            f"{s['grid']}, prompts {prompt_len[0]}-{prompt_len[1]}, max_len {max_len}: "
            f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']:.0f} tokens, prefill p50 "
            f"{s['prefill_ms_p50']:.2f} ms, decode tick p50 {s['decode_tick_ms_p50']:.2f} ms, "
            f"{s['tokens_per_second_wall']:.2f} tokens/s (wall), setup {s['setup_seconds']:.1f} s")
        log(f"  weights {s['weight_bytes'] / 2**30:.2f} GiB (bf16 matrices), cache {s['cache_bytes'] / 2**30:.2f} "
            f"GiB; max_memory_allocated setup {s['setup_max_memory_allocated'] / 2**30:.2f} GiB, serving "
            f"{s['max_memory_allocated'] / 2**30:.2f} GiB (<= {limit / 2**30:.2f}); left after the run "
            f"{left / 2**30:.3f} GiB before any collection; K1 launches {s['flash_launches']} (prefill calls "
            f"{s['prefill_calls']} x {s['num_layers']} layers), {n} with the traced prefills")
        for name, p in s["profile"].items():
            log(f"  traced {name}: wall {p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms (busy "
                f"{100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms")
        if s["requests_completed"] < s["requests"] or s["nonfinite_logits"]:
            raise AssertionError(f"{arch}: not every request completed, or a non-finite logit")
        # where_time_goes prefills three more times: a warm-up, a timed and a traced run
        if s["flash_launches"] != s["prefill_calls"] * s["num_layers"] or n != s["flash_launches"] + 3 * s["num_layers"]:
            raise AssertionError(f"{arch}: K1 did not run once per layer per prefill")
        if peak > limit:
            raise AssertionError(f"{arch}: peak {peak} over weights + cache + {SERVE_DENSE_HEADROOM} bytes")
        if left > SERVE_DENSE_LEFT:
            raise AssertionError(f"{arch}: {left} bytes stayed allocated after the engine was dropped")
    return launches


def phase_train_dense() -> int:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train

    launches = 0
    for arch, layers, batch, seq, M in TRAIN_DENSE:
        args = argparse.Namespace(
            arch=arch, smoke=False, batch=batch, seq=seq, microbatches=M, device="cuda", log_every=1,
            profile=True, **TRAIN_DENSE_ARGS,
        )
        n0 = ops.launches
        s = train.train(args, num_layers=layers)[0]  # the state dropped at once
        n = ops.launches - n0
        launches += n
        want = layers * M * s["steps"]
        p = s["profile"]
        log(f"train-dense {arch} ({layers} layers, d_model {s['d_model']}, {s['param_count']:,} parameters): "
            f"{s['steps']} steps of {batch} x {seq} in M={M}; loss {s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}; "
            f"step p50 {s['step_ms_p50']:.1f} ms (first {s['step_ms'][0]:.1f} ms), {s['tokens_per_second']:,.0f} "
            f"tokens/s, max_memory_allocated {s['max_memory_allocated'] / 2**30:.2f} GiB")
        log(f"  parameter norm {s['param_norm'][0]!r} -> {s['param_norm'][1]!r}, {s['leaves_updated']} of "
            f"{s['leaves']} leaves changed by the steps")
        log(f"  grad norms {[round(v, 4) for v in s['grad_norms']]}; traced step: wall {p['wall_ms']:.1f} ms, "
            f"device {p['device_ms']:.1f} ms (busy {100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms")
        for op in p["top"][:6]:
            log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
        log(f"  K1 launches {s['flash_launches']} ({layers} layers x {M} micro-batches x {s['steps']} steps = "
            f"{want}), {n} with the traced steps")
        if s["flash_launches"] != want or n != layers * M * (s["steps"] + 2):
            raise AssertionError(f"{arch}: K1 did not run once per layer per micro-batch")
        if not all(math.isfinite(v) for v in s["losses"] + s["grad_norms"]):
            raise AssertionError(f"{arch}: non-finite loss or clip norm")
        if s["leaves_updated"] != s["leaves"]:
            raise AssertionError(f"{arch}: the steps left {s['leaves'] - s['leaves_updated']} parameter leaves as drawn")
        del s
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_model_moe() -> int:
    from repro_torch.configs import get_arch

    launches = 0
    for arch, layers, prompt_len in MODEL_MOE:
        launches += _model_check(get_arch(arch).model.replace(num_layers=layers), prompt_len, moe_gate=True)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_serve_moe() -> int:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops

    launches = 0
    for arch, layers, prompt_len, max_len in SERVE_MOE:
        before = torch.cuda.memory_allocated()
        argv = ["--config", arch, "--prompt-len", *map(str, prompt_len), "--max-len", str(max_len),
                "--device", "cuda", "--profile"]
        for k, v in SERVE_DENSE_ARGS.items():
            argv += [f"--{k}", *map(str, v if isinstance(v, tuple) else (v,))]
        n0 = ops.launches
        s = _serve(argv, layers)
        n = ops.launches - n0
        left = torch.cuda.memory_allocated() - before  # the engine dropped, no collection yet
        launches += n
        cfg = get_arch(arch).model
        bank = 4 * cfg.num_experts * cfg.d_model * cfg.expert_ff  # one fp32 expert bank
        limit = s["weight_bytes"] + s["cache_bytes"] + SERVE_MOE_HEADROOM
        A = s["attention_layers"]
        log(f"serve-moe {arch} ({s['num_layers']} layers, {A} attention, d_model {s['d_model']}), {s['slots']} "
            f"slots on {s['grid']}, prompts {prompt_len[0]}-{prompt_len[1]}, max_len {max_len}: "
            f"{s['requests_completed']}/{s['requests']} requests, {s['tokens']:.0f} tokens, prefill p50 "
            f"{s['prefill_ms_p50']:.2f} ms, decode tick p50 {s['decode_tick_ms_p50']:.2f} ms, "
            f"{s['tokens_per_second_wall']:.2f} tokens/s (wall), setup {s['setup_seconds']:.1f} s")
        log(f"  weights {s['weight_bytes'] / 2**30:.2f} GiB (bf16 matrices and expert banks), cache "
            f"{s['cache_bytes'] / 2**30:.2f} GiB; max_memory_allocated setup "
            f"{s['setup_max_memory_allocated'] / 2**30:.2f} GiB (<= {(limit + bank) / 2**30:.2f}, one fp32 bank "
            f"{bank / 2**30:.2f} GiB in the draw), serving {s['max_memory_allocated'] / 2**30:.2f} GiB "
            f"(<= {limit / 2**30:.2f}); left after the run {left / 2**30:.3f} GiB before any collection; K1 "
            f"launches {s['flash_launches']} (prefill calls {s['prefill_calls']} x {A} attention layers), {n} "
            f"with the traced prefills")
        for name, p in s["profile"].items():
            log(f"  traced {name}: wall {p['wall_ms']:.3f} ms, device {p['device_ms']:.3f} ms (busy "
                f"{100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms")
            for op in p["top"][:5]:
                log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
        if s["requests_completed"] < s["requests"] or s["nonfinite_logits"]:
            raise AssertionError(f"{arch}: not every request completed, or a non-finite logit")
        # where_time_goes prefills three more times: a warm-up, a timed and a traced run
        if s["flash_launches"] != s["prefill_calls"] * A or n != s["flash_launches"] + 3 * A:
            raise AssertionError(f"{arch}: K1 did not run once per attention layer per prefill")
        if s["max_memory_allocated"] > limit or s["setup_max_memory_allocated"] > limit + bank:
            raise AssertionError(f"{arch}: peak over weights + cache + {SERVE_MOE_HEADROOM} bytes (+ one bank)")
        if left > SERVE_DENSE_LEFT:
            raise AssertionError(f"{arch}: {left} bytes stayed allocated after the engine was dropped")
        del s
    return launches


def phase_train_moe() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train
    from repro_torch.models.common import layer_specs

    launches = {"flash": 0, "ssd": 0}
    for arch, layers, experts, batch, seq in TRAIN_MOE:
        cfg = get_arch(arch).model.replace(num_layers=layers, num_experts=experts)
        kinds = [spec.kind for spec in layer_specs(cfg)]
        if "mamba" in kinds:  # the first micro-batch through K2 and through the plain SSD
            _k2_against_plain(cfg, batch, seq, "train-moe")
            gc.collect()
        args = argparse.Namespace(
            arch=arch, smoke=False, batch=batch, seq=seq, microbatches=1, device="cuda", log_every=1,
            profile=True, **TRAIN_MOE_ARGS,
        )
        f0, s0 = flash_ops.launches, ssd_ops.launches
        s = train.train(args, num_layers=layers, num_experts=experts)[0]
        nf, ns = flash_ops.launches - f0, ssd_ops.launches - s0
        launches["flash"] += nf
        launches["ssd"] += ns
        A, Mb, steps = kinds.count("attn"), kinds.count("mamba"), s["steps"]
        p = s["profile"]
        log(f"train-moe {arch} ({layers} layers: {A} attention, {Mb} Mamba2, {sum(sp.moe for sp in layer_specs(cfg))} "
            f"MoE of {experts} experts top-{cfg.num_experts_per_tok}; d_model {s['d_model']}, "
            f"{s['param_count']:,} parameters, {s['optimizer']}): {steps} steps of {batch} x {seq}; loss "
            f"{s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}; step p50 {s['step_ms_p50']:.1f} ms (first "
            f"{s['step_ms'][0]:.1f} ms), {s['tokens_per_second']:,.0f} tokens/s, max_memory_allocated "
            f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
        log(f"  moe_load_balance {[round(v, 4) for v in s['moe_load_balance']]}, moe_router_z "
            f"{[round(v, 4) for v in s['moe_router_z']]}; grad norms {[round(v, 4) for v in s['grad_norms']]}")
        log(f"  parameter norm {s['param_norm'][0]!r} -> {s['param_norm'][1]!r}, {s['leaves_updated']} of "
            f"{s['leaves']} leaves changed by the steps")
        log(f"  traced step: wall {p['wall_ms']:.1f} ms, device {p['device_ms']:.1f} ms (busy "
            f"{100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms, K2 {p['ssd_ms']:.3f} ms")
        for op in p["top"][:6]:
            log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
        log(f"  K1 launches {s['flash_launches']} ({A} x {steps} steps), K2 {s['ssd_launches']} ({Mb} x {steps}); "
            f"{nf} and {ns} with the traced steps")
        if (s["flash_launches"], s["ssd_launches"]) != (A * steps, Mb * steps) or (nf, ns) != (
            A * (steps + 2), Mb * (steps + 2)
        ):
            raise AssertionError(f"{arch}: K1 or K2 did not run once per layer per step")
        values = s["losses"] + s["grad_norms"] + s["moe_load_balance"] + s["moe_router_z"]
        if len(s["moe_load_balance"]) != steps or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{arch}: non-finite loss, clip norm or MoE term")
        if s["leaves_updated"] != s["leaves"]:
            raise AssertionError(f"{arch}: the steps left {s['leaves'] - s['leaves_updated']} parameter leaves as drawn")
        del s
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _three_ways(cfg, params, batch):
    """Logits [B, T, V] through K1, through the plain attention, and in fp32
    through the plain attention on the same (bf16-rounded) weights; K1's
    calls captured for the layer gate.  Returns (kern, plain, truth, calls,
    K1 launches by kind)."""
    from unittest import mock

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    from repro_torch.tree import tree_map

    flash, calls = ops.flash_attention_train, []

    def capture(q, k, v, causal=True, window=None):  # each layer's K1 call of the forward
        out = flash(q, k, v, causal=causal, window=window)
        calls.append((q, k, v, causal, window, out))
        return out

    k0 = dict(attn.k1_launches)
    with torch.no_grad():
        with mock.patch.object(ops, "flash_attention_train", capture):
            kern = api.forward_fn(params, cfg, batch)[0].float()
        by_kind = {k: attn.k1_launches[k] - k0[k] for k in k0}
        plain = api.forward_fn(params, cfg, batch, plain_attention=True)[0].float()
        params32 = tree_map(lambda t: t.float(), params)
        truth = api.forward_fn(params32, cfg.replace(dtype=torch.float32), batch, plain_attention=True)[0].float()
        del params32
    torch.cuda.synchronize()
    return kern, plain, truth, calls, by_kind


def phase_model_encdec_vlm() -> int:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import api
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import encoder_config, layer_specs

    launches, P = 0, MODEL_ENCDEC_VLM_DECODE
    for arch, B, T in MODEL_ENCDEC_VLM:
        cfg = get_arch(arch).model
        params = api.init_serving_params(cfg, seed=0, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=g, device="cuda")
        encdec = cfg.family == "encdec"
        want = {"decoder": cfg.num_layers, "encoder": 0, "cross": 0}
        if encdec:
            src = 0.02 * torch.randn((B, max(T // 8, 1), cfg.d_model), generator=g, device="cuda")
            batch = {"src_embeds": src, "tgt_tokens": tokens}
            want.update(encoder=len(layer_specs(encoder_config(cfg), cfg.encoder_layers)), cross=cfg.num_layers)
            what = f"{T} target tokens over {src.shape[1]} source frames"
        else:  # patch embeddings: a VLM_GRID x VLM_GRID image at t = 0, then text on all three streams
            n_img = VLM_GRID * VLM_GRID
            i = torch.arange(T, device="cuda")
            img = torch.stack([torch.zeros_like(i), i // VLM_GRID, i % VLM_GRID])
            pos = torch.where(i < n_img, img, (i - n_img + VLM_GRID).expand(3, T))
            batch = {
                "embeds": 0.02 * torch.randn((B, T, cfg.d_model), generator=g, device="cuda"),
                "mrope_positions": pos[:, None, :].expand(3, B, T),
            }
            what = f"{T} patch embeddings ({n_img} image patches on a {VLM_GRID} x {VLM_GRID} grid, then text)"
        n0 = ops.launches
        kern, plain, truth, calls, by_kind = _three_ways(cfg, params, batch)
        n = ops.launches - n0
        ok, err_k, err_p = _oracle_errors(kern, plain, truth)
        log(f"model-encdec-vlm {arch} (d_model {cfg.d_model}, {cfg.num_heads} heads over {cfg.num_kv_heads} at hd "
            f"{cfg.hd}, {cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers), B {B} x {what}: K1 launches "
            f"{n} ({', '.join(f'{k} {v}' for k, v in by_kind.items())}); logits against fp32 over every position: "
            f"K1 {err_k:.3e}, plain bf16 {err_p:.3e} (K1 <= max({MODEL_ORACLE_FACTOR:g} x plain, {MODEL_TOL}))")
        if by_kind != want or n != sum(want.values()) or len(calls) != n:
            raise AssertionError(f"{arch}: K1 ran {by_kind}, the forward has {want} attention layers")
        if not (ok and torch.isfinite(kern).all() and torch.isfinite(plain).all()):
            raise AssertionError(f"{arch}: K1 and plain logits disagree")
        _layer_gate(calls, ops.flash_attention)
        launches += n
        del kern, plain, truth, calls
        # decode: P tokens stepped from an empty cache against the teacher-forced forward
        toks = tokens[:, :P]
        if encdec:
            n0 = ops.launches
            with torch.no_grad():
                memory = tf._encode(params, cfg, src)
            n_enc = ops.launches - n0
            if n_enc != want["encoder"]:
                raise AssertionError(f"{arch}: the encoder ran K1 {n_enc} times, not {want['encoder']}")
            launches += n_enc
            tf_batch = {"src_embeds": src, "tgt_tokens": toks}
        else:
            memory = None
            tf_batch = {
                "embeds": tf.embed(params["embed"], toks, cfg).float(),
                "mrope_positions": torch.arange(P, device="cuda").expand(3, B, P),
            }
        n0 = ops.launches
        kern, plain, truth, _, by_kind = _three_ways(cfg, params, tf_batch)
        n = ops.launches - n0
        if by_kind != want or n != sum(want.values()):
            raise AssertionError(f"{arch}: the teacher-forced forward ran K1 {by_kind}, it has {want} attention layers")
        launches += n
        cache = api.init_cache(cfg, B, P, device="cuda")
        steps, n0 = [], ops.launches
        with torch.no_grad():
            for t in range(P):
                b = {"tokens": toks[:, t : t + 1]}
                if encdec:
                    b["memory"] = memory
                logits, cache = api.decode_fn(params, cfg, cache, t, b)
                steps.append(logits[:, 0].float())
        torch.cuda.synchronize()
        if ops.launches != n0:
            raise AssertionError(f"{arch}: decode launched K1 {ops.launches - n0} times")
        step = torch.stack(steps, dim=1)
        ok_k, err_k, err_p = _oracle_errors(kern, plain, truth)
        ok_s, err_s, _ = _oracle_errors(step, plain, truth)
        flips = _greedy_gate(step, truth, f"{arch} decode") + _greedy_gate(kern, truth, f"{arch} teacher-forced K1")
        log(f"  decode: {P} tokens stepped through decode_fn (K1 none) against the teacher-forced forward, "
            f"logits against fp32: stepping {err_s:.3e}, K1 forward {err_k:.3e}, plain bf16 forward {err_p:.3e} "
            f"(each <= max({MODEL_ORACLE_FACTOR:g} x plain, {MODEL_TOL})); greedy disagreements within the top-2 "
            f"gap {flips}")
        if not (ok_k and ok_s and torch.isfinite(step).all()):
            raise AssertionError(f"{arch}: decode stepping disagrees with the teacher-forced forward")
        del params, kern, plain, truth, step, steps, cache, memory
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _ckpt_check() -> None:
    """CKPT_CHECK's arch trained ``steps`` steps with a checkpoint every
    ``every``; its last checkpoint removed; the run again from the same
    directory, which resumes at the one before: its losses and final
    parameter norm equal the unbroken run's, bitwise."""
    from repro_torch.launch import train

    c = CKPT_CHECK
    d = tempfile.mkdtemp(prefix="ckpt_check_")
    try:
        args = argparse.Namespace(
            arch=c["arch"], smoke=False, batch=c["batch"], seq=c["seq"], microbatches=1, device="cuda",
            log_every=c["steps"], profile=False, ckpt_dir=d, ckpt_every=c["every"], steps=c["steps"],
            **{k: v for k, v in TRAIN_ENCDEC_VLM_ARGS.items() if k != "steps"},
        )
        t = time.perf_counter()
        a = train.train(args, num_layers=c["layers"])[0]
        t_a = time.perf_counter() - t
        saved = sorted(os.listdir(d))
        nbytes = sum(os.path.getsize(os.path.join(d, s, f)) for s in saved for f in os.listdir(os.path.join(d, s)))
        shutil.rmtree(os.path.join(d, f"step_{c['steps']}"))
        t = time.perf_counter()
        b = train.train(args, num_layers=c["layers"])[0]
        t_b = time.perf_counter() - t
    finally:
        shutil.rmtree(d, ignore_errors=True)
    k = c["every"]
    log(f"  checkpoint check: {c['arch']} at {c['layers']} layer(s), {a['param_count']:,} parameters, b "
        f"{c['batch']} x T {c['seq']}: {c['steps']} steps saving {saved} ({nbytes / 2**30:.2f} GiB) in {t_a:.1f} s; "
        f"resumed from step {b['resumed_from']} in {t_b:.1f} s: losses {b['losses']} against {a['losses'][k:]}, "
        f"parameter norm {b['param_norm'][1]!r} against {a['param_norm'][1]!r}")
    if b["resumed_from"] != k or b["losses"] != a["losses"][k:] or b["param_norm"][1] != a["param_norm"][1]:
        raise AssertionError("the resumed run parts from the unbroken one")


def phase_train_encdec_vlm() -> int:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.models.common import encoder_config, layer_specs

    launches = 0
    for arch, batch, seq, M in TRAIN_ENCDEC_VLM:
        cfg = get_arch(arch).model
        args = argparse.Namespace(
            arch=arch, smoke=False, batch=batch, seq=seq, microbatches=M, device="cuda", log_every=1,
            profile=True, **TRAIN_ENCDEC_VLM_ARGS,
        )
        n0 = ops.launches
        s, state = train.train(args)
        with torch.no_grad():  # the first batch's loss after the steps and the two traced ones
            first = train._batch_dict(cfg, train.dataset(cfg, args).batch_at(0, "cuda"))
            held = [s["losses"][0], float(api.loss_fn(state.params, cfg, first)[0])]
        del state, first
        n = ops.launches - n0
        launches += n
        steps, p = s["steps"], s["profile"]
        per = {"decoder": cfg.num_layers, "encoder": 0, "cross": 0}
        if cfg.family == "encdec":
            per.update(encoder=len(layer_specs(encoder_config(cfg), cfg.encoder_layers)), cross=cfg.num_layers)
        want = {k: v * M * steps for k, v in per.items()}
        got = {k: s[f"flash_launches_{k}"] for k in per}
        log(f"train-encdec-vlm {arch} ({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, d_model "
            f"{s['d_model']}, {s['param_count']:,} parameters, {s['optimizer']}): {steps} steps of {batch} x {seq} in "
            f"M={M}; losses {[round(v, 4) for v in s['losses']]}; step p50 {s['step_ms_p50']:.1f} ms (first "
            f"{s['step_ms'][0]:.1f} ms), {s['tokens_per_second']:,.0f} tokens/s, max_memory_allocated "
            f"{s['max_memory_allocated'] / 2**30:.2f} GiB")
        log(f"  the first batch's loss before the steps (the first step's) and after them and the two traced "
            f"steps {held[0]!r} -> {held[1]!r}")
        log(f"  parameter norm {s['param_norm'][0]!r} -> {s['param_norm'][1]!r}, {s['leaves_updated']} of "
            f"{s['leaves']} leaves changed by the steps; grad norms {[round(v, 4) for v in s['grad_norms']]}")
        log(f"  traced step: wall {p['wall_ms']:.1f} ms, device {p['device_ms']:.1f} ms (busy "
            f"{100 * p['device_busy_share']:.1f}%), K1 {p['flash_ms']:.3f} ms")
        for op in p["top"][:6]:
            log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
        log(f"  K1 launches {got} (layers x {M} micro-batches x {steps} steps: {want}), {n} with the traced steps "
            f"and the forward of the first batch")
        if got != want or s["flash_launches"] != sum(want.values()) or n != sum(per.values()) * (M * (steps + 2) + 1):
            raise AssertionError(f"{arch}: K1 did not run once per attention layer per micro-batch")
        if not all(math.isfinite(v) for v in s["losses"] + s["grad_norms"]):
            raise AssertionError(f"{arch}: non-finite loss or clip norm")
        if not held[1] < held[0]:
            raise AssertionError(f"{arch}: the first batch's loss did not fall")
        if s["leaves_updated"] != s["leaves"]:
            raise AssertionError(f"{arch}: the steps left {s['leaves'] - s['leaves_updated']} parameter leaves as drawn")
        del s
        gc.collect()
        torch.cuda.empty_cache()
    _ckpt_check()
    gc.collect()
    torch.cuda.empty_cache()
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

    L, S, M, b, T = PIPE_MODEL
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=L)  # bf16 compute, fp32 parameters
    data = SyntheticTextDataset(cfg.vocab_size, T, M * b).batch_at(0, "cuda")
    tokens, labels = data.tokens.reshape(M, b, T), data.labels.reshape(M, b, T)

    def engine(staged, params, plan):
        loss, grads = reference_pipeline_grads(staged, params, tokens, labels, plan)
        torch.cuda.synchronize()
        return float(loss), _flat(grads)

    cache = {}
    for kw in PIPE_MODEL_PLANS:
        plan = make_plan(S, M, spec=ScheduleSpec(**kw))
        V = plan.total_virtual_stages
        if V not in cache:
            staged = StagedModel.build(cfg, V)
            params = staged.init_all_stages(torch.Generator(device="cuda").manual_seed(0))
            cache.clear()  # one model on the card at a time
            loss_o, grads_o = _oracle(staged, params, tokens, labels)
            cache[V] = (staged, params, (loss_o, _flat(grads_o)))
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

    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=GPT_LAYERS)
    ops.launches = 0
    s = train.run_pipeline(
        cfg, PIPE_STAGES, ScheduleSpec(kind="kfkb", k=PIPE_K), seed=0, log_every=1, device="cuda",
        profile=True, engine="reference", **PIPE_ARGS,
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
    return launches, s["losses"][0]


def _gpt_fwd_flops(cfg, layers: int, b: int, T: int) -> int:
    """A stage's fwd FLOPs in closed form: per layer the q, k, v, o and the
    two MLP products, 2 * (4 d^2 + 2 d d_ff) * b T, and the attention's two
    products over the full T x T square, 4 b H T^2 hd.  The embedding is a
    gather (no products); the tied head runs inside the last stage's
    backward programs, not in its fwd."""
    d, ff = cfg.d_model, cfg.d_ff
    return layers * (2 * (4 * d * d + 2 * d * ff) * b * T + 4 * b * cfg.num_heads * T * T * cfg.hd)


def phase_calibrate() -> int:
    import types

    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.core import StageCosts, WorkloadProfile, derive_memory_model
    from repro_torch.core import calibrate as calib
    from repro_torch.core.devicespec import TASK_PROGRAMS
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.launch import dryrun_pipeline
    from repro_torch.pipeline.stage import StagedModel

    name, S, b, T = (CALIBRATE_ARGS[k] for k in ("config", "S", "b_mb", "seq"))
    cfg = GPT_CONFIGS[name]
    L = cfg.num_layers // S
    spec, _ = _h100()
    out = os.path.join(ROOT, "build", "calibrate")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec, launches = {}, None
    for method in CALIBRATE_METHODS:
        ops.launches = 0
        rec[method] = dryrun_pipeline.calibrate(name, S, b, T, os.path.join(out, method), method=method, device="cuda")
        if method == "wallclock":
            launches = ops.launches
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = {m: WorkloadProfile.from_json(r["workload"]).counts for m, r in rec.items()}

    # each program counted as it runs through K1 on the card, against the
    # record's counts (FLOPs through the plain attention, bytes through K1, on meta)
    staged = StagedModel.build(cfg, S)
    k1_counts = [calib.count_programs(staged, s, b, T, device="cuda") for s in range(S)]
    torch.cuda.empty_cache()
    recompute = L * flash_ref.train_attention_flops(b, T, T, cfg.num_heads, cfg.hd)

    peak_flops = spec.peak_flops_for(rec["spec"]["dtype"])
    log(f"calibrate {name} (S={S}, {L} layers a stage, b={b} x T={T}, bf16 compute) on {rec['spec']['card']}: "
        f"spec {rec['spec']['device']}, wall clock {rec['wallclock']['device']}; "
        f"{seconds:.1f} s, max_memory_allocated {peak / 2**30:.2f} GiB")
    log("  stage program           GFLOP    HBM GB  spec ms  FLOP-only ms  wall ms  wall/spec  "
        "spread %  K1 GFLOP")
    for s in range(S):
        for p in TASK_PROGRAMS:
            c = counts["spec"][s][p]
            spec_ms, wall_ms = 1e3 * rec["spec"][f"{p}_time"][s], 1e3 * rec["wallclock"][f"{p}_time"][s]
            runs = rec["wallclock"]["repeat_seconds"][p][s]
            spread = 100 * (max(runs) - min(runs)) / (sum(runs) / len(runs))
            log(f"  {s:5d} {p:16s} {c.flops / 1e9:9.3f} {c.hbm_bytes / 1e9:9.3f} {spec_ms:8.3f} "
                f"{1e3 * c.flops / peak_flops:13.3f} {wall_ms:8.3f} {wall_ms / spec_ms:10.2f} "
                f"{spread:9.2f} {k1_counts[s][p].flops / 1e9:9.3f}")
            log(f"        timed runs (ms): {[round(1e3 * r, 3) for r in runs]}")
    for m, r in rec.items():
        log(f"  {m}: admitted warmup vector {r['admitted_warmup_vector']} under limits "
            f"{[round(x / 2**30, 2) for x in r['limit_curve']]} GiB")

    # the tuner on the spec's costs, and on the card's wall-clock costs (the
    # spec's limits and link bandwidth: only the costs are swapped)
    wall = rec["wallclock"]
    wall_costs = StageCosts(
        fwd_time=wall["fwd_time"],
        bwd_time=[bi + bw for bi, bw in zip(wall["bwd_input_time"], wall["bwd_weight_time"])],
        fwd_bytes=wall["fwd_bytes"], bwd_bytes=wall["fwd_bytes"],
        bwd_input_time=wall["bwd_input_time"], bwd_weight_time=wall["bwd_weight_time"],
        bwd_weight_saved_time=wall["bwd_weight_saved_time"],
    )
    on_card = types.SimpleNamespace(
        costs=wall_costs, limits=spec.limit_curve(S),
        memory=derive_memory_model(WorkloadProfile.from_json(rec["spec"]["workload"])),
    )
    tuned_card = dryrun_pipeline._tune_on_spec(on_card, spec, S, b)
    for label, tuned in (("spec costs", rec["spec"]["tuned"]), ("wall-clock costs", tuned_card)):
        est = tuned["estimates"][tuned["chosen"]["name"]]
        log(f"  tuner on the {label}: {tuned['chosen']['name']} (estimate {1e3 * est:.3f} ms of "
            f"{len(tuned['candidates'])} candidates)")
    log(f"flash launches on the calibrate path (the wall-clock run): {launches}")

    # gates
    for m in CALIBRATE_METHODS:
        r = rec[m]
        for s in range(S):
            for p in TASK_PROGRAMS:
                c, t = counts[m][s][p], r[f"{p}_time"][s]
                if not all(math.isfinite(x) and x > 0 for x in (c.flops, c.hbm_bytes, t)):
                    raise AssertionError(f"{m}: stage {s} {p} has a count or time that is not finite and positive")
            if not r["bwd_weight_saved_time"][s] < r["bwd_weight_time"][s]:
                raise AssertionError(f"{m}: stage {s} bwd_weight_saved is not below bwd_weight")
        for p in ("bwd_input", "bwd_weight"):
            if not r[f"{p}_time"][-1] > max(r[f"{p}_time"][1:-1]):
                raise AssertionError(f"{m}: the last stage's {p} does not exceed every middle stage's")
    for s in range(S):
        for p in TASK_PROGRAMS:
            k1, c = k1_counts[s][p], counts["spec"][s][p]
            extra = 0 if p == "fwd" else recompute
            if k1.flops != c.flops + extra:
                raise AssertionError(f"stage {s} {p}: {k1.flops} FLOPs through K1, {c.flops} through the "
                                     f"plain attention, {extra} recomputed by the backward")
            if k1.hbm_bytes != c.hbm_bytes:
                raise AssertionError(f"stage {s} {p}: {k1.hbm_bytes} bytes through K1 on the card, "
                                     f"{c.hbm_bytes} counted on meta")
        want = _gpt_fwd_flops(cfg, L, b, T)
        if abs(counts["spec"][s]["fwd"].flops - want) > CALIBRATE_FLOPS_TOL * want:
            raise AssertionError(f"stage {s} fwd: {counts['spec'][s]['fwd'].flops} FLOPs, closed form {want}")
    # every program but W(SR) runs the stage forward in its timed body,
    # W(SR) in the B it replays from (its untimed setup): each once a run
    want = S * len(TASK_PROGRAMS) * L * (calib.WARMUP + calib.REPEATS)
    if launches != want:
        raise AssertionError(f"K1 ran {launches} times in the wall-clock calibration, the programs imply {want}")
    return launches


def phase_adaptive() -> int:
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train_adaptive

    ops.launches = 0
    sc = train_adaptive.build_fig10_scenario(device="cuda", num_layers=GPT_LAYERS, **ADAPTIVE_ARGS)
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
    first_loss = s["per_iteration"][0]["loss"]
    del sc, rt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, first_loss


def _flat(trees: list) -> list:
    """The leaves of a list of trees, in flatten order."""
    from repro_torch.tree import flatten

    return [g for ps in trees for g in flatten(ps).values()]


def _oracle(staged, params, tokens, labels):
    """Autograd of the mean of the unpipelined full_loss over the
    micro-batches: (loss, gradient trees like ``params``, one per copy)."""
    from repro_torch.tree import tree_map

    leaves = [tree_map(lambda p: p.detach().requires_grad_(True), ps) for ps in params]
    grads = [tree_map(torch.zeros_like, ps) for ps in leaves]
    M = tokens.shape[0]
    loss = 0.0
    for m in range(M):
        lm = staged.full_loss(leaves, tokens[m], labels[m]) / M
        for acc, g in zip(_flat(grads), torch.autograd.grad(lm, _flat(leaves), allow_unused=True)):
            if g is not None:
                acc.add_(g)
        loss += float(lm.detach())
    torch.cuda.synchronize()
    return loss, grads


def _ranks_model_rank(group, plans) -> list:
    """One rank of the ranks-model phase: every plan's engine step; rank 0
    holds the gathered gradients to autograd of full_loss and to the
    one-process engine, on the card."""
    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.pipeline import reduce_replicated, reference_pipeline_grads
    from repro_torch.pipeline.rank_checks import engine_case

    L, S, M, b, T = PIPE_MODEL
    cfg = GPT_CONFIGS["GPT-2.7B"].replace(num_layers=L)  # bf16 compute, fp32 parameters
    data = SyntheticTextDataset(cfg.vocab_size, T, M * b).batch_at(0, "cpu")
    tokens, labels = data.tokens.reshape(M, b, T), data.labels.reshape(M, b, T)
    case = dict(cfg=cfg, M=M, tokens=tokens.numpy(), labels=labels.numpy(), seed=0)
    out, oracles = [], {}
    for kw in plans:
        staged, plan, loss, full, stats = engine_case(group, {**case, "spec": kw})
        res = {"plan": plan.name, "loss": loss, **stats}
        if full is not None:
            V = plan.total_virtual_stages
            params = staged.init_all_stages(torch.Generator(device="cuda").manual_seed(0))
            tok, lab = tokens.to("cuda"), labels.to("cuda")
            if V not in oracles:
                oracles.clear()  # one oracle on the card at a time
                loss_o, grads_o = _oracle(staged, params, tok, lab)
                oracles[V] = (loss_o, _flat(reduce_replicated(grads_o)))
            loss_o, grads_o = oracles[V]
            loss_r, grads_r = reference_pipeline_grads(staged, params, tok, lab, plan)
            grads_r, grads_e = _flat(reduce_replicated(grads_r)), _flat(full)
            finite = math.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads_e)
            res.update(
                finite=finite, loss_oracle=loss_o, loss_rel=abs(loss - loss_o) / abs(loss_o),
                grad_rel=_rel_norm_err(grads_e, grads_o), loss_reference=float(loss_r),
                max_abs_vs_reference=max(float((a - r).abs().max()) for a, r in zip(grads_e, grads_r)),
            )
            del params, grads_r, grads_e, full
            torch.cuda.empty_cache()
        out.append(res)
    return out


def phase_ranks_model() -> None:
    from repro_torch.core import ScheduleSpec, make_plan
    from repro_torch.pipeline import ranks
    from repro_torch.pipeline.engine import stage_body_runs

    L, S, M, b, T = PIPE_MODEL
    per_rank = ranks.spawn(_ranks_model_rank, S, args=(RANKS_MODEL_PLANS,), device="cuda", timeout=900)
    for i, kw in enumerate(RANKS_MODEL_PLANS):
        plan = make_plan(S, M, spec=ScheduleSpec(**kw))
        r0 = per_rank[0][i]
        launches = [r[i]["flash_launches"] for r in per_rank]
        want = stage_body_runs(plan) * L // plan.total_virtual_stages
        log(f"ranks-model GPT-2.7B ({L} layers, bf16) S={S} ranks ({r0['transport']}) M={M} b={b} T={T} plan "
            f"{plan.name}: loss {r0['loss']:.6f} full_loss {r0['loss_oracle']:.6f} (rel {r0['loss_rel']:.3e} <= "
            f"{PIPE_ENGINE_LOSS_TOL:g}), gradients rel_norm_err {r0['grad_rel']:.3e} (<= {PIPE_ENGINE_GRAD_TOL:g}); "
            f"against the one-process engine: loss {r0['loss_reference']:.6f}, gradients max_abs "
            f"{r0['max_abs_vs_reference']:.3e}; K1 launches {launches} (sum {sum(launches)}, grid {want}); "
            f"in flight {[r[i]['max_in_flight'] for r in per_rank]} (caps {r0['caps']}), finite {r0['finite']}")
        if not r0["finite"] or r0["loss_rel"] > PIPE_ENGINE_LOSS_TOL or r0["grad_rel"] > PIPE_ENGINE_GRAD_TOL:
            raise AssertionError(f"the ranks under {plan.name} disagree with autograd of full_loss")
        if sum(launches) != want:
            raise AssertionError(f"K1 ran {sum(launches)} times on the ranks under {plan.name}, the grid has {want}")


def phase_ranks(pipeline_first_loss) -> int:
    from repro_torch.configs.gpt import GPT_CONFIGS
    from repro_torch.core import ScheduleSpec
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import train

    # all 32 layers where each rank has a card of its own; on one card, cut
    layers = None if torch.cuda.device_count() >= RANKS_STAGES else RANKS_ONE_CARD_LAYERS
    cfg = GPT_CONFIGS["GPT-2.7B"]
    cfg = cfg if layers is None else cfg.replace(num_layers=layers)
    first_from = "the pipeline phase's"
    if layers != GPT_LAYERS:  # the one-process engine's first loss at this depth
        r = train.run_pipeline(
            cfg, PIPE_STAGES, ScheduleSpec(kind="kfkb", k=PIPE_K), seed=0, log_every=1, device="cuda",
            engine="reference", **{**PIPE_ARGS, "steps": 1},
        )
        pipeline_first_loss, first_from = r["losses"][0], "the one-process engine's at this depth"
        del r
    gc.collect()
    torch.cuda.empty_cache()  # the card is the ranks'
    log(f"parent holds {torch.cuda.memory_allocated() / 2**20:.1f} MiB on the card while the ranks run")
    ops.launches = 0
    s = train.run_pipeline(
        cfg, RANKS_STAGES, ScheduleSpec(kind="kfkb", k=RANKS_K), seed=0, log_every=1, device="cuda",
        profile=True, engine="ranks", **PIPE_ARGS,
    )
    if ops.launches:
        raise AssertionError("the parent launched K1 during the ranks phase")
    S, M, L, steps = s["stages"], s["microbatches"], s["num_layers"], s["steps"]
    per_step = M * L * (2 * S - 1) // S
    log(f"ranks GPT-2.7B ({L} layers, d_model {s['d_model']}, vocab {s['vocab_size']}, {s['param_count']:,} "
        f"parameters) on {s['ranks']} ranks, transport {s['transport']}, {s['device_count']} card(s) "
        f"(the ranks time-slice one card when there are fewer cards than ranks), plan {s['plan']}: {steps} steps "
        f"of {s['batch']} x {s['seq']} in M={M}; loss {s['losses'][0]:.4f} -> {s['losses'][-1]:.4f}; step p50 "
        f"{s['step_ms_p50']:.1f} ms (first {s['step_ms'][0]:.1f} ms), {s['tokens_per_second']:,.0f} tokens/s")
    log(f"  losses {[round(v, 4) for v in s['losses']]}")
    log(f"  grad norms {[round(v, 4) for v in s['grad_norms']]}")
    log(f"  step ms {[round(v, 1) for v in s['step_ms']]}")
    for r in s["per_rank"]:
        log(f"  rank {r['rank']} (stage {r['stage']}): step p50 {r['step_ms_p50']:.1f} ms = compute "
            f"{r['compute_ms_p50']:.1f} + blocked in receives {r['recv_wait_ms_p50']:.1f} + in sends "
            f"{r['send_wait_ms_p50']:.1f} + staging {r['staging_ms_p50']:.1f} + replicated reduce "
            f"{r['reduce_ms_p50']:.1f} + other (optimizer, host, barrier) {r['other_ms_p50']:.1f} ms (p50 of each); "
            f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB; K1 {r['flash_launches']}; "
            f"in flight {r['max_in_flight']}")
    p = s["profile"]
    log(f"  profiled step (every rank steps twice more; rank 0 times one and traces the next): rank 0 wall "
        f"{p['wall_ms']:.3f} ms, rank 0's kernels {p['device_ms']:.3f} ms ({100 * p['device_busy_share']:.1f}% "
        f"busy), K1 {p['flash_ms']:.3f} ms")
    for op in p["top"]:
        log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
    total_mem = sum(r["max_memory_allocated"] for r in s["per_rank"])
    log(f"  in total: step p50 {s['step_ms_p50']:.1f} ms, peak memory {total_mem / 2**30:.2f} GiB summed over the "
        f"ranks, K1 {s['flash_launches']} launches ({per_step} a step over {steps} steps)")
    log(f"flash launches on the ranks path: {s['flash_launches']} (M*L*(2S-1)/S = {per_step} a step)")
    if s["flash_launches"] != per_step * steps:
        raise AssertionError("the ranks did not run K1 M*L*(2S-1)/S times a step")
    if not all(math.isfinite(v) for v in s["losses"] + s["grad_norms"]):
        raise AssertionError("non-finite loss or gradient norm")
    if not s["losses"][-1] < s["losses"][0]:
        raise AssertionError("the loss did not fall")
    if pipeline_first_loss is None:
        log("  (the pipeline phase did not run: its first loss is not compared)")
    else:
        rel = abs(s["losses"][0] - pipeline_first_loss) / abs(pipeline_first_loss)
        log(f"  first loss {s['losses'][0]:.6f} vs {first_from} {pipeline_first_loss:.6f} "
            f"(rel {rel:.3e} <= {PIPE_ENGINE_LOSS_TOL:g})")
        if rel > PIPE_ENGINE_LOSS_TOL:
            raise AssertionError("the ranks' first loss differs from the one-process engine's")
    return s["flash_launches"]


def _adaptive_ranks_model_lr(step: int) -> float:
    return ADAPTIVE_RANKS_MODEL_LR if step == len(ADAPTIVE_RANKS_MODEL_WALK) - 1 else 0.0


def _digests(trees: list, vstages, kind: str) -> dict:
    """Per leaf of a list of per-virtual-stage trees (``vstages`` their
    global virtual stages): ``((r_1 . t, ..., r_P . t), |t|^2)`` in float64,
    ``P = DIGEST_PROJECTIONS``, each ``r_p`` a Gaussian vector drawn from a
    seed of the leaf's global name, so that two processes holding the same
    virtual stage draw the same vectors.  Over two states, the mean over p
    of sum((r_p . a - r_p . b)^2) / sum(|b|^2) estimates ||a - b||^2 /
    ||b||^2 (E[(r . d)^2] = ||d||^2): the error of a state too large to
    gather (the 8-layer cut's state is 20 GB, some 40 s through gloo)."""
    import zlib

    from repro_torch.tree import flatten

    out = {}
    for j, tree in zip(vstages, trees):
        for path, t in flatten(tree).items():
            key = f"{kind}/{int(j)}/{path}"
            gen = torch.Generator(device=t.device).manual_seed(zlib.crc32(key.encode()))
            t64, projs = t.double(), []
            for _ in range(DIGEST_PROJECTIONS):
                r = torch.randn(t.shape, generator=gen, device=t.device, dtype=torch.float32)
                projs.append(float((t64 * r).sum()))
                del r
            out[key] = (tuple(projs), float(t64.square().sum()))
            del t64
    return out


def _digest_err(got: dict, want: dict, kind: str, base: dict | None = None) -> float:
    """The estimated ||got - want|| / ||want|| over the leaves of one kind
    (params, m, v or grads) of two digest sets; with ``base`` (digests of
    the state before the step), over ||want - base||: the error of the
    step's update."""
    got, want = ({k: d for k, d in x.items() if k.startswith(kind + "/")} for x in (got, want))
    if sorted(got) != sorted(want) or not want:
        raise AssertionError(f"{kind} digest keys differ: {sorted(set(got) ^ set(want))[:5]}")

    def sq(a, b):  # the estimated ||a - b||^2 of one leaf
        return sum((x - y) ** 2 for x, y in zip(a, b)) / DIGEST_PROJECTIONS

    num = sum(sq(got[k][0], want[k][0]) for k in want)
    den = sum(w[1] for w in want.values()) if base is None else sum(sq(want[k][0], base[k][0]) for k in want)
    return math.sqrt(num / den)


def _state_digests(state, grads, vstages) -> dict:
    return {
        **_digests(state.params, vstages, "params"), **_digests(state.opt_state.m, vstages, "m"),
        **_digests(state.opt_state.v, vstages, "v"), **_digests(grads, vstages, "grads"),
    }


def _adaptive_ranks_model_oracle(cfg, plans, batches) -> list:
    """The one-process semantics of the spmd backend on the card: the
    reference engine, the replicated copies' gradients summed
    (reduce_replicated), AdamW at _adaptive_ranks_model_lr clipped at 1,
    restack_train_state at each change of v.  Per iteration: the loss and the digests of the state
    after the step and of the step's gradients; the last also the digests of
    the parameters before its step and of autograd of full_loss (the copies
    summed) at the state before it."""
    from repro_torch.optim import make_optimizer
    from repro_torch.pipeline import StagedModel, reduce_replicated, reference_pipeline_grads
    from repro_torch.runtime import restack_train_state
    from repro_torch.training import create_train_state

    S = plans[0].num_stages
    opt = make_optimizer("adamw", schedule=_adaptive_ranks_model_lr)
    params = StagedModel.build(cfg, S).init_all_stages(torch.Generator(device="cuda").manual_seed(0))
    state, v_now, out = create_train_state(params, opt), 1, []
    for i, (plan, (tokens, labels)) in enumerate(zip(plans, batches)):
        v = plan.num_virtual
        state, v_now = restack_train_state(state, S, v_now, v), v
        staged = StagedModel.build(cfg, S * v)
        rec = {}
        if i == len(plans) - 1:
            rec["before"] = _digests(state.params, range(S * v), "params")
            loss_o, grads_o = _oracle(staged, state.params, tokens, labels)
            rec["autograd"] = _digests(reduce_replicated(grads_o), range(S * v), "grads")
            del grads_o
        loss, grads = reference_pipeline_grads(staged, state.params, tokens, labels, plan)
        reduce_replicated(grads)
        state.params, state.opt_state, _ = opt.update(state.params, grads, state.opt_state)
        rec.update(loss=float(loss), digests=_state_digests(state, grads, range(S * v)))
        del grads
        out.append(rec)
    del state
    torch.cuda.empty_cache()
    return out


def _lr_witness(cfg, plans, batches) -> dict:
    """Two correct one-process runs of the first two plans at a constant
    ADAPTIVE_RANKS_MODEL_LR, alike but for the order of the clip norm's sum:
    over the whole tree at once (clip_by_global_norm), and per stage first,
    then over the stages in stage order (as the ranks add it).  Returns how
    far apart they are: the clip norms of the first step, and the relative
    errors of the parameters after it and of the gradients of the second
    step, all exact (one process holds both)."""
    from repro_torch.optim import constant_schedule, global_norm, make_optimizer
    from repro_torch.pipeline import StagedModel, reduce_replicated, reference_pipeline_grads
    from repro_torch.training import create_train_state
    from repro_torch.tree import flatten, tree_map

    S = plans[0].num_stages
    if any(p.num_virtual != 1 for p in plans):
        raise ValueError("the witness runs plans of one chunk a stage")
    staged = StagedModel.build(cfg, S)
    runs = []
    for by_stage in (False, True):
        opt = make_optimizer("adamw", schedule=constant_schedule(ADAPTIVE_RANKS_MODEL_LR),
                             max_grad_norm=None if by_stage else 1.0)
        params = staged.init_all_stages(torch.Generator(device="cuda").manual_seed(0))
        state, rec = create_train_state(params, opt), {}
        for i, (plan, (tokens, labels)) in enumerate(zip(plans, batches)):
            _, grads = reference_pipeline_grads(staged, state.params, tokens, labels, plan)
            reduce_replicated(grads)
            if i == len(plans) - 1:
                rec["grads"] = grads
                break
            if by_stage:  # each stage's (a rank's) squared norm, summed in stage order; clip_by_global_norm's scale
                norm = torch.sqrt(sum(sum(x.float().square().sum() for x in flatten(g).values()) for g in grads))
                scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
                grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
            else:
                norm = global_norm(grads)
            state.params, state.opt_state, _ = opt.update(state.params, grads, state.opt_state)
            rec.setdefault("norm", float(norm))
            del grads
        rec["params"] = state.params
        del state
        runs.append(rec)

    def rel(a, b):
        pairs = list(zip(_flat(a), _flat(b)))
        return math.sqrt(sum(float((x.double() - y.double()).square().sum()) for x, y in pairs)
                         / sum(float(y.double().square().sum()) for _, y in pairs))

    out = {"norms": (runs[0]["norm"], runs[1]["norm"]), "params_err": rel(runs[1]["params"], runs[0]["params"]),
           "grads_err": rel(runs[1]["grads"], runs[0]["grads"])}
    del runs
    torch.cuda.empty_cache()
    return out


class _ModelRankProbe:
    """adaptive-ranks-model's rank_probe: after each step, this rank's K1
    launches in it and the digests of its state and gradients."""

    def __init__(self) -> None:
        from repro_torch.kernels.flash_attention import ops

        self.ops, self.runtime, self._launches = ops, None, ops.launches

    def __call__(self) -> dict:
        rt = self.runtime
        launches, self._launches = self.ops.launches - self._launches, self.ops.launches
        vstages = rt.placement.vstage_of[rt.group.s]
        return {"flash_launches": launches, "digests": _state_digests(rt.state, rt.last_grads, vstages)}


def _adaptive_ranks_model_rank(group, cfg, walk, batch, M):
    """One rank of adaptive-ranks-model: PlanRuntime(backend="spmd") through
    the walk, one iteration a plan; rank 0 leads and returns per iteration
    the loss, the switch's records and every rank's step record."""
    from repro_torch.core import ScheduleSpec, make_plan
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.optim import make_optimizer
    from repro_torch.runtime import PlanRuntime

    B, T = batch
    opt = make_optimizer(
        "adamw", _adaptive_ranks_model_lr, norm_reduce=lambda t: group.all_reduce_sum(t, "stage")
    )
    probe = _ModelRankProbe()
    rt = PlanRuntime(cfg, group.S, opt, global_batch=B, seq_len=T, backend="spmd", group=group, rank_probe=probe)
    probe.runtime = rt
    ds = SyntheticTextDataset(cfg.vocab_size, T, B, seed=0)

    def batch_at(i):
        b = ds.batch_at(i, group.device)
        return b.tokens, b.labels

    if group.rank:
        rt.follow(batch_at)
        rt.cache.shutdown()
        return None
    out = []
    for i, kw in enumerate(walk):
        ev = rt.switch_to(make_plan(group.S, M, spec=ScheduleSpec(micro_batch_size=B // M, **kw)).lower())
        r = rt.run_iteration(*batch_at(i), batch_index=i)
        out.append({"plan": r.plan_name, "loss": r.loss, "seconds": r.seconds, "restacked": ev.restacked,
                    "switch_seconds": ev.seconds, "switch": ev.ranks, "ranks": r.ranks})
    rt.stop()
    rt.cache.shutdown()
    return out


def phase_adaptive_ranks_model() -> None:
    from repro_torch.core import ScheduleSpec, make_plan
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.launch import train_adaptive
    from repro_torch.pipeline import ranks

    cfg, _, cands, B = train_adaptive.fig10_parts(RANKS_STAGES, gpt="GPT-2.7B", num_layers=ADAPTIVE_RANKS_MODEL_LAYERS)
    S, M, T = RANKS_STAGES, cands[0].plan.num_microbatches, ADAPTIVE_ARGS["seq_len"]
    plans = [make_plan(S, M, spec=ScheduleSpec(micro_batch_size=B // M, **kw)) for kw in ADAPTIVE_RANKS_MODEL_WALK]
    ds = SyntheticTextDataset(cfg.vocab_size, T, B, seed=0)
    batches = [(b.tokens.reshape(M, B // M, T), b.labels.reshape(M, B // M, T))
               for b in (ds.batch_at(i, "cuda") for i in range(len(plans)))]
    t = time.perf_counter()
    w = _lr_witness(cfg, plans[:2], batches[:2])
    log(f"adaptive-ranks-model: two one-process runs at a constant lr {ADAPTIVE_RANKS_MODEL_LR:g}, the clip norm "
        f"summed over the tree / per stage then over the stages: first norms {w['norms'][0]!r} / "
        f"{w['norms'][1]!r}; parameters after the first step rel err {w['params_err']:.3e}, the second step's "
        f"gradients rel err {w['grads_err']:.3e} (not gated; {time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    oracle = _adaptive_ranks_model_oracle(cfg, plans, batches)
    log(f"adaptive-ranks-model: the one-process oracle in {time.perf_counter() - t:.1f} s")
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    got = ranks.spawn(_adaptive_ranks_model_rank, S, args=(cfg, ADAPTIVE_RANKS_MODEL_WALK, (B, T), M),
                      device="cuda", timeout=900)[0]
    for i, (plan, r, o) in enumerate(zip(plans, got, oracle)):
        digests = {k: d for x in r["ranks"] for k, d in x["digests"].items()}
        launches = [x["flash_launches"] for x in r["ranks"]]
        want = train_adaptive.expected_flash_launches(plan, cfg)
        errs = {kind: _digest_err(digests, o["digests"], kind) for kind in ("params", "m", "v", "grads")}
        if "before" in o:
            errs["update"] = _digest_err(digests, o["digests"], "params", base=o["before"])
        loss_rel = abs(r["loss"] - o["loss"]) / abs(o["loss"])
        moved = ", ".join(f"{x['layers_sent']}/{x['layers_received']}" for x in r["switch"])
        log(f"adaptive-ranks-model GPT-2.7B ({cfg.num_layers} layers, d_model {cfg.d_model}) S={S} ranks M={M} "
            f"b={B // M} T={T} iteration {i} {r['plan']} lr {_adaptive_ranks_model_lr(i):g}: loss {r['loss']:.6f} "
            f"vs one process {o['loss']:.6f} (rel {loss_rel:.3e} <= {PIPE_ENGINE_LOSS_TOL:g}); rel err "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (each <= {ADAPTIVE_RANKS_STATE_TOL:g}); "
            f"K1 {launches} (sum {sum(launches)}, grid {want}); switch {1e3 * r['switch_seconds']:.1f} ms, "
            f"restacked {r['restacked']}, layers sent/received a rank {moved}; step {1e3 * r['seconds']:.1f} ms")
        if not math.isfinite(r["loss"]) or loss_rel > PIPE_ENGINE_LOSS_TOL:
            raise AssertionError(f"iteration {i}: the ranks' loss differs from the one-process engine's")
        bad = [k for k, e in errs.items() if not e <= ADAPTIVE_RANKS_STATE_TOL]
        if bad:
            raise AssertionError(f"iteration {i}: the ranks' {', '.join(bad)} differ from the one-process engine's")
        if sum(launches) != want:
            raise AssertionError(f"iteration {i}: K1 ran {sum(launches)} times on the ranks, the grid has {want}")
    grads = {k: d for x in got[-1]["ranks"] for k, d in x["digests"].items()}
    err = _digest_err(grads, oracle[-1]["autograd"], "grads")
    log(f"adaptive-ranks-model: the last step's gradients against autograd of full_loss (copies summed): rel err "
        f"{err:.3e} (<= {PIPE_ENGINE_GRAD_TOL:g})")
    if not err <= PIPE_ENGINE_GRAD_TOL:
        raise AssertionError("the ranks' gradients after the walk disagree with autograd of full_loss")


def _adaptive_ranks_checks(sc) -> dict:
    """adaptive-ranks' check on global rank 0 after the run (the other ranks
    follow): the optimizer state goes first, on every rank, to leave room
    for the oracle; then the final switched state's gradients against
    autograd of full_loss (train_adaptive.grad_parity)."""
    from repro_torch.launch import train_adaptive

    sc.runtime.free_optimizer_state()
    return train_adaptive.grad_parity(sc)


def phase_adaptive_ranks(adaptive_first_loss) -> int:
    from repro_torch.launch import train_adaptive

    layers = None if torch.cuda.device_count() >= RANKS_STAGES else ADAPTIVE_RANKS_ONE_CARD_LAYERS
    first_loss, first_from = adaptive_first_loss, "the adaptive phase"
    if layers != GPT_LAYERS or first_loss is None:  # the one-process loop's first iteration at this depth
        sc = train_adaptive.build_fig10_scenario(device="cuda", num_layers=layers, **ADAPTIVE_ARGS)
        sc.coordinator.run(1)
        first_loss, first_from = sc.runtime.iterations[0].loss, "its first iteration, run here"
        sc.runtime.cache.shutdown()
        del sc
    gc.collect()
    torch.cuda.empty_cache()  # the card is the ranks'
    s = train_adaptive.run_fig10_spmd(
        ADAPTIVE_ITERATIONS, num_stages=RANKS_STAGES, num_layers=layers, device="cuda",
        checks=_adaptive_ranks_checks, **ADAPTIVE_ARGS,
    )
    parity = s["checks"]
    log(f"adaptive-ranks {s['config']} ({s['num_layers']} layers, d_model {s['d_model']}) on {s['ranks']} ranks, "
        f"transport {s['transport']}, {torch.cuda.device_count()} card(s): {s['iterations']} iterations, "
        f"{s['kind_switches']} kind switches, precompile hit rate {s['precompile_hit_rate']:.2f} (cache "
        f"{s['cache']}), warm switch {100 * s['warm_switch_latency_frac']:.3f}% of an iteration (printed, not "
        f"gated)")
    log("  decision trail: " + ", ".join(f"t={d['t']} {d['chosen']}" for d in s["decision_trail"]))
    log(f"  losses {s['losses']}")
    for e in s["switch_events"]:
        log(f"  switch at iteration {e['iteration']}: {e['from_plan'] or '-'} -> {e['to_plan']}, "
            f"{1e3 * e['seconds']:.1f} ms, restacked {e['restacked']}, warm {e['warm']}")
        for r in e["ranks"]:
            log(f"    rank {r['rank']}: {r['seconds']:.3f} s, sent {r['layers_sent']} layers ({r['bytes_sent']:,} B), "
                f"received {r['layers_received']} ({r['bytes_received']:,} B) in {r['rounds']} rounds; staging "
                f"{r.get('staging', 0.0):.3f} s, blocked in receives {r.get('recv_wait', 0.0):.3f} s, in sends "
                f"{r.get('send_wait', 0.0):.3f} s")
    for i, r in enumerate(s["per_iteration"]):
        peaks = ", ".join(f"{p / 2**30:.2f}" for p in r["max_memory_allocated_per_rank"])
        log(f"  iteration {i:2d} {r['plan']:22s} {1e3 * r['seconds']:9.1f} ms, loss {r['loss']:.4f}, K1 "
            f"{r['flash_launches']} (grid: {r['attention_forwards']}), max_memory_allocated a rank {peaks} GiB")
    for name, p in s["per_plan"].items():
        peaks = ", ".join(f"{x / 2**30:.2f}" for x in p["max_memory_allocated_per_rank"])
        reserved = p["max_memory_reserved_per_rank"]
        log(f"  plan {name}: {p['iterations']} iterations, step p50 {p['step_ms_p50']:.1f} ms, max_memory_allocated "
            f"a rank {peaks} GiB (reserved {', '.join(f'{x / 2**30:.2f}' for x in reserved)}; summed "
            f"{sum(reserved) / 2**30:.2f} GiB), K1 a step {p['flash_launches']}")
        for r, items in enumerate(p["per_rank_ms_p50"]):
            log(f"    rank {r}: compute {items['compute']:.1f} + blocked in receives {items['recv_wait']:.1f} + "
                f"in sends {items['send_wait']:.1f} + staging {items['staging']:.1f} + replicated reduce "
                f"{items['reduce']:.1f} + other (optimizer, host) {items['other']:.1f} ms (p50 of each)")
    launches = sum(r["flash_launches"] for r in s["per_iteration"])
    log(f"flash launches on the adaptive-ranks path: {launches}")
    log(f"adaptive-ranks gradients on the final state ({s['per_iteration'][-1]['plan']}) against autograd of "
        f"full_loss (copies summed): rel_norm_err {parity['rel_norm_err']:.3e} (<= {ADAPTIVE_GRAD_TOL:g}), "
        f"max_abs_err {parity['max_abs_err']:.3e}, finite {parity['finite']}")
    want_trail = train_adaptive.engine_free_decision_trail(
        ADAPTIVE_ITERATIONS, num_stages=RANKS_STAGES, seed=ADAPTIVE_ARGS["seed"]
    )
    if s["decision_trail"] != want_trail:
        raise AssertionError(f"the decision trail differs from the engine-free one: {want_trail}")
    restacks = {(e["from_spec"]["num_virtual"], e["to_spec"]["num_virtual"])
                for e in s["switch_events"] if e["restacked"]}
    if s["kind_switches"] < 2 or not {(1, 2), (2, 1)} <= restacks:
        raise AssertionError("fewer than two kind switches, or no restack in one of the directions v 1 <-> 2")
    if s["precompile_hit_rate"] < 0.8 or s["cache"]["cold_misses"]:
        raise AssertionError("precompile hit rate under 0.8, or a cold miss")
    if not all(math.isfinite(v) for v in s["losses"]):
        raise AssertionError("non-finite loss")
    for i, r in enumerate(s["per_iteration"]):
        if r["flash_launches"] != r["attention_forwards"]:
            raise AssertionError(f"iteration {i}: K1 ran {r['flash_launches']} times over the ranks, the grid of "
                                 f"{r['plan']} has {r['attention_forwards']} attention forwards")
    rel = abs(s["losses"][0] - first_loss) / abs(first_loss)
    log(f"  first loss {s['losses'][0]:.6f} vs the one-process adaptive loop's {first_loss:.6f} at "
        f"{s['num_layers']} layers ({first_from}; rel {rel:.3e} <= {PIPE_ENGINE_LOSS_TOL:g})")
    if rel > PIPE_ENGINE_LOSS_TOL:
        raise AssertionError("the ranks' first loss differs from the one-process adaptive loop's")
    if not parity["finite"] or parity["rel_norm_err"] > ADAPTIVE_GRAD_TOL:
        raise AssertionError("the ranks' gradients on the switched state disagree with autograd of full_loss")
    return launches


class _NullTransport:
    """A fabric transport with no coordinator: the oracle's."""

    def request(self, msg):
        return None


def _incumbent_at(history, initial, iteration: int):
    """The fleet's spec at ``iteration``: the last committed epoch's whose
    boundary it has reached, else ``initial``."""
    spec = initial
    for rec in history:
        if rec.committed and rec.boundary <= iteration:
            spec = rec.spec
    return spec


def _fabric_gates(server, workers, summary, initial) -> None:
    """The fabric phase's gates on the fleet (see the module docstring)."""
    hist = server.barrier.history
    committed = [r for r in hist if r.committed]
    for rec in committed:
        for w in workers:
            applied = [o for o in w.applied_outcomes if o.epoch == rec.epoch]
            landed = [e for e in w.runtime.switch_events if e.iteration == rec.boundary and e.to_kind == rec.spec.kind]
            if len(applied) != 1 or not applied[0].committed or applied[0].boundary != rec.boundary or not landed:
                raise AssertionError(f"{w.host}: epoch {rec.epoch} not applied at its boundary {rec.boundary}")
    for host, wins in server.windows.items():
        for win in wins:
            if win.spec != _incumbent_at(hist, initial, win.iteration):
                raise AssertionError(f"{host}: iteration {win.iteration} ran {win.spec}, not the incumbent")
    m = server.fabric_metrics()
    if (m["committed_switches"], m["aborted_switches"]) != (len(FABRIC_TRAIL) - 1, 1):
        raise AssertionError(f"{m['committed_switches']} commits and {m['aborted_switches']} aborts")
    last = hist[-1]
    if last.committed or not last.reason.startswith("refused"):
        raise AssertionError(f"the refused spec's epoch ended {last.committed}, {last.reason!r}")
    for w in workers:
        if w.current_spec != committed[-1].spec or w._pending is not None:
            raise AssertionError(f"{w.host} did not roll back to the incumbent")
        if any(o.committed for o in w.applied_outcomes if o.epoch == last.epoch):
            raise AssertionError(f"{w.host} committed the refused epoch")
        moves = [(e.from_spec.num_virtual, e.to_spec.num_virtual, e.restacked)
                 for e in w.runtime.switch_events if e.from_spec is not None]
        if sorted((a, b) for a, b, r in moves if a != b) != [(1, 2), (2, 1)] or any(r != (a != b) for a, b, r in moves):
            raise AssertionError(f"{w.host}: the v-changing switches did not restack: {moves}")
        for i, r in enumerate(summary["hosts"][w.host]["per_iteration"]):
            if not math.isfinite(r["loss"]):
                raise AssertionError(f"{w.host}: non-finite loss at iteration {i}")
            if r["flash_launches"] != r["attention_forwards"]:
                raise AssertionError(f"{w.host} iteration {i}: K1 ran {r['flash_launches']} times, the grid of "
                                     f"{r['plan']} has {r['attention_forwards']} attention forwards")


def phase_fabric() -> int:
    from repro_torch.core import ScheduleSpec
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import fabric_worker, train_adaptive

    trail = [ScheduleSpec(micro_batch_size=2, **kw) for kw in FABRIC_TRAIL]

    def scripted(server):
        n = len(server.barrier.history)
        return trail[n] if n < len(trail) else None

    server, workers = train_adaptive.build_fabric_fleet(
        num_layers=FABRIC_LAYERS, device="cuda", decision_fn=scripted, **FABRIC_ARGS
    )
    initial = workers[0].current_spec
    ops.launches = 0
    summary = train_adaptive.run_fabric_rounds(server, workers, FABRIC_ROUNDS)
    launches = ops.launches
    cfg, rt0 = workers[0].runtime.cfg, workers[0].runtime
    m = summary["fabric"]
    log(f"fabric {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}): {m['hosts']} hosts in one process, "
        f"S={rt0.num_stages}, global batch {rt0.global_batch} x {rt0.seq_len} a host, {FABRIC_ROUNDS} rounds: "
        f"{m['barrier_epochs']} epochs ({m['committed_switches']} committed, {m['aborted_switches']} aborted), "
        f"{m['telemetry_windows']} telemetry windows")
    for rec in server.barrier.history:
        votes = ", ".join(f"{h} {'ready' if v.ready else 'refused'} {v.precompile_seconds:.4f} s"
                          for h, v in rec.votes.items())
        log(f"  epoch {rec.epoch}: {'COMMIT' if rec.committed else 'ABORT'} {rec.spec.kind} at iteration "
            f"{rec.boundary}, barrier latency {rec.latency:.4f} s; prepare-to-vote {votes}"
            + (f"; {rec.reason}" if rec.reason else ""))
    lat = sorted(r.latency for r in server.barrier.history)
    log(f"  barrier latency p50 {lat[len(lat) // 2]:.4f} s, max {lat[-1]:.4f} s")
    clamped = all(s.duration == s.nbytes / 1e15 for ws in server.windows.values() for w in ws for s in w.samples)
    log(f"  tuner on the hosts' wall times (printed, not gated): every link sample at the bw_hi clamp: {clamped}; "
        f"decisions " + ", ".join(d["chosen"] for d in server.decision_log))
    for w in workers:
        h = summary["hosts"][w.host]
        peaks = [r["max_memory_allocated"] for r in h["per_iteration"]]
        log(f"  {w.host}: losses {[round(r['loss'], 4) for r in h['per_iteration']]}")
        log(f"  {w.host}: state held between steps {h['state_bytes'] / 2**30:.2f} GiB; card's peak during its steps "
            f"{max(peaks) / 2**30:.2f} GiB (both hosts' state resident)")
        for e in w.runtime.switch_events[1:]:
            log(f"  {w.host}: switch at iteration {e.iteration}: {e.from_plan} -> {e.to_plan}, "
                f"{1e3 * e.seconds:.3f} ms, restacked {e.restacked}, warm {e.warm}")
        for name, p in h["per_plan"].items():
            log(f"  {w.host}: plan {name}: {p['iterations']} iterations, step p50 {p['step_ms_p50']:.1f} ms, K1 a "
                f"step {p['flash_launches']} (grid: {p['attention_forwards']})")
    log(f"flash launches on the fabric path: {launches}")
    _fabric_gates(server, workers, summary, initial)
    per_iteration = summary["hosts"]["host0"]["per_iteration"]
    want = sum(r["flash_launches"] for h in summary["hosts"].values() for r in h["per_iteration"])
    if launches != want:
        raise AssertionError(f"K1 ran {launches} times in the fleet's rounds, its iterations account for {want}")
    # the oracle: host0's shard alone in a fresh runtime, switched by hand at
    # the committed boundaries, once the fleet is gone
    switches = {r.boundary: r.spec for r in server.barrier.history if r.committed}
    digest = fabric_worker.param_digest(workers[0].runtime.state.params)
    for w in workers:
        w.runtime.cache.shutdown()
    del server, workers, w, rt0
    gc.collect()
    torch.cuda.empty_cache()
    oracle = fabric_worker.build_worker(
        "oracle", 0, _NullTransport(), num_stages=FABRIC_ARGS["num_stages"], seq_len=FABRIC_ARGS["seq_len"],
        seed=FABRIC_ARGS["seed"], gpt=FABRIC_ARGS["gpt"], num_layers=FABRIC_LAYERS, device="cuda",
    )
    for it in range(FABRIC_ROUNDS):
        if it in switches:
            oracle.runtime.switch_to(oracle.resolve(switches[it]))
        oracle.step()
    oracle.runtime.cache.shutdown()
    diffs = [abs(a["loss"] - b.loss) for a, b in zip(per_iteration, oracle.runtime.iterations)]
    odigest = fabric_worker.param_digest(oracle.runtime.state.params)
    rel = abs(digest["l2"] - odigest["l2"]) / odigest["l2"]
    log(f"  oracle (host0's shard alone, switched by hand): largest loss difference {max(diffs):.3e} (<= "
        f"{FABRIC_LOSS_TOL:g}; bitwise: {max(diffs) == 0.0}), parameter digest l2 {digest['l2']!r} vs "
        f"{odigest['l2']!r} (rel {rel:.3e} <= {FABRIC_DIGEST_TOL:g}), l1 {digest['l1']!r} vs {odigest['l1']!r}")
    if len(diffs) != FABRIC_ROUNDS or max(diffs) > FABRIC_LOSS_TOL or rel > FABRIC_DIGEST_TOL:
        raise AssertionError("host0 of the fleet differs from its shard run alone")
    del oracle
    return launches


def phase_fabric_tcp() -> int:
    from repro_torch.core import ScheduleSpec
    from repro_torch.launch import train_adaptive
    from repro_torch.runtime.fabric import CoordinatorListener, CoordinatorServer, FabricConfig

    _, _, cands, _ = train_adaptive.fig10_parts(FABRIC_ARGS["num_stages"], gpt=FABRIC_ARGS["gpt"],
                                                num_layers=FABRIC_TCP_LAYERS)
    target = ScheduleSpec(kind="interleaved_zb", num_virtual=2, micro_batch_size=2)
    server = CoordinatorServer(
        ("host0", "host1"), initial_spec=cands[0].spec, tuner=None,
        config=FabricConfig(vote_timeout=600.0, boundary_lead=1),
        decision_fn=lambda sv: target if not sv.barrier.history else None,
    )
    listener = CoordinatorListener(server).start()
    out_dir = tempfile.mkdtemp(prefix="fabric_tcp_")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs, outs = [], {}
    t0 = time.perf_counter()
    try:
        for i, host in enumerate(server.hosts):
            outs[host] = os.path.join(out_dir, f"{host}.json")
            cmd = [
                sys.executable, "-m", "repro_torch.launch.fabric_worker", "--connect", f"127.0.0.1:{listener.port}",
                "--host", host, "--host-index", str(i), "--iterations", str(FABRIC_TCP_ITERATIONS),
                "--stages", str(FABRIC_ARGS["num_stages"]), "--gpt", FABRIC_ARGS["gpt"],
                "--layers", str(FABRIC_TCP_LAYERS), "--seq-len", str(FABRIC_ARGS["seq_len"]),
                "--seed", str(FABRIC_ARGS["seed"]), "--device", "cuda", "--out", outs[host],
            ]
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        deadline = time.monotonic() + FABRIC_TCP_TIMEOUT
        for host, p in zip(server.hosts, procs):
            stdout, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise AssertionError(f"fabric worker {host} exited {p.returncode}:\n{stdout[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        listener.stop()
    wall = time.perf_counter() - t0
    left = [p.pid for p in procs if p.poll() is None]
    results = {h: json.load(open(path)) for h, path in outs.items()}
    shutil.rmtree(out_dir, ignore_errors=True)
    m = server.fabric_metrics()
    log(f"fabric-tcp {FABRIC_ARGS['gpt']} ({FABRIC_TCP_LAYERS} layers) in two worker processes over TCP, "
        f"{FABRIC_TCP_ITERATIONS} iterations each, {wall:.1f} s from launch to exit; {m['barrier_epochs']} epochs "
        f"({m['committed_switches']} committed), {m['telemetry_windows']} telemetry windows, barrier latency "
        f"{m['barrier_latency_max']:.4f} s; processes left running: {left}")
    for h, r in results.items():
        launches = [k["flash_launches"] for k in r["kernel_launches"]]
        log(f"  {h}: plans {r['plans']}, losses {[round(x, 4) for x in r['losses']]}, step "
            f"{[round(1e3 * x, 1) for x in r['seconds']]} ms, switches {[round(1e3 * x, 3) for x in r['switch_seconds']]}"
            f" ms, K1 {launches} (grid: {[k['attention_forwards'] for k in r['kernel_launches']]}), "
            f"max_memory_allocated {r['max_memory_allocated'] / 2**30:.2f} GiB, applied {r['applied']}")
    hist = server.barrier.history
    if left:
        raise AssertionError(f"fabric worker processes left running: {left}")
    if len(hist) != 1 or not hist[0].committed or m["committed_switches"] != 1:
        raise AssertionError(f"not one committed switch: {[(r.epoch, r.committed, r.reason) for r in hist]}")
    if m["telemetry_windows"] != 2 * FABRIC_TCP_ITERATIONS:
        raise AssertionError(f"{m['telemetry_windows']} telemetry windows, not {2 * FABRIC_TCP_ITERATIONS}")
    launches = 0
    for h, r in results.items():
        (applied,) = r["applied"]
        if not applied["committed"] or applied["boundary"] != hist[0].boundary:
            raise AssertionError(f"{h} applied {applied}, not the commit at {hist[0].boundary}")
        if r["final_spec"]["kind"] != target.kind or r["iterations"] != FABRIC_TCP_ITERATIONS:
            raise AssertionError(f"{h} ended on {r['final_spec']} after {r['iterations']} iterations")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{h}: non-finite loss")
        for i, k in enumerate(r["kernel_launches"]):
            if k["flash_launches"] != k["attention_forwards"] or k["flash_launches"] == 0:
                raise AssertionError(f"{h} iteration {i}: K1 ran {k['flash_launches']} times, the grid has "
                                     f"{k['attention_forwards']} attention forwards")
            launches += k["flash_launches"]
    log(f"flash launches on the fabric-tcp path: {launches} (summed over the two workers)")
    return launches


def _spmd_group(path: str) -> str:
    """A leaf's group for the digests: a layer's sublayer or a top-level part."""
    parts = path.split("/")
    return "/".join(parts[:3] if parts[0] == "layers" else parts[:2])


def _spmd_digests(tree, specs, mesh) -> dict:
    """``{group: sum of each leaf times a fixed pattern of its global
    indices}`` in float64 over the whole leaves: each rank projects its
    shards (``cos`` of each dim's global index times a per-dim constant,
    multiplied over the dims), a shard replicated over an axis counted on
    that axis's rank 0 only, summed over the world."""
    from repro_torch.distributed.sharding import spec_axes
    from repro_torch.tree import flatten

    out = {}
    for path, t in flatten(tree).items():
        spec = specs[path]
        axes = [spec_axes(spec[d]) if d < len(spec) else () for d in range(t.ndim)]
        named = {a for e in axes for a in e}
        val = torch.zeros((), dtype=torch.float64, device=t.device)
        if all(mesh.coord(a) == 0 for a in mesh.axis_names if a not in named):
            pats = [torch.cos((mesh.index(a) * n + torch.arange(n, device=t.device, dtype=torch.float64))
                              * (0.7071 + 0.13 * d)) for d, (a, n) in enumerate(zip(axes, t.shape))]
            rows = max(1, (1 << 24) // max(1, t[0].numel())) if t.ndim else 1
            for i in range(0, t.shape[0] if t.ndim else 1, rows):
                v = (t[i:i + rows] if t.ndim else t).double()
                for pat in reversed(pats[1:]):
                    v = v @ pat
                val += (v * pats[0][i:i + rows]).sum() if t.ndim else v
        g = _spmd_group(path)
        out[g] = out.get(g, 0.0) + val
    names = sorted(out)
    vec = torch.stack([out[n] for n in names])
    if mesh.size > 1:
        mesh.group.all_reduce_over(vec, mesh.axis_names)
    return dict(zip(names, vec.tolist()))


def _spmd_state_digests(state, specs, mesh) -> dict:
    return {"params": _spmd_digests(state.params, specs, mesh), "m": _spmd_digests(state.opt_state.m, specs, mesh),
            "v": _spmd_digests(state.opt_state.v, specs, mesh)}


def _spmd_rank(group, cfg, plan, batches) -> list:
    """One rank of the spmd phase: each run of ``plan`` (a strategy) builds
    the sharded step, draws its shards, and steps; returns per run the
    losses, norms, step times, each step's span seconds (gathers,
    reduce-scatters, reduces, staging copies, the whole step), K1 launches,
    the peak memory and, on one card, the digests after step 1."""
    from repro_torch.device import synchronize
    from repro_torch.distributed.sharding import local_shape
    from repro_torch.distributed.spmd import make_spmd_train_step
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.profiling import device_profile
    from repro_torch.optim import constant_schedule, make_optimizer
    from repro_torch.tree import flatten

    mesh = make_local_mesh(SPMD_MESH["data"], SPMD_MESH["model"], group)
    dev = group.device
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]
    out = []
    for run in plan["runs"]:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        opt = _spmd_optimizer(plan)
        step, (specs, _) = make_spmd_train_step(cfg, mesh, batches[0], opt, num_microbatches=plan["M"], **run)
        state = step.init_state(seed=0)
        synchronize(dev)
        want = {k: local_shape(t.shape, step.specs[k], mesh) for k, t in flatten(specs.params).items()}
        rec = {"run": run, "rows": step.row_axes, "transport": group.transport, "rank": group.rank,
               "setup_seconds": time.perf_counter() - t0, "losses": [], "grad_norms": [], "step_ms": [], "spans": [],
               "shapes_ok": all(tuple(t.shape) == want[k] for k, t in flatten(state.params).items())}
        if group.rank == 0:
            log(f"  [rank 0] {run}: setup {rec['setup_seconds']:.1f} s, memory_allocated "
                f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
        d0 = _spmd_state_digests(state, step.specs, mesh) if plan["digests"] else None
        group.barrier()
        group.take_seconds()
        n0 = ops.launches
        for i in range(plan["steps"]):
            group.barrier()
            t = time.perf_counter()
            with group.span("step"):
                state, m = step(state, batches[i])
            synchronize(dev)
            rec["step_ms"].append(1e3 * (time.perf_counter() - t))
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            rec["spans"].append(dict(group.take_seconds()))
            if group.rank == 0:  # progress, before the phase's summary
                log(f"  [rank 0] {run} step {i}: {rec['step_ms'][-1]:.1f} ms, loss {rec['losses'][-1]:.6f}, "
                    f"spans {({k: round(v, 3) for k, v in rec['spans'][-1].items()})}, max_memory_allocated "
                    f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            if i == 0 and d0 is not None:
                d1 = _spmd_state_digests(state, step.specs, mesh)
                rec["digests"] = {"update": {g: d1["params"][g] - d0["params"][g] for g in d0["params"]},
                                  "m": d1["m"], "v": d1["v"]}
        if plan["traced"]:  # one more step, traced on rank 0

            def one():
                step(state, batches[0])
                synchronize(dev)

            group.barrier()
            if group.rank == 0:
                t = time.perf_counter()
                prof = device_profile(one, dev, {"flash": "flash_fwd", "nccl": "nccl"})
                rec["profile"] = {"wall_ms": 1e3 * (time.perf_counter() - t), **prof}
            else:
                one()
            group.take_seconds()
        rec["flash_launches"] = ops.launches - n0
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        del state, step
        out.append(rec)
    return out


def _spmd_optimizer(plan):
    """AdamW at SPMD_LR; where digests are compared, at SPMD_DIGEST_EPS."""
    from repro_torch.optim import constant_schedule, make_optimizer

    return make_optimizer("adamw", constant_schedule(SPMD_LR), **({"eps": SPMD_DIGEST_EPS} if plan["digests"] else {}))


def _spmd_reference(cfg, plan, batches, M: int, cast_once: bool) -> dict:
    """The one-process figures the ranks are held to, on this process's card
    before the ranks take it: with a card a rank (four cards), the first
    batch's loss from a forward on api.init_serving_params (no card holds
    the training state); on one card, the plan's steps of the one-process
    make_train_step over ``M`` micro-batches, their losses and clip norms,
    and the digests after step 1; with ``cast_once`` its loss casts the
    leaves of rank >= 2 in repro's layout to cfg.dtype first, as
    gather_params_once does (repro's outer_loss)."""
    from repro_torch.distributed.sharding import PartitionSpec, map_with_path
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import api
    from repro_torch.optim import decay_mask
    from repro_torch.training import create_train_state, make_train_step
    from repro_torch.training.steps import _microbatches
    from repro_torch.tree import flatten

    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()} for b in batches]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if not plan["digests"]:
        params = api.init_serving_params(cfg, 0, "cuda")
        with torch.no_grad():
            loss = sum(float(api.loss_fn(params, cfg, mb)[0]) for mb in _microbatches(batches[0], M)) / M
        peak = torch.cuda.max_memory_allocated()
        del params
        return {"loss": loss, "what": "a one-process forward on init_serving_params", "peak": peak,
                "seconds": time.perf_counter() - t0}
    opt = _spmd_optimizer(plan)
    state = create_train_state(api.init_params(cfg, 0, "cuda"), opt)
    specs = {k: PartitionSpec() for k in flatten(state.params)}
    mesh = make_local_mesh(1, 1)
    d0 = _spmd_digests(state.params, specs, mesh)
    cast = decay_mask(state.params)

    def loss(p, b):
        if cast_once:
            p = map_with_path(lambda k, w: w.to(cfg.dtype) if cast[k] and w.dtype == torch.float32 else w, p)
        return api.loss_fn(p, cfg, b)

    train_step = make_train_step(loss, opt, M)
    out = {"losses": [], "grad_norms": []}
    for i in range(plan["steps"]):
        state, m = train_step(state, batches[i])
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if i == 0:
            d1 = _spmd_state_digests(state, specs, mesh)
            out["digests"] = {"update": {g: d1["params"][g] - d0[g] for g in d0}, "m": d1["m"], "v": d1["v"]}
    out.update(loss=out["losses"][0], peak=torch.cuda.max_memory_allocated(), seconds=time.perf_counter() - t0,
               what=f"the one-process make_train_step at M={M}{', matrices and norms cast once' if cast_once else ''}")
    del state
    return out


def _spmd_ref_key(cfg, plan, run) -> tuple[int, bool]:
    """The reference's (M, cast_once) for ``run``: on one card M times the
    rank groups a micro-batch's rows split into, and gather_params_once's cast."""
    if not plan["digests"]:
        return plan["M"], False
    return plan["M"] * _spmd_row_split(cfg, plan, run), bool(run.get("gather_params_once"))


def _spmd_row_split(cfg, plan, run) -> int:
    """How many ranks' row groups a micro-batch splits into under ``run``."""
    from repro_torch.distributed.spmd import _zero3_dp_axes, act_anchor_for
    from repro_torch.distributed.sharding import spec_axes
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(SPMD_MESH["data"], SPMD_MESH["model"])
    if run["strategy"] == "zero3":
        axes = _zero3_dp_axes(mesh, plan["batch"], plan["M"])
    else:
        anchored = act_anchor_for(cfg, mesh, plan["batch"], plan["M"]).act_sharding
        axes = spec_axes(anchored[0]) if anchored else ()
    return math.prod(mesh.shape[a] for a in axes)


def _spmd_gate_steps(name, got, want, tol, what) -> None:
    """``got``'s loss and clip norm at each step against ``want``'s,
    relative, at ``tol`` (one limit, or one a metric)."""
    for key, metric in (("losses", "loss"), ("grad_norms", "grad_norm")):
        limit = tol[metric] if isinstance(tol, dict) else tol
        rels = [abs(a - b) / abs(b) for a, b in zip(got[key], want[key], strict=True)]
        log(f"  {metric} at each step {[round(v, 6) for v in got[key]]} vs {what} "
            f"{[round(v, 6) for v in want[key]]}: largest rel {max(rels):.3e} <= {limit:g}")
        if max(rels) > limit:
            raise AssertionError(f"spmd {name}: the {metric} differs from {what}'s")


def phase_spmd() -> int:
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticTextDataset
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.common import param_count
    from repro_torch.pipeline import ranks

    ranks_n = math.prod(SPMD_MESH.values())
    four = torch.cuda.device_count() >= ranks_n
    plan = {**(SPMD_FOUR if four else SPMD_ONE), "digests": not four}
    cfg = get_arch(SPMD_ARCH).model
    if plan["layers"]:
        cfg = cfg.replace(num_layers=plan["layers"])
    data = SyntheticTextDataset(cfg.vocab_size, plan["seq"], plan["batch"], seed=0)
    batches = [{"tokens": b.tokens.numpy(), "labels": b.labels.numpy()}
               for b in (data.batch_at(i, "cpu") for i in range(plan["steps"]))]
    refs = {}
    for run in plan["runs"]:
        key = _spmd_ref_key(cfg, plan, run)
        if key in refs:
            continue
        refs[key] = ref = _spmd_reference(cfg, plan, batches, *key)
        gc.collect()
        torch.cuda.empty_cache()  # the card is the ranks'
        log(f"spmd reference for {run}: {ref['what']}, loss {ref['loss']:.6f}, peak {ref['peak'] / 2**30:.2f} "
            f"GiB, {ref['seconds']:.1f} s")
    log(f"spmd {SPMD_ARCH} at full width, {cfg.num_layers} layers ({param_count(cfg):,} parameters), b "
        f"{plan['batch']} x T {plan['seq']} in M={plan['M']}, {plan['steps']} steps a run, {ranks_n} ranks on a "
        f"{SPMD_MESH} mesh, "
        f"{torch.cuda.device_count()} card(s); the parent holds {torch.cuda.memory_allocated() / 2**20:.1f} MiB "
        f"while the ranks run")
    ops.launches = 0
    # the ranks' allocators grow segments in place: on one card four ranks
    # share it, and fixed segments strand GiBs between their steps
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        per_rank = ranks.spawn(_spmd_rank, ranks_n, args=(cfg, plan, batches), device="cuda", timeout=900,
                               axes=SPMD_MESH)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    if ops.launches:
        raise AssertionError("the parent launched K1 during the spmd phase")
    tokens = plan["batch"] * plan["seq"]
    launches = 0
    for j, run in enumerate(plan["runs"]):
        recs = [r[j] for r in per_rank]
        r0 = recs[0]
        ref = refs[_spmd_ref_key(cfg, plan, run)]
        name = ", ".join(f"{k}={v}" for k, v in run.items())
        steps = plan["steps"] + int(plan["traced"])
        want_k1 = cfg.num_layers * plan["M"] * steps * 2  # every forward again in the remat
        p50 = [sorted(r["step_ms"])[len(r["step_ms"]) // 2] for r in recs]
        log(f"spmd {name}: rows over {r0['rows']}, transport {r0['transport']}, losses {r0['losses']}, grad norms "
            f"{[round(v, 4) for v in r0['grad_norms']]}; step p50 {max(p50):.1f} ms (slowest rank), "
            f"{tokens / (max(p50) / 1e3):,.0f} tokens/s over the world")
        for r, ms in zip(recs, p50):
            mid = r["spans"][len(r["spans"]) // 2] if len(r["spans"]) > 1 else r["spans"][0]
            comm = sum(mid.get(k, 0.0) for k in ("gather", "reduce_scatter", "reduce", "staging"))
            log(f"  rank {r['rank']}: setup {r['setup_seconds']:.1f} s, step ms {[round(v, 1) for v in r['step_ms']]} "
                f"(p50 {ms:.1f}); a step (the median one) {1e3 * mid.get('step', 0.0):.1f} ms = gathers "
                f"{1e3 * mid.get('gather', 0.0):.1f} + reduce-scatters {1e3 * mid.get('reduce_scatter', 0.0):.1f} + "
                f"all-reduces {1e3 * mid.get('reduce', 0.0):.1f} + staging {1e3 * mid.get('staging', 0.0):.1f} + "
                f"compute and the rest {1e3 * (mid.get('step', 0.0) - comm):.1f}; max_memory_allocated "
                f"{r['max_memory_allocated'] / 2**30:.2f} GiB; K1 {r['flash_launches']} (want {want_k1}); shards "
                f"{'as the rules say' if r['shapes_ok'] else 'WRONG'}")
        if "profile" in r0:
            p = r0["profile"]
            log(f"  traced step on rank 0: wall {p['wall_ms']:.1f} ms, kernels {p['device_ms']:.1f} ms, K1 "
                f"{p['flash_ms']:.1f} ms, NCCL {p['nccl_ms']:.1f} ms")
            for op in p["top"]:
                log(f"    {op['ms']:10.3f} ms  x{op['count']:<5d} {op['name'][:90]}")
        if not all(r["shapes_ok"] for r in recs):
            raise AssertionError(f"spmd {name}: a rank's shards are not the rules' shapes")
        if len({tuple(r["losses"]) for r in recs}) != 1:
            raise AssertionError(f"spmd {name}: the ranks report different losses")
        if not all(math.isfinite(v) for v in r0["losses"] + r0["grad_norms"]):
            raise AssertionError(f"spmd {name}: non-finite loss or gradient norm")
        if any(r["flash_launches"] != want_k1 for r in recs):
            raise AssertionError(f"spmd {name}: K1 launches {[r['flash_launches'] for r in recs]}, want {want_k1}")
        if four and max(r["max_memory_allocated"] for r in recs) >= 80 * 2**30:
            raise AssertionError(f"spmd {name}: a rank's peak reached 80 GiB")
        if plan["digests"]:
            _spmd_gate_steps(name, r0, ref, SPMD_LOSS_TOL, ref["what"])
            for kind, tol in SPMD_DIGEST_TOL.items():
                errs = {g: abs(r0["digests"][kind][g] - w) / max(abs(w), 1e-30)
                        for g, w in ref["digests"][kind].items()}
                worst = max(errs, key=errs.get)
                log(f"  step-1 digests of {kind} over {len(errs)} leaf groups: largest rel err {errs[worst]:.3e} "
                    f"({worst}) <= {tol:g}")
                if errs[worst] > tol:
                    raise AssertionError(f"spmd {name}: the step-1 {kind} of {worst} differs from the one-process step's")
        else:
            rel = abs(r0["losses"][0] - ref["loss"]) / abs(ref["loss"])
            log(f"  first loss {r0['losses'][0]:.6f} vs {ref['what']} {ref['loss']:.6f} (rel {rel:.3e} <= "
                f"{SPMD_LOSS_TOL:g})")
            if rel > SPMD_LOSS_TOL:
                raise AssertionError(f"spmd {name}: the first loss differs from {ref['what']}'s")
            if j:  # the strategies against each other, step by step
                first = per_rank[0][0]
                what = ", ".join(f"{k}={v}" for k, v in first["run"].items())
                _spmd_gate_steps(name, r0, first, SPMD_CROSS_TOL, what)
        launches += sum(r["flash_launches"] for r in recs)
    log(f"flash launches on the spmd path: {launches}")
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
    kernels, pipeline_first_loss, adaptive_first_loss = {}, None, None
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
        elif name == "model-dense":
            launches = phase_model_dense()
            if kernels:
                kernels["flash"]["per_path"]["model-dense"]["launches"] = launches
        elif name == "train-model":
            phase_train_model()
        elif name == "serve":
            launches = phase_serve()
            if kernels:
                kernels["flash"]["per_path"]["serve"]["launches"] = launches
        elif name == "serve-adaptive":
            launches = phase_serve_adaptive()
            if kernels:
                kernels["flash"]["per_path"]["serve-adaptive"]["launches"] = launches
        elif name == "serve-ssm":
            phase_serve_ssm()
        elif name == "serve-dense":
            launches = phase_serve_dense()
            if kernels:
                kernels["flash"]["per_path"]["serve-dense"]["launches"] = launches
        elif name == "train":
            launches = phase_train()
            if kernels:
                kernels["ssd"]["per_path"]["train"]["launches"] = launches
        elif name == "train-dense":
            launches = phase_train_dense()
            if kernels:
                kernels["flash"]["per_path"]["train-dense"]["launches"] = launches
        elif name == "model-moe":
            launches = phase_model_moe()
            if kernels:
                kernels["flash"]["per_path"]["model-moe"]["launches"] = launches
        elif name == "serve-moe":
            launches = phase_serve_moe()
            if kernels:
                kernels["flash"]["per_path"]["serve-moe"]["launches"] = launches
        elif name == "train-moe":
            launches = phase_train_moe()
            if kernels:
                kernels["flash"]["per_path"]["train-moe"]["launches"] = launches["flash"]
                kernels["ssd"]["per_path"]["train-moe"]["launches"] = launches["ssd"]
        elif name == "model-encdec-vlm":
            launches = phase_model_encdec_vlm()
            if kernels:
                kernels["flash"]["per_path"]["model-encdec-vlm"]["launches"] = launches
        elif name == "train-encdec-vlm":
            launches = phase_train_encdec_vlm()
            if kernels:
                kernels["flash"]["per_path"]["train-encdec-vlm"]["launches"] = launches
        elif name == "pipeline-model":
            phase_pipeline_model()
        elif name == "pipeline":
            launches, pipeline_first_loss = phase_pipeline()
            if kernels:
                kernels["flash"]["per_path"]["pipeline"]["launches"] = launches
        elif name == "calibrate":
            launches = phase_calibrate()
            if kernels:
                kernels["flash"]["per_path"]["calibrate"]["launches"] = launches
        elif name == "adaptive":
            launches, adaptive_first_loss = phase_adaptive()
            if kernels:
                kernels["flash"]["per_path"]["adaptive"]["launches"] = launches
        elif name == "ranks-model":
            phase_ranks_model()
        elif name == "ranks":
            launches = phase_ranks(pipeline_first_loss)
            if kernels:
                kernels["flash"]["per_path"]["ranks"]["launches"] = launches
        elif name == "adaptive-ranks-model":
            phase_adaptive_ranks_model()
        elif name == "adaptive-ranks":
            launches = phase_adaptive_ranks(adaptive_first_loss)
            if kernels:
                kernels["flash"]["per_path"]["adaptive-ranks"]["launches"] = launches
        elif name == "fabric":
            launches = phase_fabric()
            if kernels:
                kernels["flash"]["per_path"]["fabric"]["launches"] = launches
        elif name == "fabric-tcp":
            launches = phase_fabric_tcp()
            if kernels:
                kernels["flash"]["per_path"]["fabric-tcp"]["launches"] = launches
        elif name == "spmd":
            launches = phase_spmd()
            if kernels:
                kernels["flash"]["per_path"]["spmd"]["launches"] = launches
        log(f"== phase {name} done in {time.perf_counter() - t:.1f} s")
        # what a phase built may hold itself alive (a training runtime and its
        # step cache's factory hold each other): free it before the next
        gc.collect()
        torch.cuda.empty_cache()
    log(f"all phases {time.perf_counter() - t0:.1f} s")
    if set(only) != set(PHASES):
        return 0  # a partial run prints no result
    for k in ("flash", "ssd"):
        kernels[k]["launches"] = sum(p["launches"] for p in kernels[k]["per_path"].values())
    log(json.dumps({"kernels": [kernels["flash"], kernels["ssd"]]}))
    log(device["smi"])
    log(json.dumps({"ok": True, "device": {k: device[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
