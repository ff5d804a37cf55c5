"""Calibrated per-stage costs from the engines' own task bodies.

Port of ``repro/core/calibrate.py``.  Everything upstream prices schedules
with ``StageCosts.uniform``; real stages are not uniform: stage 0 carries
the embedding, the last stage the vocabulary projection inside its loss
head.  Per stage ``s`` this module takes four programs, each a task body of
``pipeline/engine.py`` (the bodies both engines run):

* **fwd** -- ``_fwd_task`` (``stage_hidden`` under ``torch.no_grad()``);
  stage 0 runs ``embed_tokens`` first.  The engines run the last stage's
  forward inside its backward; its ``fwd`` prices the body alone, as
  ``repro``'s does.
* **bwd_input** -- ``_bwd_task(split=True)``: the body recomputed under
  autograd and differentiated with respect to the stage input (the last
  stage through its loss head, where the vocabulary projection's backward
  lands).  On stage 0 the body also takes the embedding's gradient through
  that input, which ``repro``'s program leaves out: the two count the same
  FLOPs (a gather and its scatter-add are no products), the port more bytes.
* **bwd_weight** -- ``_bwd_weight_task`` under ``double_remat``: a second
  recompute, differentiated with respect to the stage's parameters.
* **bwd_weight_saved** -- ``_bwd_weight_task(saved_residual=True)`` over
  the autograd graph ``bwd_input`` retained: B runs first, neither counted
  nor timed, and W alone is.  The port keeps B's graph where ``repro``
  replays a saved residual row, so nothing like its
  ``probe_residual_layout``/``rebuild_vjp`` is needed.

Each backward body adds its gradients into fp32 sums, as in the engines;
those adds are counted and timed (the engines run them), and the sums are
not reset between timed repeats.  The loss seed is ``1 / M`` at ``M = 1``.

**Counts** (:func:`count_stage`) run on the ``meta`` device: nothing is
allocated or launched, so a full-size config costs nothing to count.
FLOPs are the function's: counted through the plain attention, they follow
``repro``'s HLO rule (matrix products only; ``launch/op_counts.py``) and
equal its counts.  Bytes are the program's that the engines run
(:func:`count_programs` through the stage's own attention): K1's custom
operator moves q, k, v and out, and a backward recomputes the plain
attention (its fp32 scores) and differentiates it.  They are eager
PyTorch's kernel-boundary traffic, larger than XLA's fused count.  So a
backward's recomputed attention products are in its bytes, not its FLOPs.

**Methods**:

* ``"spec"`` (the default) prices the counts on a
  :class:`~repro_torch.core.devicespec.DeviceSpec` (``device_spec``: a path
  or a spec; ``specs/h100-sxm.json`` when not given) at the compute dtype's
  peak, failing closed when the spec has no entry for it.
* ``"wallclock"`` times each program on ``device`` with the stage's
  parameters and inputs drawn from :data:`SEED` there: warmup 1, repeats 3, the
  mean of the repeats, as ``core/profiler.py::time_callable``; CUDA events
  on the compute stream, synchronised before each run and before reading
  (the host clock only when ``device="cpu"`` was asked for).  One stage is
  held at a time.

``repro``'s ``"hlo"`` method prices on one TPU's constants; here it raises.
A roofline on other constants is a :class:`DeviceSpec` passed as
``device_spec``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from repro_torch.core.devicespec import (
    TASK_PROGRAMS,
    DeviceSpec,
    ProgramCounts,
    dtype_key,
    load_device_spec,
    spec_root,
)
from repro_torch.core.memory_model import MemoryModel, StageMemorySpec
from repro_torch.core.taskgraph import StageCosts
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch.op_counts import count_ops, tensor_bytes
from repro_torch.pipeline.engine import _bwd_task, _bwd_weight_task, _fwd_task, _grad_leaves
from repro_torch.pipeline.stage import StagedModel
from repro_torch.tree import flatten

__all__ = [
    "StageTaskProfile",
    "Calibration",
    "calibrate_stage_costs",
    "count_programs",
    "count_stage",
    "resolve_spec",
    "METHODS",
    "WARMUP",
    "REPEATS",
]

METHODS = ("spec", "wallclock")
#: the spec ``method="spec"`` prices on when none is given: the port's card
DEFAULT_SPEC = "h100-sxm.json"
#: timed runs of each program under ``method="wallclock"``
WARMUP, REPEATS = 1, 3
#: the seed of the parameters and inputs a program runs on (wall clock, and
#: counts off the meta device)
SEED = 0


@dataclasses.dataclass
class StageTaskProfile:
    """Roofline terms of one task kind at one stage (per micro-batch)."""

    flops: float
    hbm_bytes: float
    seconds: float
    #: the timed runs, in seconds (``"wallclock"``; empty when priced)
    repeat_seconds: tuple[float, ...] = ()


@dataclasses.dataclass
class Calibration:
    """Calibrated heterogeneous pipeline profile."""

    costs: StageCosts
    memory: MemoryModel
    # per stage: fwd / bwd_input / bwd_weight / bwd_weight_saved
    profiles: list[dict[str, StageTaskProfile]]
    micro_batch_size: int | None = None
    dtype: str | None = None  # spec dtype key of the compute dtype
    #: the spec's name (``"spec"``), the card's name (``"wallclock"``; "cpu"
    #: on the CPU)
    device: str | None = None
    limits: list[float] | None = None  # per-stage memory-limit curve (bytes), "spec" only
    method: str | None = None

    def summary_rows(self) -> list[list[str]]:
        """Per-stage table rows: times in ms (3 sig figs), wire bytes in MB."""
        rows = []
        for s, prof in enumerate(self.profiles):
            rows.append(
                [
                    str(s),
                    f"{prof['fwd'].seconds * 1e3:.3g}",
                    f"{prof['bwd_input'].seconds * 1e3:.3g}",
                    f"{prof['bwd_weight'].seconds * 1e3:.3g}",
                    f"{prof['bwd_weight_saved'].seconds * 1e3:.3g}",
                    f"{self.costs.fwd_bytes[s] / 1e6:.3g}",
                ]
            )
        return rows


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: ``StagedModel.init_stages``
    draws on its generator's device, so with this one it allocates nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def _generator(device: torch.device) -> torch.Generator:
    if device.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=device).manual_seed(SEED)


def _stage_inputs(cfg, b: int, T: int, gen: torch.Generator):
    """The stage input, its output gradient, the tokens and the labels of one
    micro-batch (random draws from ``gen``, on its device)."""
    dev = gen.device
    x, dy = (torch.randn((b, T, cfg.d_model), generator=gen, device=dev).to(cfg.dtype) for _ in range(2))
    tokens, labels = (torch.randint(0, cfg.vocab_size, (b, T), generator=gen, device=dev) for _ in range(2))
    return x, dy, tokens, labels


def _stage_programs(staged: StagedModel, s: int, params, b: int, T: int, gen: torch.Generator) -> dict:
    """The four task programs of stage ``s`` over its parameter tree
    ``params``: ``{name: (setup, run)}``, where ``setup()`` (``None`` when
    there is nothing to set up) is neither counted nor timed and returns
    what ``run`` takes."""
    first, last = s == 0, s == staged.num_stages - 1
    (p,), (leaves,), (sums,) = _grad_leaves([params])
    x, dy, tokens, labels = _stage_inputs(staged.cfg, b, T, gen)
    dy_in = None if last else dy
    # what B leaves W under double_remat: the output gradient, or the loss seed
    w_ctx = torch.full((), 1.0, dtype=torch.float32, device=x.device) if last else dy

    def fwd(_):
        with torch.no_grad():
            h = staged.embed_tokens(p, tokens) if first else x
        return _fwd_task(staged, p, h)

    def bwd_input(saved: bool):
        return _bwd_task(staged, p, leaves, sums, x, dy_in, tokens, labels,
                         first=first, last=last, M=1, split=True, saved_residual=saved)

    def bwd_weight(ctx, saved: bool):
        _bwd_weight_task(staged, p, leaves, sums, x, ctx, labels, last=last, saved_residual=saved)

    return {
        "fwd": (None, fwd),
        "bwd_input": (None, lambda _: bwd_input(False)),
        "bwd_weight": (None, lambda _: bwd_weight(w_ctx, False)),
        "bwd_weight_saved": (lambda: bwd_input(True)[2], lambda ctx: bwd_weight(ctx, True)),
    }


def _stage_params(staged: StagedModel, s: int, gen: torch.Generator):
    return staged.init_stages(gen, [s])[0]


def count_programs(staged: StagedModel, s: int, b: int, T: int, device="meta") -> dict[str, ProgramCounts]:
    """FLOPs and HBM bytes of stage ``s``'s four programs as they run
    through ``staged``'s attention, each once under the counters
    (``launch/op_counts.py``) on ``device``: ``meta`` (the default) runs
    nothing; elsewhere the parameters and inputs are drawn from
    :data:`SEED` and the programs run for real."""
    gen = _generator(torch.device(device))
    params = _stage_params(staged, s, gen)
    counts = {}
    for name, (setup, run) in _stage_programs(staged, s, params, b, T, gen).items():
        arg = setup() if setup else None
        counts[name] = count_ops(lambda: run(arg))
    return counts


def count_stage(staged: StagedModel, s: int, b: int, T: int) -> dict[str, ProgramCounts]:
    """Stage ``s``'s four programs counted on ``meta``: the FLOPs through
    the plain attention (the function), the bytes through ``staged``'s own
    (what the engines run)."""
    plain = count_programs(dataclasses.replace(staged, plain_attention=True), s, b, T)
    run = plain if staged.plain_attention else count_programs(staged, s, b, T)
    return {p: ProgramCounts(flops=plain[p].flops, hbm_bytes=run[p].hbm_bytes) for p in TASK_PROGRAMS}


def _time_program(setup, run, device: torch.device) -> list[float]:
    """Seconds of each of REPEATS runs of ``run`` after WARMUP: CUDA events
    on the compute stream on a card, the host clock on the CPU."""
    runs = []
    for i in range(WARMUP + REPEATS):
        arg = setup() if setup else None
        synchronize(device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(arg)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run(arg)
            seconds = time.perf_counter() - t0
        if i >= WARMUP:
            runs.append(seconds)
    return runs


def _time_stage(staged: StagedModel, s: int, b: int, T: int, device: torch.device) -> dict[str, list[float]]:
    gen = _generator(device)
    programs = _stage_programs(staged, s, _stage_params(staged, s, gen), b, T, gen)
    return {name: _time_program(setup, run, device) for name, (setup, run) in programs.items()}


def _tree_bytes(tree) -> float:
    return float(sum(tensor_bytes(t) for t in flatten(tree).values()))


def resolve_spec(device_spec: DeviceSpec | str | None = None) -> DeviceSpec:
    """``device_spec`` as a loaded spec: a spec, a path to a spec file, or
    ``None`` for the port's card (``specs/h100-sxm.json``)."""
    if isinstance(device_spec, DeviceSpec):
        return device_spec
    return load_device_spec(device_spec or os.path.join(spec_root(), DEFAULT_SPEC))


def calibrate_stage_costs(
    staged: StagedModel,
    micro_batch_size: int,
    seq_len: int,
    *,
    method: str = "spec",
    device_spec: DeviceSpec | str | None = None,
    optimizer_bytes_per_param_byte: float = 2.0,
    device=None,
) -> Calibration:
    """Profile every stage's task bodies into a heterogeneous profile.

    Returns the calibrated :class:`StageCosts`, a per-stage
    :class:`MemoryModel` and the per-task profiles (see the module
    docstring for the programs and the methods).  ``device`` is the card
    unless ``"cpu"`` is asked for; ``"wallclock"`` times there and raises
    without a card rather than fall back to the CPU.
    """
    if method == "hlo":
        raise ValueError(
            'method="hlo" has no counterpart here: its constants are one TPU\'s; '
            'use method="spec" with device_spec= (a spec file or a DeviceSpec)'
        )
    if method not in METHODS:
        raise ValueError(f"unknown calibration method {method!r} (known: {METHODS})")
    dev = resolve_device(device)
    cfg = staged.cfg
    try:
        compute_dtype = dtype_key(cfg.dtype)
    except ValueError:
        if method == "spec":
            raise
        compute_dtype = None  # exotic dtype: fine unless spec pricing needs it
    spec = None
    if method == "spec":
        spec = resolve_spec(device_spec)
        spec.peak_flops_for(compute_dtype)  # fail closed up front, not per program

        def price(c: ProgramCounts) -> float:
            return spec.task_seconds(c.flops, c.hbm_bytes, compute_dtype)

    S = staged.num_stages
    b, T, d = micro_batch_size, seq_len, cfg.d_model
    itemsize = torch.empty((), dtype=cfg.dtype, device="meta").element_size()
    act_bytes = float(b * T * d * itemsize)

    profiles: list[dict[str, StageTaskProfile]] = []
    specs: list[StageMemorySpec] = []
    for s in range(S):
        counts = count_stage(staged, s, b, T)
        if method == "wallclock":
            runs = _time_stage(staged, s, b, T, dev)
            prof = {p: StageTaskProfile(c.flops, c.hbm_bytes, sum(runs[p]) / REPEATS, tuple(runs[p]))
                    for p, c in counts.items()}
        else:
            prof = {p: StageTaskProfile(c.flops, c.hbm_bytes, price(c)) for p, c in counts.items()}
        profiles.append(prof)
        param_bytes = _tree_bytes(_stage_params(staged, s, _MetaGenerator()))
        specs.append(
            StageMemorySpec(
                param_bytes=param_bytes,
                optimizer_bytes=optimizer_bytes_per_param_byte * param_bytes,
                grad_bytes=param_bytes,
                stage_input_bytes_per_token=float(d * itemsize),
                layer_act_bytes_per_token=float((2 * d + getattr(cfg, "d_ff", d)) * itemsize),
                num_layers=staged.layers_per_stage,
            )
        )

    t = {p: [prof[p].seconds for prof in profiles] for p in TASK_PROGRAMS}
    costs = StageCosts(
        fwd_time=t["fwd"],
        bwd_time=[bi + bw for bi, bw in zip(t["bwd_input"], t["bwd_weight"])],
        fwd_bytes=[act_bytes] * S,
        bwd_bytes=[act_bytes] * S,
        bwd_input_time=t["bwd_input"],
        bwd_weight_time=t["bwd_weight"],
        bwd_weight_saved_time=t["bwd_weight_saved"],
    )
    if spec is not None:
        device_name = spec.name
    else:
        device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return Calibration(
        costs=costs,
        memory=MemoryModel(stages=specs, seq_len=seq_len),
        profiles=profiles,
        micro_batch_size=micro_batch_size,
        dtype=compute_dtype,
        device=device_name,
        limits=spec.limit_curve(S) if spec is not None else None,
        method=method,
    )
