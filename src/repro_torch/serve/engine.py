"""ServeEngine: fused prefill and grouped decode behind the serve tick loop.

Port of ``repro/serve/engine.py``.  The simulated
:class:`~repro_torch.serve.runtime.ServeRuntime` prices every tick against
the trace network; this engine makes the *tokens* real.  It owns the model
parameters and a slot-major decode state: a decode cache whose batch rows
are the ``max_slots`` decode slots (KV rows for attention layers, the
recurrent state and conv window for Mamba2 layers), plus per-slot positions
and last tokens.  It runs two kinds of programs:

* **grouped decode tick** -- one program per dispatched
  :class:`~repro_torch.core.schedule.TabularPlan`, built by the
  ``program_factory`` hook of a *stateless*
  :class:`~repro_torch.runtime.executor.PlanRuntime` (``optimizer=None``),
  so the tuner's live ``switch_to`` goes through the same
  ``CompiledStepCache`` warm-switch path training uses.  The program lays
  the slots out as the plan's ``[M, b]`` micro-batch grid and runs the M
  groups one after the other, each one batch-``b`` decode with per-row
  positions (the reference's ``lax.map`` over groups of a ``vmap``'d
  single-slot decode).  Empty slots compute padding, as a fixed-shape batch
  does in the reference.
* **fused prefill** -- :func:`repro_torch.models.api.prefill_with_cache` on
  one admitted request (batch 1), written straight into the request's slot
  row.  Prefill is plan-independent: it runs before the request joins the
  grouped grid.  Its attention is the flash kernel on the card.

Decoding is greedy (temperature 0), so serving runs are reproducible token
for token; emitted tokens accumulate in ``outputs[rid]``.  Matrices and the
embedding table are held in ``cfg.dtype`` (cast once at load), norm scales
and biases in ``cfg.param_dtype``.  The cache is updated in place.

The engine is not part of a reference cycle (``repro``'s is: its runtime's
factory is the engine's bound method), so dropping the last reference frees
its weights and cache at once, without a garbage collection: the runtime
holds the factory through a weak reference to the engine, and the decode
programs close over the non-finite flag, not the engine.
"""

from __future__ import annotations

import time
from typing import Callable
import weakref

import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.runtime.executor import PlanRuntime
from repro_torch.tree import tree_map

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        num_stages: int,
        max_slots: int,
        max_len: int,
        params=None,
        seed: int = 0,
        device=None,
        obs=None,
        track: str = "serve",
        prompt_fn: Callable[[int, int], torch.Tensor] | None = None,
    ) -> None:
        """``params``: a parameter tree on ``device`` (e.g. from the weight
        bridge); without one, weights are drawn from ``seed``.
        ``prompt_fn(rid, prompt_len)`` gives request ``rid``'s prompt tokens;
        by default :meth:`default_prompt`."""
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        if params is None:
            params = api.init_params(cfg, seed=seed, device=self.device)
        self.params = api.cast_for_serving(params, cfg)
        self.cache = api.init_cache(cfg, max_slots, max_len, device=self.device)
        self.positions = torch.zeros((max_slots,), dtype=torch.long, device=self.device)
        self.tokens = torch.zeros((max_slots, 1), dtype=torch.long, device=self.device)
        self.outputs: dict[int, list[int]] = {}
        self.prompt_fn = prompt_fn  # None: default_prompt (a bound method here would be a cycle)
        self.prefill_seconds: list[float] = []  # wall time of each prefill call
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)
        # stateless runtime: no TrainState, programs come from our factory,
        # but the cache and warm-switch machinery is the training one
        self.runtime = PlanRuntime(
            cfg,
            num_stages,
            optimizer=None,
            global_batch=max_slots,
            seq_len=max_len,
            program_factory=_weak_factory(self),
            obs=obs,
            obs_track=track,
            device=self.device,
        )

    # -- program factory (one program per dispatched plan) --------------------

    def _program_for(self, table):
        plan = table.plan
        M = plan.num_microbatches
        if self.max_slots % M:
            raise ValueError(f"plan {plan.name} needs M={M} | max_slots={self.max_slots}")
        b = self.max_slots // M
        cfg, nonfinite = self.cfg, self._nonfinite

        def step(params, cache, positions, tokens):
            new_tok = torch.empty_like(tokens)
            for g in range(M):
                rows = slice(g * b, (g + 1) * b)
                logits, _ = api.decode_fn(
                    params, cfg, ServeEngine._rows(cache, rows), positions[rows], {"tokens": tokens[rows]}
                )
                new_tok[rows, 0] = _greedy(logits, nonfinite)
            return new_tok

        return step

    # -- state --------------------------------------------------------------

    @property
    def nonfinite(self) -> bool:
        """Whether any prefill or decode produced a non-finite logit."""
        return bool(self._nonfinite)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _rows(cache, rows: slice):
        """Views of the slot rows ``rows`` of every cache leaf."""
        return tree_map(lambda x: x[rows], cache)


    def default_prompt(self, rid: int, prompt_len: int) -> torch.Tensor:
        """The seeded prompt of request ``rid``: [1, prompt_len] tokens."""
        gen = torch.Generator(device=self.device).manual_seed(rid)
        return torch.randint(
            0, self.cfg.vocab_size, (1, prompt_len), generator=gen, device=self.device
        )

    # -- ServeRuntime hooks -------------------------------------------------

    def switch_to(self, table):
        return self.runtime.switch_to(table)

    def prefill(self, admitted) -> None:
        """Fused-prefill each admitted request's prompt into its slot row."""
        for inf in admitted:
            req = inf.request
            prompt = torch.as_tensor((self.prompt_fn or self.default_prompt)(req.rid, req.prompt_len))
            prompt = prompt.to(self.device, torch.long).reshape(1, -1)
            if prompt.shape[1] != req.prompt_len:
                raise ValueError(
                    f"request {req.rid}: prompt of {prompt.shape[1]} tokens, "
                    f"expected {req.prompt_len}"
                )
            s = inf.slot
            t0 = time.perf_counter()
            row = self._rows(self.cache, slice(s, s + 1))
            tree_map(torch.Tensor.zero_, row)
            logits, _ = api.prefill_with_cache(self.params, self.cfg, row, {"tokens": prompt})
            tok = _greedy(logits, self._nonfinite)
            self.positions[s] = req.prompt_len
            self.tokens[s, 0] = tok[0]
            first = int(tok[0])  # reads the token back: the prefill has finished
            self.prefill_seconds.append(time.perf_counter() - t0)
            self.outputs[req.rid] = [first]

    def decode_tick(self, in_flight) -> None:
        """One grouped decode step of the CURRENT plan over all slots (empty
        slots compute padding, as a fixed-shape batch would)."""
        new_tok, _seconds = self.runtime.run_program(
            self.params, self.cache, self.positions, self.tokens
        )
        self.tokens = new_tok
        occupied = torch.zeros((self.max_slots,), dtype=torch.bool)
        host = new_tok[:, 0].tolist()
        for inf in in_flight:
            occupied[inf.slot] = True
            self.outputs[inf.request.rid].append(host[inf.slot])
        occupied = occupied.to(self.device)
        self.positions = torch.where(occupied, self.positions + 1, self.positions)

    def release(self, slots) -> None:
        for s in slots:
            self.positions[s] = 0
            self.tokens[s] = 0


def _greedy(logits, nonfinite: torch.Tensor) -> torch.Tensor:
    """The last position's argmax; ``nonfinite`` (a bool scalar) is or-ed,
    in place, with whether any of its logits is not finite."""
    last = logits[:, -1, :]
    nonfinite |= ~torch.isfinite(last).all()
    return last.argmax(dim=-1)


def _weak_factory(engine: ServeEngine) -> Callable:
    """``engine._program_for`` through a weak reference: the runtime's cache
    keeps the factory, and a bound method there would keep the engine."""
    ref = weakref.ref(engine)

    def factory(table):
        engine = ref()
        if engine is None:
            raise RuntimeError("the ServeEngine this runtime served was dropped; build a new engine")
        return engine._program_for(table)

    return factory
