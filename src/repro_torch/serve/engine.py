"""ServeEngine: fused prefill and grouped greedy decode over decode slots.

Port of ``repro/serve/engine.py``.  The engine owns the model parameters and
a slot-major decode state: a KV cache whose batch rows are the
``max_slots`` decode slots, plus per-slot positions and last tokens.

* **prefill** -- :func:`repro_torch.models.api.prefill_with_cache` on one
  admitted request (batch 1), written straight into the request's slot row
  of the cache.  Its attention is the flash kernel on the card.
* **grouped decode tick** -- the slots are laid out as the ``[M, b]`` grid
  of the current plan (``switch_to(M)``) and the tick runs the M groups one
  after the other, each one batch-``b`` decode with per-row positions (the
  reference's ``lax.map`` over groups of a ``vmap``'d single-slot decode).
  Empty slots compute padding, as a fixed-shape batch does in the reference.
  ``M`` is all the reference's decode program depends on; the plan objects
  themselves come with the schedule-layer slice.

Decoding is greedy, so runs are reproducible token for token; emitted tokens
accumulate in ``outputs[rid]``.  Matrices and the embedding table are held in
``cfg.dtype`` (cast once at load), norm scales and biases in
``cfg.param_dtype``.  The cache is updated in place.
"""

from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.common import ModelConfig

__all__ = ["ServeEngine"]


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        max_slots: int,
        max_len: int,
        params=None,
        seed: int = 0,
        device=None,
    ) -> None:
        """``params``: a parameter tree on ``device`` (e.g. from the weight
        bridge); without one, weights are drawn from ``seed``."""
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
        self.num_microbatches: int | None = None
        self.micro_batch: int | None = None
        self.prefill_seconds: list[float] = []  # wall time of each prefill call
        self._nonfinite = torch.zeros((), dtype=torch.bool, device=self.device)

    # -- plan ---------------------------------------------------------------

    def switch_to(self, num_microbatches: int) -> None:
        """Lay the slots out as an ``[M, b]`` grid, ``b = max_slots / M``."""
        if num_microbatches <= 0 or self.max_slots % num_microbatches:
            raise ValueError(f"M={num_microbatches} must divide max_slots={self.max_slots}")
        self.num_microbatches = num_microbatches
        self.micro_batch = self.max_slots // num_microbatches

    # -- state --------------------------------------------------------------

    @property
    def nonfinite(self) -> bool:
        """Whether any prefill or decode produced a non-finite logit."""
        return bool(self._nonfinite)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _rows(self, rows: slice):
        return {
            "layers": [
                {"kv": {"k": c["kv"]["k"][rows], "v": c["kv"]["v"][rows]}}
                for c in self.cache["layers"]
            ]
        }

    def _greedy(self, logits) -> torch.Tensor:
        last = logits[:, -1, :]
        self._nonfinite |= ~torch.isfinite(last).all()
        return last.argmax(dim=-1)

    def default_prompt(self, rid: int, prompt_len: int) -> torch.Tensor:
        """The seeded prompt of request ``rid``: [1, prompt_len] tokens."""
        gen = torch.Generator(device=self.device).manual_seed(rid)
        return torch.randint(
            0, self.cfg.vocab_size, (1, prompt_len), generator=gen, device=self.device
        )

    # -- ServeRuntime hooks -------------------------------------------------

    def prefill(self, admitted, prompts=None) -> None:
        """Fused-prefill each admitted request's prompt into its slot row.
        ``prompts`` maps a request id to its prompt tokens; by default the
        prompt is :meth:`default_prompt`."""
        for inf in admitted:
            req = inf.request
            if prompts is not None:
                given = prompts[req.rid]
                if not isinstance(given, torch.Tensor):
                    given = torch.tensor(given)
                prompt = given.to(self.device, torch.long).reshape(1, -1)
            else:
                prompt = self.default_prompt(req.rid, req.prompt_len)
            if prompt.shape[1] != req.prompt_len:
                raise ValueError(
                    f"request {req.rid}: prompt of {prompt.shape[1]} tokens, "
                    f"expected {req.prompt_len}"
                )
            s = inf.slot
            t0 = time.perf_counter()
            row = self._rows(slice(s, s + 1))
            for c in row["layers"]:
                c["kv"]["k"].zero_()
                c["kv"]["v"].zero_()
            logits, _ = api.prefill_with_cache(self.params, self.cfg, row, {"tokens": prompt})
            tok = self._greedy(logits)
            self.positions[s] = req.prompt_len
            self.tokens[s, 0] = tok[0]
            first = int(tok[0])  # reads the token back: the prefill has finished
            self.prefill_seconds.append(time.perf_counter() - t0)
            self.outputs[req.rid] = [first]

    def decode_tick(self, in_flight) -> None:
        """One grouped decode step of the current grid over all slots."""
        if self.num_microbatches is None:
            raise RuntimeError("decode_tick before switch_to")
        b = self.micro_batch
        new_tok = torch.empty_like(self.tokens)
        for g in range(self.num_microbatches):
            rows = slice(g * b, (g + 1) * b)
            logits, _ = api.decode_fn(
                self.params, self.cfg, self._rows(rows), self.positions[rows],
                {"tokens": self.tokens[rows]},
            )
            new_tok[rows, 0] = self._greedy(logits)
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
