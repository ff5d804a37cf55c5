"""Versioned device-spec files: offline roofline pricing for hardware you don't own.

Copy of ``repro/core/devicespec.py``.  The device is DATA:

* :class:`DeviceSpec` -- a schema-versioned, fail-closed description of one
  accelerator: peak FLOP/s **per dtype**, HBM bandwidth + per-task latency,
  an effective-bandwidth **derating curve** (small transfers don't reach
  peak HBM bandwidth), memory capacity, and link bandwidth/latency.
  Committed instances live under ``specs/`` at the repo root (see
  ``specs/README.md`` for how to author one; ``specs/h100-sxm.json`` is
  the card the port runs on).
* :class:`WorkloadProfile` -- the device-independent half of a calibration:
  per-stage FLOP/byte counts of the four task programs (``fwd`` /
  ``bwd_input`` / ``bwd_weight`` / ``bwd_weight_saved``) plus the memory
  footprint fields, captured once from
  :func:`repro_torch.core.calibrate.calibrate_stage_costs` (or
  hand-authored) and committed as JSON.
* :func:`derive_stage_costs` / :func:`derive_memory_model` -- the offline
  join: ``(workload, spec) -> StageCosts`` and ``workload ->
  MemoryModel``, pure float arithmetic, no accelerator.  With the
  per-stage limit curve from :meth:`DeviceSpec.limit_curve`, these are the
  exact inputs ``enumerate_candidates`` + ``AutoTuner`` consume.

The pricing formula per task is the latency-padded derated roofline

    seconds = max( flops / peak_flops[dtype],
                   hbm_latency + hbm_bytes / (hbm_bw * derate(hbm_bytes)) )

which reduces **bit-for-bit** to ``max(flops/peak, bytes/bw)`` when a spec
encodes zero latency and a constant derating of 1.0 (``specs/tpu-v5e.json``
does).

Unlike ``repro``'s module, this copy holds no roofline constant of any
part: every number of a part is read from its spec file
(``tests/test_torch_devicespec.py`` scans the port for raw peaks).
:func:`dtype_key` also maps torch dtypes (``torch.bfloat16`` -> ``"bf16"``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.memory_model import MemoryModel, StageMemorySpec
from repro_torch.core.taskgraph import StageCosts

__all__ = [
    "SPEC_SCHEMA_VERSION",
    "KNOWN_DTYPES",
    "TASK_PROGRAMS",
    "DeviceSpecError",
    "DeviceSpec",
    "WorkloadProfile",
    "load_device_spec",
    "load_workload_profile",
    "derive_stage_costs",
    "derive_memory_model",
    "dtype_key",
    "spec_root",
    "ProgramCounts",
]

SPEC_SCHEMA_VERSION = 1

#: dtype keys a spec's ``peak_flops`` table may use (the optimized-HLO
#: shape-dtype names; mirrors the analyzer's table without importing it)
KNOWN_DTYPES = frozenset(
    {
        "f64", "f32", "tf32", "bf16", "f16",
        "f8e4m3fn", "f8e5m2", "s8", "u8", "s4", "u4",
    }
)

#: the four per-stage task programs a calibration profiles — one cost each
TASK_PROGRAMS = ("fwd", "bwd_input", "bwd_weight", "bwd_weight_saved")

_DTYPE_KEYS = {
    "float64": "f64",
    "float32": "f32",
    "bfloat16": "bf16",
    "float16": "f16",
    "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2",
    "int8": "s8",
    "uint8": "u8",
}


class DeviceSpecError(ValueError):
    """A spec/workload file failed validation; the message names the file,
    the offending field, and what a valid value looks like."""


def dtype_key(dtype) -> str:
    """Canonical spec dtype key for a numpy or torch dtype (fails closed)."""
    if type(dtype).__module__ == "torch":  # torch.bfloat16 -> "bfloat16"
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPE_KEYS:
        raise DeviceSpecError(
            f"no spec dtype key for dtype {name!r}; known model dtypes: "
            f"{sorted(_DTYPE_KEYS)}"
        )
    return _DTYPE_KEYS[name]


def spec_root() -> str:
    """The committed ``specs/`` directory (override: ``REPRO_SPEC_DIR``)."""
    env = os.environ.get("REPRO_SPEC_DIR")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "..", "specs"))


def _require(payload: Mapping, field: str, source: str):
    if field not in payload:
        raise DeviceSpecError(f"{source}: missing required field {field!r}")
    return payload[field]


def _positive(value, field: str, source: str) -> float:
    try:
        x = float(value)
    except (TypeError, ValueError):
        raise DeviceSpecError(
            f"{source}: field {field!r} must be a number, got {value!r}"
        ) from None
    if not np.isfinite(x) or x <= 0:
        raise DeviceSpecError(
            f"{source}: field {field!r} must be positive and finite, got {value!r}"
        )
    return x


def _non_negative(value, field: str, source: str) -> float:
    try:
        x = float(value)
    except (TypeError, ValueError):
        raise DeviceSpecError(
            f"{source}: field {field!r} must be a number, got {value!r}"
        ) from None
    if not np.isfinite(x) or x < 0:
        raise DeviceSpecError(
            f"{source}: field {field!r} must be >= 0 and finite, got {value!r}"
        )
    return x


def _check_schema(payload: Mapping, source: str) -> None:
    version = _require(payload, "schema_version", source)
    if version != SPEC_SCHEMA_VERSION:
        raise DeviceSpecError(
            f"{source}: schema_version {version!r} != supported "
            f"{SPEC_SCHEMA_VERSION}; re-author the file against the current "
            f"format (see specs/README.md)"
        )


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One accelerator part, as data.  All rates are bytes/s or FLOP/s."""

    name: str
    peak_flops: Mapping[str, float]  # dtype key -> FLOP/s
    hbm_bandwidth_bytes_per_s: float
    memory_capacity_bytes: float
    link_bandwidth_bytes_per_s: float
    #: (bytes_moved, efficiency) knots, bytes strictly increasing and
    #: efficiency in (0, 1], non-decreasing: the fraction of peak HBM
    #: bandwidth a transfer of that size actually achieves (small kernels
    #: never reach peak).  Piecewise-linear between knots, clamped outside.
    derating: tuple[tuple[float, float], ...] = ((0.0, 1.0),)
    hbm_latency_s: float = 0.0
    link_latency_s: float = 0.0
    notes: str = ""

    def peak_flops_for(self, dtype: str) -> float:
        """The dtype's peak FLOP/s; unknown keys fail closed by design —
        silently falling back to another dtype's peak would corrupt every
        derived cost without a trace."""
        if dtype not in self.peak_flops:
            raise DeviceSpecError(
                f"device spec {self.name!r} has no peak_flops entry for dtype "
                f"{dtype!r} (has: {sorted(self.peak_flops)}); add the entry "
                f"to the spec file"
            )
        return self.peak_flops[dtype]

    def hbm_efficiency(self, nbytes: float) -> float:
        """Derated fraction of peak HBM bandwidth at this transfer size."""
        knots = self.derating
        if nbytes <= knots[0][0]:
            return knots[0][1]
        for (b0, e0), (b1, e1) in zip(knots, knots[1:]):
            if nbytes <= b1:
                return e0 + (nbytes - b0) / (b1 - b0) * (e1 - e0)
        return knots[-1][1]

    def effective_hbm_bandwidth(self, nbytes: float) -> float:
        return self.hbm_bandwidth_bytes_per_s * self.hbm_efficiency(nbytes)

    def task_seconds(self, flops: float, hbm_bytes: float, dtype: str) -> float:
        """Latency-padded derated roofline time of one task program.

        Reduces bit-for-bit to the legacy ``max(flops/peak, bytes/bw)``
        when ``hbm_latency_s == 0`` and the derating is constant 1.0.
        """
        compute = flops / self.peak_flops_for(dtype)
        memory = self.hbm_latency_s + hbm_bytes / self.effective_hbm_bandwidth(hbm_bytes)
        return max(compute, memory)

    def link_seconds(self, nbytes: float) -> float:
        return self.link_latency_s + nbytes / self.link_bandwidth_bytes_per_s

    def limit_curve(self, num_stages: int) -> list[float]:
        """Per-stage memory-limit curve: one device per stage, each capped
        at the part's capacity (the curve ``enumerate_candidates`` walks)."""
        return [self.memory_capacity_bytes] * num_stages

    def to_json(self) -> dict:
        return {
            "schema_version": SPEC_SCHEMA_VERSION,
            "name": self.name,
            "notes": self.notes,
            "peak_flops": dict(self.peak_flops),
            "hbm_bandwidth_bytes_per_s": self.hbm_bandwidth_bytes_per_s,
            "hbm_latency_s": self.hbm_latency_s,
            "memory_capacity_bytes": self.memory_capacity_bytes,
            "link_bandwidth_bytes_per_s": self.link_bandwidth_bytes_per_s,
            "link_latency_s": self.link_latency_s,
            "derating": [list(knot) for knot in self.derating],
        }

    @classmethod
    def from_json(cls, payload: Mapping, source: str = "<memory>") -> "DeviceSpec":
        if not isinstance(payload, Mapping):
            raise DeviceSpecError(f"{source}: device spec must be a JSON object")
        _check_schema(payload, source)
        name = _require(payload, "name", source)
        if not isinstance(name, str) or not name:
            raise DeviceSpecError(f"{source}: field 'name' must be a non-empty string")
        peaks_raw = _require(payload, "peak_flops", source)
        if not isinstance(peaks_raw, Mapping) or not peaks_raw:
            raise DeviceSpecError(
                f"{source}: field 'peak_flops' must be a non-empty "
                f"{{dtype: FLOP/s}} object"
            )
        peaks = {}
        for dt, val in peaks_raw.items():
            if dt not in KNOWN_DTYPES:
                raise DeviceSpecError(
                    f"{source}: unknown peak_flops dtype key {dt!r}; known "
                    f"dtype keys: {sorted(KNOWN_DTYPES)}"
                )
            peaks[dt] = _positive(val, f"peak_flops[{dt!r}]", source)
        derating_raw = _require(payload, "derating", source)
        if not isinstance(derating_raw, Sequence) or not derating_raw:
            raise DeviceSpecError(
                f"{source}: field 'derating' must be a non-empty list of "
                f"[bytes, efficiency] knots"
            )
        knots = []
        for i, knot in enumerate(derating_raw):
            if not isinstance(knot, Sequence) or len(knot) != 2:
                raise DeviceSpecError(
                    f"{source}: derating[{i}] must be a [bytes, efficiency] pair"
                )
            nbytes = _non_negative(knot[0], f"derating[{i}].bytes", source)
            eff = _positive(knot[1], f"derating[{i}].efficiency", source)
            if eff > 1.0:
                raise DeviceSpecError(
                    f"{source}: derating[{i}].efficiency {eff} > 1.0 — the "
                    f"curve derates FROM peak bandwidth, it cannot exceed it"
                )
            knots.append((nbytes, eff))
        for (b0, e0), (b1, e1) in zip(knots, knots[1:]):
            if b1 <= b0:
                raise DeviceSpecError(
                    f"{source}: derating bytes must be strictly increasing "
                    f"(got {b0} then {b1})"
                )
            if e1 < e0:
                raise DeviceSpecError(
                    f"{source}: derating efficiency must be non-decreasing in "
                    f"transfer size (got {e0} then {e1}) — bigger transfers "
                    f"cannot achieve a smaller fraction of peak bandwidth"
                )
        return cls(
            name=name,
            peak_flops=peaks,
            hbm_bandwidth_bytes_per_s=_positive(
                _require(payload, "hbm_bandwidth_bytes_per_s", source),
                "hbm_bandwidth_bytes_per_s", source,
            ),
            memory_capacity_bytes=_positive(
                _require(payload, "memory_capacity_bytes", source),
                "memory_capacity_bytes", source,
            ),
            link_bandwidth_bytes_per_s=_positive(
                _require(payload, "link_bandwidth_bytes_per_s", source),
                "link_bandwidth_bytes_per_s", source,
            ),
            derating=tuple(knots),
            hbm_latency_s=_non_negative(
                payload.get("hbm_latency_s", 0.0), "hbm_latency_s", source
            ),
            link_latency_s=_non_negative(
                payload.get("link_latency_s", 0.0), "link_latency_s", source
            ),
            notes=str(payload.get("notes", "")),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")


def load_device_spec(path: str) -> DeviceSpec:
    """Load + validate one committed spec file (fails closed on any drift)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        raise DeviceSpecError(
            f"device spec file not found: {path!r} (committed specs live "
            f"under {spec_root()!r})"
        ) from None
    except json.JSONDecodeError as e:
        raise DeviceSpecError(f"{path}: not valid JSON ({e})") from None
    return DeviceSpec.from_json(payload, source=os.path.basename(path))


# ---------------------------------------------------------------------------
# WorkloadProfile: the device-independent half of a calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProgramCounts:
    """Roofline counts of one task program at one stage (in the port, from
    :func:`repro_torch.launch.op_counts.count_ops`)."""

    flops: float
    hbm_bytes: float


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """Per-stage FLOP/byte counts + memory footprint of one pipeline config.

    Everything here is a property of the MODEL (shapes, dtype, stage split),
    not of the accelerator — capture once (``WorkloadProfile.from_calibration``
    or hand-author), then join against any :class:`DeviceSpec` offline.
    """

    name: str
    dtype: str  # spec dtype key the compute runs in
    micro_batch_size: int
    seq_len: int
    act_bytes: float  # activation wire bytes per stage boundary
    counts: tuple[dict[str, ProgramCounts], ...]  # per stage, per program
    memory: tuple[StageMemorySpec, ...]

    @property
    def num_stages(self) -> int:
        return len(self.counts)

    def to_json(self) -> dict:
        stages = []
        for cnt, mem in zip(self.counts, self.memory):
            row = {
                p: {"flops": cnt[p].flops, "hbm_bytes": cnt[p].hbm_bytes}
                for p in TASK_PROGRAMS
            }
            row["memory"] = dataclasses.asdict(mem)
            stages.append(row)
        return {
            "schema_version": SPEC_SCHEMA_VERSION,
            "name": self.name,
            "dtype": self.dtype,
            "micro_batch_size": self.micro_batch_size,
            "seq_len": self.seq_len,
            "act_bytes": self.act_bytes,
            "stages": stages,
        }

    @classmethod
    def from_json(cls, payload: Mapping, source: str = "<memory>") -> "WorkloadProfile":
        if not isinstance(payload, Mapping):
            raise DeviceSpecError(f"{source}: workload profile must be a JSON object")
        _check_schema(payload, source)
        dtype = _require(payload, "dtype", source)
        if dtype not in KNOWN_DTYPES:
            raise DeviceSpecError(
                f"{source}: unknown workload dtype {dtype!r}; known dtype "
                f"keys: {sorted(KNOWN_DTYPES)}"
            )
        stages_raw = _require(payload, "stages", source)
        if not isinstance(stages_raw, Sequence) or not stages_raw:
            raise DeviceSpecError(f"{source}: field 'stages' must be a non-empty list")
        counts, memory = [], []
        for s, row in enumerate(stages_raw):
            per_prog = {}
            for p in TASK_PROGRAMS:
                cell = _require(row, p, f"{source}:stages[{s}]")
                per_prog[p] = ProgramCounts(
                    flops=_positive(
                        _require(cell, "flops", f"{source}:stages[{s}].{p}"),
                        "flops", f"{source}:stages[{s}].{p}",
                    ),
                    hbm_bytes=_positive(
                        _require(cell, "hbm_bytes", f"{source}:stages[{s}].{p}"),
                        "hbm_bytes", f"{source}:stages[{s}].{p}",
                    ),
                )
            counts.append(per_prog)
            mem_raw = dict(_require(row, "memory", f"{source}:stages[{s}]"))
            try:
                memory.append(StageMemorySpec(**mem_raw))
            except TypeError as e:
                raise DeviceSpecError(
                    f"{source}:stages[{s}].memory: {e} (expected the "
                    f"StageMemorySpec fields)"
                ) from None
        return cls(
            name=str(_require(payload, "name", source)),
            dtype=dtype,
            micro_batch_size=int(
                _positive(
                    _require(payload, "micro_batch_size", source),
                    "micro_batch_size", source,
                )
            ),
            seq_len=int(
                _positive(_require(payload, "seq_len", source), "seq_len", source)
            ),
            act_bytes=_positive(
                _require(payload, "act_bytes", source), "act_bytes", source
            ),
            counts=tuple(counts),
            memory=tuple(memory),
        )

    @classmethod
    def from_calibration(cls, cal, name: str) -> "WorkloadProfile":
        """Capture the device-independent counts of a finished calibration
        (``cal`` is a :class:`repro_torch.core.calibrate.Calibration`)."""
        counts = tuple(
            {
                p: ProgramCounts(
                    flops=prof[p].flops, hbm_bytes=prof[p].hbm_bytes
                )
                for p in TASK_PROGRAMS
            }
            for prof in cal.profiles
        )
        return cls(
            name=name,
            dtype=cal.dtype,
            micro_batch_size=cal.micro_batch_size,
            seq_len=cal.memory.seq_len,
            act_bytes=cal.costs.fwd_bytes[0],
            counts=counts,
            memory=tuple(cal.memory.stages),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
            f.write("\n")


def load_workload_profile(path: str) -> WorkloadProfile:
    try:
        with open(path) as f:
            payload = json.load(f)
    except FileNotFoundError:
        raise DeviceSpecError(f"workload profile not found: {path!r}") from None
    except json.JSONDecodeError as e:
        raise DeviceSpecError(f"{path}: not valid JSON ({e})") from None
    return WorkloadProfile.from_json(payload, source=os.path.basename(path))


def derive_stage_costs(workload: WorkloadProfile, spec: DeviceSpec) -> StageCosts:
    """The offline join: price every stage's four programs on ``spec``.

    Pure float arithmetic over the committed counts — deterministic on any
    host, which is what lets the CI hardware-matrix job gate cost-model
    behaviour for hardware nobody owns.
    """
    t = {
        p: [spec.task_seconds(c[p].flops, c[p].hbm_bytes, workload.dtype)
            for c in workload.counts]
        for p in TASK_PROGRAMS
    }
    S = workload.num_stages
    return StageCosts(
        fwd_time=t["fwd"],
        bwd_time=[bi + bw for bi, bw in zip(t["bwd_input"], t["bwd_weight"])],
        fwd_bytes=[workload.act_bytes] * S,
        bwd_bytes=[workload.act_bytes] * S,
        bwd_input_time=t["bwd_input"],
        bwd_weight_time=t["bwd_weight"],
        bwd_weight_saved_time=t["bwd_weight_saved"],
    )


def derive_memory_model(workload: WorkloadProfile) -> MemoryModel:
    """The workload's per-stage :class:`MemoryModel` (device-independent)."""
    return MemoryModel(stages=list(workload.memory), seq_len=workload.seq_len)
