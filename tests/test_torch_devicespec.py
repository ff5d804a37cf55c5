"""The port's device specs (``repro_torch.core.devicespec``) against ``repro``'s.

* **Every test of ``tests/test_devicespec.py``, re-run on the port's
  copy**: fail-closed loading, round trips, the reference spec's bitwise
  reduction to ``max(flops/peak, bytes/bw)`` (its constants read from
  ``repro``'s module, which the port does not carry), derating, the limit
  curve, the pinned workloads, and the hardware-matrix goldens through a
  twin of ``benchmarks/hardware_matrix.py`` on the port's decision layer.
* **Equality with ``repro``**: every committed spec loads to the same
  fields, and ``derive_stage_costs`` / ``derive_memory_model`` of every
  ``specs/workloads/*.json`` on every ``specs/*.json`` equal ``repro``'s
  bitwise (the same float arithmetic in the same order).
* **The port holds no roofline constant**: no raw peak of the H100 (or of
  ``repro``'s TPU) in ``src/repro_torch/`` or ``chip_smoke.py``; every part
  is a spec file.
"""

import glob
import json
import os
import re
import types

import numpy as np
import pytest
import torch

import repro.core.devicespec as J
from repro.core.devicespec import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.core.devicespec import (
    KNOWN_DTYPES,
    SPEC_SCHEMA_VERSION,
    TASK_PROGRAMS,
    DeviceSpec,
    DeviceSpecError,
    derive_memory_model,
    derive_stage_costs,
    dtype_key,
    load_device_spec,
    load_workload_profile,
    spec_root,
)

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _spec_payload(**over):
    """A fully valid spec payload; tests mutate one field at a time."""
    base = {
        "schema_version": SPEC_SCHEMA_VERSION,
        "name": "test-part",
        "peak_flops": {"bf16": 1e15, "f32": 5e14},
        "hbm_bandwidth_bytes_per_s": 1e12,
        "hbm_latency_s": 1e-6,
        "memory_capacity_bytes": 1.6e10,
        "link_bandwidth_bytes_per_s": 1e11,
        "link_latency_s": 2e-6,
        "derating": [[4096, 0.25], [1048576, 1.0]],
    }
    base.update(over)
    return base


# ---------------------------------------------------------------------------
# fail-closed loading
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "override, match",
    [
        ({"schema_version": 2}, r"schema_version 2 != supported 1"),
        ({"schema_version": "1"}, r"schema_version '1' != supported 1"),
        ({"name": ""}, r"'name' must be a non-empty string"),
        ({"peak_flops": {}}, r"'peak_flops' must be a non-empty"),
        ({"peak_flops": {"bf16": -1e15}}, r"peak_flops\['bf16'\].* positive"),
        (
            {"peak_flops": {"bf16": 1e15, "complex64": 1e15}},
            r"unknown peak_flops dtype key 'complex64'",
        ),
        ({"hbm_bandwidth_bytes_per_s": 0}, r"hbm_bandwidth.* positive"),
        ({"hbm_bandwidth_bytes_per_s": "fast"}, r"must be a number, got 'fast'"),
        ({"memory_capacity_bytes": -16e9}, r"memory_capacity_bytes.* positive"),
        ({"hbm_latency_s": -1e-9}, r"hbm_latency_s.* >= 0"),
        ({"derating": []}, r"'derating' must be a non-empty list"),
        ({"derating": [[4096]]}, r"derating\[0\] must be a \[bytes, efficiency\] pair"),
        ({"derating": [[4096, 1.5]]}, r"efficiency 1\.5 > 1\.0"),
        (
            {"derating": [[4096, 0.5], [4096, 0.6]]},
            r"bytes must be strictly increasing",
        ),
        (
            {"derating": [[4096, 0.9], [8192, 0.5]]},
            r"efficiency must be non-decreasing",
        ),
    ],
    ids=[
        "schema-version-mismatch", "schema-version-stringly", "empty-name",
        "empty-peaks", "negative-peak", "unknown-dtype-key", "zero-hbm-bw",
        "stringly-hbm-bw", "negative-capacity", "negative-latency",
        "empty-derating", "malformed-knot", "efficiency-above-one",
        "non-increasing-bytes", "decreasing-efficiency",
    ],
)
def test_spec_loading_fails_closed(override, match):
    with pytest.raises(DeviceSpecError, match=match):
        DeviceSpec.from_json(_spec_payload(**override), source="test.json")


@pytest.mark.parametrize(
    "missing",
    ["schema_version", "name", "peak_flops", "hbm_bandwidth_bytes_per_s",
     "memory_capacity_bytes", "link_bandwidth_bytes_per_s", "derating"],
)
def test_spec_missing_required_field_fails_closed(missing):
    payload = _spec_payload()
    del payload[missing]
    with pytest.raises(DeviceSpecError, match=f"missing required field {missing!r}"):
        DeviceSpec.from_json(payload, source="test.json")


def test_spec_error_message_names_the_file():
    """Actionability: the operator must learn WHICH file to fix."""
    with pytest.raises(DeviceSpecError, match=r"^broken\.json: "):
        DeviceSpec.from_json(_spec_payload(schema_version=99), source="broken.json")


def test_load_device_spec_missing_and_invalid_files(tmp_path):
    with pytest.raises(DeviceSpecError, match="device spec file not found"):
        load_device_spec(str(tmp_path / "nope.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(DeviceSpecError, match="not valid JSON"):
        load_device_spec(str(bad))


def test_unknown_compute_dtype_fails_closed():
    spec = DeviceSpec.from_json(_spec_payload())
    with pytest.raises(DeviceSpecError, match="no peak_flops entry for dtype 'f8e4m3fn'"):
        spec.task_seconds(1e12, 1e9, "f8e4m3fn")


def test_dtype_key_mapping_fails_closed():
    assert dtype_key(np.float32) == "f32"
    assert dtype_key("float16") == "f16"
    assert dtype_key(np.dtype("int8")) == "s8"
    assert dtype_key(torch.bfloat16) == "bf16" and dtype_key(torch.float32) == "f32"
    assert dtype_key(torch.float16) == "f16" and dtype_key(torch.float8_e4m3fn) == "f8e4m3fn"
    with pytest.raises(DeviceSpecError, match="no spec dtype key for dtype 'int32'"):
        dtype_key(torch.int32)
    with pytest.raises(DeviceSpecError, match="no spec dtype key for dtype 'int32'"):
        dtype_key(np.int32)
    assert KNOWN_DTYPES >= {"bf16", "f32", "tf32", "f8e4m3fn"}


# ---------------------------------------------------------------------------
# round trips + the committed fleet
# ---------------------------------------------------------------------------


def _committed_specs():
    return sorted(glob.glob(os.path.join(spec_root(), "*.json")))


def test_committed_fleet_present_and_loadable():
    """The committed parts: >= 3 real + 2 synthetic, all valid, names
    matching their file stems (the hardware-matrix job keys on stems)."""
    paths = _committed_specs()
    names = {load_device_spec(p).name for p in paths}
    assert names == {os.path.splitext(os.path.basename(p))[0] for p in paths}
    assert {"tpu-v5e", "h100-sxm", "a100-40gb"} <= names  # real parts
    assert {"synthetic-extreme-skew", "synthetic-slow-interconnect"} <= names


@pytest.mark.parametrize("path", _committed_specs(),
                         ids=[os.path.basename(p) for p in _committed_specs()])
def test_spec_save_load_round_trip(path, tmp_path):
    spec = load_device_spec(path)
    out = tmp_path / os.path.basename(path)
    spec.save(str(out))
    assert load_device_spec(str(out)) == spec


def test_reference_spec_encodes_the_legacy_constants():
    """specs/tpu-v5e.json IS ``repro``'s legacy roofline as data: same three
    numbers (read from ``repro``'s module), zero latency, flat 1.0 derating."""
    spec = load_device_spec(os.path.join(spec_root(), "tpu-v5e.json"))
    assert spec.peak_flops_for("bf16") == PEAK_FLOPS
    assert spec.peak_flops_for("f32") == PEAK_FLOPS
    assert spec.hbm_bandwidth_bytes_per_s == HBM_BW
    assert spec.link_bandwidth_bytes_per_s == LINK_BW
    assert spec.hbm_latency_s == 0.0 and spec.link_latency_s == 0.0
    assert spec.derating == ((0.0, 1.0),)


def test_reference_spec_task_seconds_bitwise_equals_legacy_roofline():
    """The bit-for-bit reduction the whole migration rests on: with zero
    latency and constant derating 1.0, task_seconds == the legacy
    max(flops/peak, bytes/bw) as EXACT floats (0.0 + x == x and
    bw * 1.0 == bw in IEEE arithmetic), across magnitudes."""
    spec = load_device_spec(os.path.join(spec_root(), "tpu-v5e.json"))
    rng = np.random.default_rng(0)
    for _ in range(200):
        flops = float(10.0 ** rng.uniform(6, 16))
        nbytes = float(10.0 ** rng.uniform(3, 12))
        legacy = max(flops / PEAK_FLOPS, nbytes / HBM_BW)
        assert spec.task_seconds(flops, nbytes, "bf16") == legacy
    assert spec.link_seconds(1e9) == 1e9 / LINK_BW


def test_derating_curve_interpolation():
    spec = DeviceSpec.from_json(
        _spec_payload(derating=[[1e3, 0.5], [9e3, 0.9]], hbm_latency_s=0.0)
    )
    assert spec.hbm_efficiency(10.0) == 0.5  # clamped below first knot
    assert spec.hbm_efficiency(1e3) == 0.5
    assert spec.hbm_efficiency(5e3) == pytest.approx(0.7)  # midpoint
    assert spec.hbm_efficiency(1e6) == 0.9  # clamped above last knot
    # derating makes memory-bound tasks slower, never faster
    assert spec.task_seconds(1.0, 1e3, "bf16") == 2 * (1e3 / 1e12)


def test_limit_curve_is_per_stage_capacity():
    spec = DeviceSpec.from_json(_spec_payload())
    assert spec.limit_curve(4) == [1.6e10] * 4


# ---------------------------------------------------------------------------
# workload profiles
# ---------------------------------------------------------------------------

_PINNED = os.path.join(spec_root(), "workloads", "pinned-4stage.json")


def _workload_payload():
    with open(_PINNED) as f:
        return json.load(f)


def test_pinned_workload_loads_and_derives():
    wl = load_workload_profile(_PINNED)
    assert wl.num_stages == 4 and wl.dtype == "bf16"
    spec = load_device_spec(os.path.join(spec_root(), "h100-sxm.json"))
    costs = derive_stage_costs(wl, spec)
    assert costs.num_stages == 4
    for p in TASK_PROGRAMS:
        assert all(t > 0 for t in getattr(costs, f"{p}_time"))
    # B/W split composes exactly, and the saved-residual trade is present:
    # fewer FLOPs than BWD_WEIGHT but more HBM traffic
    for s in range(4):
        assert costs.bwd_time[s] == costs.bwd_input_time[s] + costs.bwd_weight_time[s]
        assert wl.counts[s]["bwd_weight_saved"].flops < wl.counts[s]["bwd_weight"].flops
        assert (
            wl.counts[s]["bwd_weight_saved"].hbm_bytes
            > wl.counts[s]["bwd_weight"].hbm_bytes
        )
    mm = derive_memory_model(wl)
    assert len(mm.stages) == 4 and mm.seq_len == wl.seq_len


@pytest.mark.parametrize(
    "mutate, match",
    [
        (lambda p: p.update(schema_version=7), r"schema_version 7 != supported"),
        (lambda p: p.update(dtype="float16"), r"unknown workload dtype 'float16'"),
        (lambda p: p["stages"][0].pop("bwd_weight_saved"),
         r"stages\[0\].*missing required field 'bwd_weight_saved'"),
        (lambda p: p["stages"][1]["fwd"].update(flops=-1.0),
         r"stages\[1\]\.fwd.*'flops' must be positive"),
        (lambda p: p["stages"][2]["memory"].update(bogus_field=1.0),
         r"stages\[2\]\.memory.*StageMemorySpec fields"),
        (lambda p: p.update(stages=[]), r"'stages' must be a non-empty list"),
    ],
    ids=["schema-version", "non-key-dtype", "missing-program",
         "negative-flops", "unknown-memory-field", "no-stages"],
)
def test_workload_loading_fails_closed(tmp_path, mutate, match):
    payload = _workload_payload()
    mutate(payload)
    path = tmp_path / "wl.json"
    path.write_text(json.dumps(payload))
    with pytest.raises(DeviceSpecError, match=match):
        load_workload_profile(str(path))


# ---------------------------------------------------------------------------
# equality with repro
# ---------------------------------------------------------------------------

_WORKLOADS = sorted(glob.glob(os.path.join(spec_root(), "workloads", "*.json")))


@pytest.mark.parametrize("path", _committed_specs(), ids=[os.path.basename(p) for p in _committed_specs()])
def test_committed_spec_loads_as_repro_loads_it(path):
    port, ref = load_device_spec(path), J.load_device_spec(path)
    assert port.to_json() == ref.to_json()
    for nbytes in (0.0, 1e3, 5e4, 3e6, 1e9):
        assert port.hbm_efficiency(nbytes) == ref.hbm_efficiency(nbytes)
    assert port.limit_curve(4) == ref.limit_curve(4)


@pytest.mark.parametrize(
    "workload,spec",
    [(w, s) for w in _WORKLOADS for s in _committed_specs()],
    ids=[f"{os.path.basename(w)}-{os.path.basename(s)}" for w in _WORKLOADS for s in _committed_specs()],
)
def test_derive_equals_repro_bitwise(workload, spec):
    wl, jwl = load_workload_profile(workload), J.load_workload_profile(workload)
    assert wl.to_json() == jwl.to_json()
    got = derive_stage_costs(wl, load_device_spec(spec))
    want = J.derive_stage_costs(jwl, J.load_device_spec(spec))
    for field in ("fwd_time", "bwd_time", "fwd_bytes", "bwd_bytes", "bwd_input_time",
                  "bwd_weight_time", "bwd_weight_saved_time", "optimizer_time"):
        assert getattr(got, field) == getattr(want, field), field
    mm, jmm = derive_memory_model(wl), J.derive_memory_model(jwl)
    assert [vars(s) for s in mm.stages] == [vars(s) for s in jmm.stages]
    assert mm.seq_len == jmm.seq_len


# ---------------------------------------------------------------------------
# roofline-constant scan: no part's numbers in the port's code
# ---------------------------------------------------------------------------

#: a roofline-constant definition, or a raw peak of the H100 (HBM bytes/s,
#: bf16/fp16, TF32 and fp32 FLOP/s) or of repro's TPU spelled inline
_PORT_ROOFLINE_RE = re.compile(
    r"(PEAK_FLOPS|HBM_BW|LINK_BW)\s*=\s*[0-9]"
    r"|(?<![0-9_.])(3\.35e12|989e12|494e12|67e12|197e12|819e9|50e9)(?![0-9])"
)


def _port_sources() -> list[str]:
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(_REPO, "src", "repro_torch")):
        paths += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return paths


def test_no_raw_roofline_constants_in_the_port():
    """Hardware numbers are data (specs/*.json), not code: the port's twin
    of ``tests/test_devicespec.py``'s scan, with the H100's peaks."""
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            for lineno, line in enumerate(fh, 1):
                if _PORT_ROOFLINE_RE.search(line):
                    offenders.append(f"{os.path.relpath(path, _REPO)}:{lineno}: {line.strip()}")
    assert not offenders, "raw roofline constants in the port; read them from specs/*.json:\n" + "\n".join(offenders)
    for bad in ("H100 = 989e12", "x = {'bf16': 3.35e12}", "HBM_BW = 1"):
        assert _PORT_ROOFLINE_RE.search(bad), bad


# ---------------------------------------------------------------------------
# hardware-matrix conformance on the port's decision layer
# ---------------------------------------------------------------------------


def _port_hardware_matrix() -> types.ModuleType:
    """``benchmarks/hardware_matrix.py`` with ``repro.core`` replaced by the
    port's copy: the same slice, derived, enumerated, tuned and simulated by
    the port."""
    path = os.path.join(_REPO, "benchmarks", "hardware_matrix.py")
    with open(path) as fh:
        src = fh.read().replace("repro.core", "repro_torch.core")
    assert "from repro." not in src and "import repro\n" not in src
    mod = types.ModuleType("port_hardware_matrix")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def test_hardware_matrix_goldens_conformant():
    """Every committed spec's derive -> enumerate -> tune -> simulate slice,
    run on the port, matches its golden fixture in ``specs/golden/``."""
    hm = _port_hardware_matrix()
    paths = hm.all_spec_paths()
    assert len(paths) >= 5
    drifts = [d for p in paths for d in hm.check_spec(p)]
    assert not drifts, "hardware-matrix drift vs specs/golden/:\n" + "\n".join(drifts)


def test_hardware_matrix_divergent_choice():
    """The same pinned workload tunes to a different ScheduleSpec on the
    compute-rich H100 than on the memory-starved synthetic part."""
    hm = _port_hardware_matrix()
    h100 = hm.conformance_slice(os.path.join(spec_root(), "h100-sxm.json"))
    skew = hm.conformance_slice(os.path.join(spec_root(), "synthetic-extreme-skew.json"))
    assert h100["chosen"] != skew["chosen"]
    assert len(skew["candidates"]) < len(h100["candidates"])
