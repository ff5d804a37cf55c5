"""The dry run (``repro_torch.launch.dryrun``) and the collective half of
``repro_torch.launch.hlo_analysis`` against real ranks and against ``repro``.

* **The dry run is the real run.**  Four gloo ranks, spawned once a mesh
  ((2, 2), then (1, 4)) through ``rank_checks.dry_vs_recorded``, run
  ``tp_fsdp`` and ``zero3`` train steps, a prefill and a decode step on
  qwen1.5-4b's and jamba's smoke configs with each rank's group under a
  ``CollectiveRecorder``; then each rank dry-runs the same cases at its own
  coordinate (fake tensors, a ``DryGroup``).  The two lists of collectives
  (kind, axes, group size, shape, dtype, dim, in call order) are equal at
  every rank, and so are the arguments' bytes.
* **FLOPs against ``repro``'s ``analyze_hlo``.**  ``repro``'s
  ``make_spmd_train_step`` compiled on a (2, 2) CPU mesh of four host
  devices in a subprocess (as ``tests/test_torch_spmd.py`` runs it) counts
  per device the FLOPs of the port's dry run at rank 0, but for one named
  term: the port's K1 backward recomputes the plain attention forward
  (``ref.train_attention_flops`` of the rank's rows and heads, once a layer
  and micro-batch), which XLA's differentiated program does not.  The gap is
  held exactly, and the whole within 2%.
* ``zero3``'s all-gather and reduce-scatter bytes equal the closed form of
  the sharding rules; ``roofline_terms`` is ``repro``'s formula; a
  production-mesh pair at cut depth runs through ``main``; the recorder and
  the dry group price and shape each collective by ``repro``'s ring rules.
* **The stateless spmd ``PlanRuntime``** (``optimizer=None``) switches and
  runs its programs on every rank as the reference backend does in one
  process: the same outputs, switch records and layouts, and it refuses
  ``run_iteration``.
"""

import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as jax_hlo
from repro_torch.configs import get_arch
from repro_torch.core.kinds import ScheduleSpec
from repro_torch.core.schedule import make_plan
from repro_torch.distributed import rank_checks
from repro_torch.distributed.sharding import spec_axes
from repro_torch.distributed.spmd import make_spmd_train_step
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.hlo_analysis import CollectiveEntry, CollectiveRecorder, DryGroup
from repro_torch.optim import make_optimizer
from repro_torch.pipeline import ranks
from repro_torch.runtime.executor import PlanRuntime
from repro_torch.tree import flatten

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
B, T, M = 8, 32, 2
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
#: (id, arch, strategy, micro-batches, rows)
TRAIN = [
    ("qwen-tp_fsdp", "qwen1.5-4b", "tp_fsdp", M, B),
    ("qwen-zero3", "qwen1.5-4b", "zero3", M, B),
    ("jamba-tp_fsdp", "jamba-v0.1-52b", "tp_fsdp", 1, 4),
    ("jamba-zero3", "jamba-v0.1-52b", "zero3", 1, 4),
]
#: (id, arch, prompt rows, prompt length, kv_len)
SERVE = [("qwen-serve", "qwen1.5-4b", 4, 16, 32), ("jamba-serve", "jamba-v0.1-52b", 2, 16, 32)]
CASE_IDS = [c[0] for c in TRAIN] + [c[0] for c in SERVE]
#: the stateless runtime's plans (lowered) and operand
RUNTIME_PLANS = [("kfkb", 4, 1), ("kfkb", 8, 2), ("interleaved", 8, 1), ("kfkb", 4, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's torch work (the suite's workers
    share the CPU).  Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    return get_arch(arch).smoke.replace(dtype=torch.float32)


def _train_case(arch, strategy, m, rows, seed):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, _cfg(arch).vocab_size, (rows, T)).astype(np.int64) for k in ("tokens", "labels")}
    return dict(cfg=_cfg(arch), strategy=strategy, M=m, steps=1, batch=batch, optimizer="adamw", lr=1e-3, seed=seed)


def _serve_case(arch, rows, t, kv_len, seed):
    rng = np.random.default_rng(seed)
    vocab = _cfg(arch).vocab_size
    return dict(cfg=_cfg(arch), seed=seed, prompt=rng.integers(0, vocab, (rows, t)).astype(np.int64),
                decode=rng.integers(0, vocab, (1, rows, 1)).astype(np.int64), kv_len=kv_len)


def _tables():
    return [make_plan(4, m, spec=ScheduleSpec(kind=kind, k=k, num_virtual=2 if kind == "interleaved" else 1)).lower()
            for kind, m, k in RUNTIME_PLANS]


_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.distributed.spmd import make_spmd_train_step
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.optim import make_optimizer, schedules

    out = {}
    for cid, arch, strategy, M, rows, T in json.loads(sys.argv[1]):
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
        cfg = get_arch(arch).smoke.replace(dtype=jnp.float32)
        opt = make_optimizer("adamw", schedules.constant_schedule(1e-3))
        specs = {k: jax.ShapeDtypeStruct((rows, T), jnp.int32) for k in ("tokens", "labels")}
        step, (state_specs, b_specs) = make_spmd_train_step(cfg, mesh, specs, opt, num_microbatches=M,
                                                            strategy=strategy)
        with jax.set_mesh(mesh):
            a = analyze_hlo(step.lower(state_specs, b_specs).compile().as_text())
        out[cid] = {"flops": a.flops, "counts": a.collective_counts, "bytes": a.collective_bytes_by_kind}
    print("RESULT" + json.dumps(out))
    """
)
#: the cases held to repro's analyze_hlo
FLOP_CASES = ["qwen-tp_fsdp", "qwen-zero3"]


@pytest.fixture(scope="module")
def repro_flops():
    """``repro``'s analyze_hlo of its compiled step, in a subprocess started
    before the ranks (it compiles while they run); calling the value waits."""
    cases = [[cid, arch, strategy, m, rows, T] for cid, arch, strategy, m, rows in TRAIN if cid in FLOP_CASES]
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REPRO_SCRIPT, json.dumps(cases)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    @functools.lru_cache
    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        return json.loads(next(line for line in out.splitlines() if line.startswith("RESULT"))[6:])

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(repro_flops):
    """Per mesh, every rank's real and dry results (and, on (2, 2), the
    stateless runtime's)."""
    train = [_train_case(arch, strategy, m, rows, i) for i, (_, arch, strategy, m, rows) in enumerate(TRAIN)]
    serve = [_serve_case(arch, rows, t, kv, i) for i, (_, arch, rows, t, kv) in enumerate(SERVE)]
    runtime = dict(cfg=_cfg("qwen1.5-4b").replace(num_layers=8), global_batch=8, seq_len=8, plans=_tables(),
                   x=np.arange(3.0))
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:  # both worlds at once
        futures = {name: pool.submit(ranks.spawn, rank_checks.dry_vs_recorded, 4,
                                     args=(train, serve, runtime if name == "2x2" else None), device="cpu",
                                     timeout=600, axes={"data": data, "model": model})
                   for name, (data, model) in MESHES.items()}
        return {name: f.result() for name, f in futures.items()}


def _pairs(per_rank, cid):
    """Per rank: (the real run's collectives and argument bytes, the dry
    run's), for the case ``cid`` (a serve case: the prefill's, then the
    decode step's)."""
    out = []
    for r in per_rank:
        (real_t, real_s), (dry_t, dry_s) = r["real"], r["dry"]
        if cid in [c[0] for c in TRAIN]:
            i = [c[0] for c in TRAIN].index(cid)
            out.append(([real_t[i]["collectives"]], [real_t[i]["argument_bytes"]],
                        [dry_t[i]["collectives"]], [dry_t[i]["argument_bytes"]]))
        else:
            i = [c[0] for c in SERVE].index(cid)
            out.append((real_s[i]["collectives"], real_s[i]["argument_bytes"],
                        dry_s[i]["collectives"], dry_s[i]["argument_bytes"]))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cid", CASE_IDS)
def test_dry_run_collectives_equal_the_recorded_ranks(world, mesh, cid):
    for rank, (real, real_args, dry, dry_args) in enumerate(_pairs(world[mesh], cid)):
        assert len(real) == len(dry)
        for got, want in zip(real, dry):
            assert got, (rank, "a sharded program with no collective")
            assert [tuple(e) for e in got] == [tuple(e) for e in want], rank
        assert real_args == dry_args, rank


def _rank0_dry_flops(world, cid):
    return world["2x2"][0]["dry"][0][[c[0] for c in TRAIN].index(cid)]["flops"]


def _attention_recompute(cid) -> float:
    """The named gap: the K1 backward's recompute of the plain attention
    forward, once a layer and micro-batch, at the rank's rows and heads."""
    _, arch, strategy, m, rows = TRAIN[[c[0] for c in TRAIN].index(cid)]
    cfg = _cfg(arch)
    hd = cfg.d_model // cfg.num_heads
    b = rows // m // (4 if strategy == "zero3" else 2)  # zero3 splits rows over both axes, tp_fsdp over "data"
    heads = cfg.num_heads // (1 if strategy == "zero3" else 2)  # tp_fsdp: the rank's heads over "model"
    return m * cfg.num_layers * flash_ref.train_attention_flops(b, T, T, heads, hd)


@pytest.mark.parametrize("cid", FLOP_CASES)
def test_dry_run_flops_match_repro_analyze_hlo(world, repro_flops, cid):
    got, want = _rank0_dry_flops(world, cid), repro_flops()[cid]["flops"]
    assert got == want + _attention_recompute(cid)
    assert abs(got - want) <= 0.02 * want


def test_every_rank_counts_the_same_flops(world):
    for cid in FLOP_CASES:
        i = [c[0] for c in TRAIN].index(cid)
        assert len({r["dry"][0][i]["flops"] for r in world["2x2"]}) == 1


def test_zero3_gather_and_reduce_scatter_bytes_follow_the_sharding_rules(world):
    """Per micro-batch each sharded leaf is all-gathered at each use (a
    layer's twice: the forward and the per-layer remat's replay) and its
    gradient reduce-scattered once; per sharded dim of ``g`` ranks the
    all-gather puts ``(g - 1) x`` its operand on the wire, the
    reduce-scatter ``(g - 1) x`` its fp32 result (rank 2 of the (2, 2)
    world's dry run of qwen's zero3 case)."""
    cfg = _cfg("qwen1.5-4b")
    batch = {k: torch.zeros((B, T), dtype=torch.long) for k in ("tokens", "labels")}
    mesh = dryrun.dry_mesh({"data": 2, "model": 2}, {"data": 1, "model": 0})
    log = world["2x2"][2]["dry"][0][[c[0] for c in TRAIN].index("qwen-zero3")]["collectives"]
    by_kind = hlo_analysis.analyze([CollectiveEntry(*e) for e in log]).collective_bytes_by_kind
    step, (state_specs, _) = make_spmd_train_step(cfg, mesh, batch, make_optimizer("adamw"), num_microbatches=M,
                                                  strategy="zero3", device="cpu")
    ag = rs = 0.0
    for path, t in flatten(state_specs.params).items():
        spec = step.specs[path]
        shape = list(t.shape)
        named = [(d, spec_axes(spec[d])) for d in range(len(spec)) if spec_axes(spec[d])]
        for d, axes in named:
            shape[d] //= math.prod(mesh.shape[a] for a in axes)
        uses = M * (2 if path.startswith("layers/") else 1)
        x = list(shape)
        for d, axes in named:
            g = math.prod(mesh.shape[a] for a in axes)
            ag += uses * (g - 1) * math.prod(x) * step._dtype[path].itemsize
            x[d] *= g
            rs += M * (g - 1) * math.prod(shape) * 4
    assert by_kind["all-gather"] == ag and by_kind["reduce-scatter"] == rs


def test_roofline_terms_are_repros_formula():
    for flops, hbm, wire in ((1e12, 2e9, 3e8), (5.0, 7e12, 0.0), (0.0, 0.0, 9e9)):
        peaks = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)
        assert hlo_analysis.roofline_terms(flops, hbm, wire, **peaks) == jax_hlo.roofline_terms(flops, hbm, wire,
                                                                                                **peaks)
        # by default the peaks are specs/h100-sxm.json's, at the compute dtype's peak
        h100 = hlo_analysis.roofline_terms(flops, hbm, wire)
        assert h100 == jax_hlo.roofline_terms(flops, hbm, wire, **peaks)
        assert hlo_analysis.roofline_terms(flops, hbm, wire, dtype="f32")["compute_s"] == flops / 67e12


def test_recorder_prices_each_kind_by_the_ring_rules():
    group = CollectiveRecorder(DryGroup.at({"data": 2, "model": 4}, {"data": 1, "model": 2}))
    x = torch.zeros((8, 6), dtype=torch.bfloat16)
    assert group.all_gather_over(x, ("model",), dim=1).shape == (8, 24)
    assert group.reduce_scatter_over(x, ("data", "model"), dim=0, dtype=torch.float32).shape == (1, 6)
    assert group.reduce_scatter_over(x, ("data", "model"), dim=0, dtype=torch.float32).dtype == torch.float32
    assert group.all_reduce_over(x, ("data",)) is x
    assert group.all_gather_over(x, (), dim=0) is x  # a group of one: no collective, not logged
    log = group.take_log()
    assert [e.kind for e in log] == ["all-gather", "reduce-scatter", "reduce-scatter", "all-reduce"]
    nbytes = 8 * 6 * 2
    assert log[0].wire_bytes == (4 - 1) / 4 * (4 * nbytes)  # (g-1)/g of the result
    assert log[1].wire_bytes == (8 - 1) * (8 * 6 * 4 / 8)  # (g-1) x the fp32 result
    assert log[3].wire_bytes == 2 * (2 - 1) / 2 * nbytes  # 2 (g-1)/g of the result
    ana = hlo_analysis.analyze(log)
    assert ana.wire_bytes == sum(e.wire_bytes for e in log)
    assert ana.collective_counts == {"all-gather": 1, "reduce-scatter": 2, "all-reduce": 1}
    send = CollectiveEntry("collective-permute", ("stage",), 2, (2, 3), "float32", peer=1)
    assert send.wire_bytes == 24 and CollectiveEntry("recv", ("stage",), 2, (2, 3), "float32").wire_bytes == 0


def test_production_pair_at_cut_depth_through_main(tmp_path):
    """qwen2.5-14b's decode_32k at 2 layers on the 16 x 16 mesh, rank 17
    (data 1, model 1): repro's record keys, finite positive counts; the
    arguments are the rank's shards of the weights and of the cache."""
    assert dryrun.main(["--arch", "qwen2.5-14b", "--shape", "decode_32k", "--num-layers", "2", "--coords", "17",
                        "--out", str(tmp_path)]) == 0
    (path,) = tmp_path.iterdir()
    rec = json.loads(path.read_text())
    for key in ("flops_per_device", "bytes_accessed_per_device", "collective_wire_bytes_per_device",
                "collective_counts", "collective_bytes_by_kind", "dot_count", "memory", "roofline",
                "model_flops_total", "model_flops_per_device", "useful_flops_fraction", "chips"):
        assert key in rec, key
    assert rec["chips"] == 256 and rec["coords"] == {"data": 1, "model": 1}
    assert rec["flops_per_device"] > 0 and rec["collective_wire_bytes_per_device"] > 0
    assert 0 < rec["memory"]["argument_bytes"] <= rec["memory"]["peak_bytes"]
    assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")


def test_stateless_spmd_runtime_equals_the_reference_backend(world):
    cfg = _cfg("qwen1.5-4b").replace(num_layers=8)

    def factory(table):
        return lambda t: t * float(table.plan.num_microbatches) * 4  # the four ranks' sum

    ref = PlanRuntime(cfg, 4, None, 8, 8, program_factory=factory, device="cpu")
    want_out, want_ev = [], []
    for table in _tables():
        ev = ref.switch_to(table)
        want_ev.append((ev.to_plan, ev.from_plan, ev.restacked, ev.warm, ref.current_v))
        want_out.append(ref.run_program(torch.arange(3.0))[0].numpy())
    ref.cache.shutdown()
    for rank, r in enumerate(world["2x2"]):
        got = r["runtime"]
        assert got["state"] is None and "run_program" in got["refused"]
        assert [(e["to_plan"], e["from_plan"], e["restacked"], e["warm"], e["v"]) for e in got["events"]] == want_ev
        want_ranks = [{"rank": i} for i in range(4)] if rank == 0 else None  # gathered to rank 0
        assert [e["ranks"] for e in got["events"]] == [want_ranks] * len(want_ev)
        assert [e["placement"] for e in got["events"]] == [t.plan.placement.vstage_of.tolist() for t in _tables()]
        for o, w in zip(got["outputs"], want_out):
            np.testing.assert_array_equal(o, w)


def test_dry_group_moves_nothing_and_refuses_objects():
    g = DryGroup.at({"data": 2, "model": 2}, {"data": 1, "model": 1})
    assert (g.rank, g.s, g.S, g.D) == (3, 3, 4, 1)
    (r,) = g.exchange([(torch.ones(2), 1, 0)], [((2, 5), torch.bfloat16, 1, 1)])
    assert r.wait().shape == (2, 5) and r.wait().dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="no objects"):
        g.broadcast_object(1)
    with pytest.raises(ValueError, match="unknown mesh axes"):
        g.all_reduce_over(torch.ones(1), ("pod",))
    assert dataclasses.is_dataclass(g)
