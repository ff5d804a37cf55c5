"""The engine dry run (``repro_torch.launch.dryrun_pipeline.run``) against
the plan's channel tables and against ``repro``'s ``run()``.

The port's multi-rank engine posts a send only where the plan's send
tables name one, so a rank's point-to-point count is its row of the tables
(DOWN and UP, both payload kinds; LOOP stays in the process) and each send
carries one micro-batch's activation or gradient, ``b/D * T * d`` in
``cfg.dtype``; its receives are its row of the arrival tables.  ``repro``'s
``shard_map`` engine permutes on each used ring channel at every tick (a
tick with nothing to send moves zeros), less the permutes whose results no
later tick reads, which JAX drops when it traces the step: so its count is
at most ``ticks x used channels``, each permute the same ``b/D * T * d``.
Each side is held to its own form, at S = 4, D = 2 (``repro`` on 8 CPU
host devices in a subprocess, its ``_config`` set to the same smoke config),
and the two records share the tick count and the unit-cost bubble.  The
port's all-reduces are the replicated leaves' and the loss's sums over the
stages and, with D > 1, the mean of every gradient and the loss over the
replicas.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.schedule import make_plan
from repro_torch.launch import dryrun_pipeline
from repro_torch.pipeline import engine as E
from repro_torch.pipeline.stage import StagedModel
from repro_torch.tree import flatten

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH, S, D, M, K, BATCH, SEQ, LAYERS = "qwen1.5-4b", 4, 2, 2, 2, 4, 32, 4

_REPRO_SCRIPT = textwrap.dedent(
    """
    import json, os, sys, tempfile
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from repro.configs import get_arch
    from repro.launch import dryrun_pipeline as jdry
    arch, S, M, k, batch, seq, L = json.loads(sys.argv[1])
    cfg = get_arch(arch).smoke.replace(dtype=jnp.float32, num_layers=L)
    jdry._config = lambda name: cfg
    assert jax.device_count() == 8
    rec = jdry.run(arch, S, M, k, batch, seq, tempfile.mkdtemp())
    print("RECORD" + json.dumps(rec, default=str))
    """
)


@pytest.fixture(scope="module")
def repro_record():
    env = {**os.environ, "PYTHONPATH": os.path.join(_REPO, "src"), "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REPRO_SCRIPT, json.dumps([ARCH, S, M, K, BATCH, SEQ, LAYERS])],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _record_of(proc) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(next(line for line in out.splitlines() if line.startswith("RECORD"))[6:])


def _cfg():
    return get_arch(ARCH).smoke.replace(dtype=torch.float32, num_layers=LAYERS)


@pytest.fixture(scope="module")
def port(repro_record, tmp_path_factory):
    """The port's record at every stage of replica 0 and at stage 1 of
    replica 1, its ``_config`` set to the smoke config as ``repro``'s is;
    D is run's default (``256 // S`` cut to divide the micro-batch's rows)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dryrun_pipeline, "_config", lambda name: _cfg())
        for s, d in [(0, 0), (1, 0), (2, 0), (3, 0), (1, 1)]:
            out[s, d] = dryrun_pipeline.run(ARCH, S, M, K, BATCH, SEQ, str(tmp_path_factory.mktemp("dp")),
                                            stage=s, replica=d)
    return out


def _tables():
    plan = make_plan(S, M, K)
    return plan, E._channel_tables(plan, plan.lower().grid)


def _payload_bytes() -> int:
    return BATCH // M // D * SEQ * _cfg().d_model * 4


@pytest.mark.parametrize("rank", [(0, 0), (1, 0), (2, 0), (3, 0), (1, 1)], ids=lambda r: f"s{r[0]}d{r[1]}")
def test_p2p_equals_the_channel_tables(port, rank):
    _, (send_f, send_b, arr_f, arr_b, *_) = _tables()
    s = rank[0]
    rings = (E._CH_DOWN, E._CH_UP)
    sends = sum(int(t[ch, s].sum()) for t in (send_f, send_b) for ch in rings)
    recvs = sum(int(t[ch, s].sum()) for t in (arr_f, arr_b) for ch in rings)
    rec = port[rank]
    assert rec["data"] == D
    assert rec["p2p_sends"] == rec["collective_counts"]["collective-permute"] == sends > 0
    assert rec["p2p_recvs"] == recvs
    assert rec["p2p_wire_bytes"] == rec["collective_bytes_by_kind"]["collective-permute"] == sends * _payload_bytes()


def test_all_reduces_are_the_replicated_leaves_the_loss_and_the_replica_mean(port):
    staged = StagedModel.build(_cfg(), S)
    leaves = flatten(staged.init_stages(torch.Generator().manual_seed(0), [0])[0])
    replicated = sum(k.split("/")[0] in E.REPLICATED for k in leaves)
    for rec in port.values():
        assert rec["collective_counts"]["all-reduce"] == replicated + 1 + len(leaves) + 1


def test_repro_permutes_every_tick_each_carrying_one_payload(repro_record, port):
    rec = _record_of(repro_record)
    plan, (send_f, send_b, *_) = _tables()
    used = sum(bool(t[ch].any()) for t in (send_f, send_b) for ch in (E._CH_DOWN, E._CH_UP))
    n = rec["collective_counts"]["collective-permute"]
    assert 0 < n <= rec["ticks"] * used
    assert rec["collective_bytes_by_kind"]["collective-permute"] == n * _payload_bytes()
    ours = port[0, 0]
    assert n > ours["p2p_sends"]  # the port sends only what the tables name
    assert (rec["ticks"], rec["unit_bubble_fraction"]) == (ours["ticks"], ours["unit_bubble_fraction"])
    assert (rec["plan"], rec["stages"], rec["microbatches"], rec["k"]) == (ours["plan"], S, M, K)
    assert set(rec) - {"lower_s", "compile_s"} <= set(ours)


def test_main_runs_the_engine_dry_run_with_repros_defaults(monkeypatch, tmp_path):
    """``main()`` without ``--calibrate`` is the engine dry run at ``repro``'s
    defaults (qwen2.5-14b, S 16, M 32, k 2, b 256, T 4096) on rank (0, 0);
    ``run`` itself is what the other tests hold."""
    seen = {}

    def spy(*args, **kw):
        seen.update(args=args, kw=kw)
        return "record"

    monkeypatch.setattr(dryrun_pipeline, "run", spy)
    assert dryrun_pipeline.main(["--out", str(tmp_path)]) == "record"
    assert seen["args"] == ("qwen2.5-14b", 16, 32, 2, 256, 4096, str(tmp_path))
    assert seen["kw"] == dict(num_layers=None, device_spec=None)
