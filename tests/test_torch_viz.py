"""``repro_torch.core.viz`` prints ``repro``'s strings.

``tests/test_viz.py``'s cases run on the port, and each rendering is held
equal, character for character, to ``repro.core.viz``'s on the same plan
(the tick tables of every schedule kind, interleaved chunk suffixes and
zero-bubble ``W`` cells included) and on the same simulated run.
"""

import pytest

import repro.core as J
from repro.core.simulator import PipelineSimulator as JaxSimulator
from repro.core.taskgraph import build_task_graph as jax_build_task_graph
from repro.core.viz import render_sim_timeline as jax_timeline
from repro.core.viz import render_tick_table as jax_tick_table
from repro_torch.core import ScheduleSpec, StableTrace, StageCosts, make_plan, uniform_network
from repro_torch.core.simulator import PipelineSimulator
from repro_torch.core.taskgraph import build_task_graph
from repro_torch.core.viz import render_sim_timeline, render_tick_table

#: (S, M, spec fields): every kind, with the chunked and zero-bubble cells
PLANS = [
    (2, 4, dict(kind="kfkb", k=1)),
    (2, 4, dict(kind="kfkb", k=2)),
    (4, 8, dict(kind="kfkb", k=2)),
    (4, 8, dict(kind="zb_h1")),
    (4, 8, dict(kind="zb_h2", extra_warmup=2)),
    (4, 8, dict(kind="interleaved", num_virtual=2)),
    (4, 8, dict(kind="interleaved_zb", num_virtual=2)),
    (4, 8, dict(kind="zbv", num_virtual=2)),
    (4, 12, dict(kind="kfkb", k=3)),
]


def _both(S, M, fields):
    return make_plan(S, M, spec=ScheduleSpec(**fields)), J.make_plan(S, M, spec=J.ScheduleSpec(**fields))


def test_render_1f1b_shape():
    out = render_tick_table(make_plan(2, 4, spec=ScheduleSpec(kind="kfkb", k=1)))
    lines = out.splitlines()
    assert lines[0].startswith("1F1B")
    assert len(lines) == 3
    cells = lines[2].split("|")[1].split()
    nonidle = [c for c in cells if c != ".."]
    assert [c[0] for c in nonidle] == ["F", "B"] * 4


def test_render_kfkb_grouping_visible():
    out = render_tick_table(make_plan(2, 4, spec=ScheduleSpec(kind="kfkb", k=2)))
    cells = out.splitlines()[2].split("|")[1].split()
    nonidle = [c[0] for c in cells if c != ".."]
    assert nonidle == ["F", "F", "B", "B"] * 2


@pytest.mark.parametrize("S, M, fields", PLANS, ids=[f"{f['kind']}-S{S}-M{M}" for S, M, f in PLANS])
def test_tick_table_equals_repros(S, M, fields):
    plan, jplan = _both(S, M, fields)
    assert render_tick_table(plan) == jax_tick_table(jplan)


@pytest.mark.parametrize("width", [80, 37])
@pytest.mark.parametrize("S, M, fields", PLANS[1:4], ids=["kfkb2-S2", "kfkb2-S4", "zb_h1-S4"])
def test_sim_timeline_equals_repros(S, M, fields, width):
    plan, jplan = _both(S, M, fields)
    costs = StageCosts.uniform(S, 1.0, act_bytes=1.0)
    graph = build_task_graph(plan, costs)
    res = PipelineSimulator(graph, uniform_network(S, lambda: StableTrace(2.0))).run()
    jgraph = jax_build_task_graph(jplan, J.StageCosts.uniform(S, 1.0, act_bytes=1.0))
    jres = JaxSimulator(jgraph, J.uniform_network(S, lambda: J.StableTrace(2.0))).run()
    out = render_sim_timeline(graph, res, width=width)
    assert out == jax_timeline(jgraph, jres, width=width)
    lines = out.splitlines()
    assert len(lines) == S + 1 and all("busy" in line for line in lines[:S])
    assert "F" in lines[0] and "B" in lines[0]
