"""ASCII rendering of schedule plans and simulator timelines.

Port of ``repro/core/viz.py`` (its copy, on the port's schedule and
simulator; ``tests/test_torch_viz.py`` holds the strings equal).

Two views, both matching the paper's figures:

* :func:`render_tick_table` — the zero-comm lock-step layout (Fig 2's
  idealized grids) of ANY family member: one row per device, one column
  per tick.  ``F``/``B`` cells are tagged with the micro-batch index
  (mod 10); zero-bubble weight-gradient fillers render as ``W`` (both the
  H1 and H2 depths, and the chunked ``interleaved_zb`` fillers); for
  interleaved plans every cell carries a chunk suffix (``F3b`` = forward
  of micro-batch 3 on the device's second chunk); ``.`` marks bubbles.
* :func:`render_sim_timeline` — the discrete-event simulator's actual task
  intervals under a network trace, quantized to a character raster; shows
  where preemption stretches the pipeline (Fig 2's preempted rows).
"""

from __future__ import annotations

from repro_torch.core.schedule import Op, SchedulePlan
from repro_torch.core.simulator import SimResult
from repro_torch.core.taskgraph import TaskGraph

__all__ = ["render_tick_table", "render_sim_timeline"]

_OP_SYMBOL = {
    int(Op.FWD): "F",
    int(Op.BWD): "B",
    int(Op.BWD_INPUT): "B",  # the critical backward half keeps the paper's "B"
    int(Op.BWD_WEIGHT): "W",
}


def render_tick_table(plan: SchedulePlan) -> str:
    """E.g. 1F1B, S=2, M=4::

        stage 0 |F0 F1 B0 F2 B1 F3 B2 .. B3|
        stage 1 |.. F0 B0 F1 B1 F2 B2 F3 B3|
    """
    table = plan.lower()
    S, T = table.num_stages, table.num_ticks
    chunked = plan.num_virtual > 1
    idle = "..." if chunked else ".."
    rows = []
    for s in range(S):
        cells = []
        for t in range(T):
            op, mb, chunk, _ = (int(v) for v in table.grid[s, t])
            if op == int(Op.IDLE):
                cells.append(idle)
            else:
                cell = f"{_OP_SYMBOL[op]}{mb % 10}"
                if chunked:
                    cell += chr(ord("a") + chunk)
                cells.append(cell)
        rows.append(f"stage {s} |" + " ".join(cells) + "|")
    header = f"{plan.name}: S={S} M={plan.num_microbatches} ({T} ticks)"
    return "\n".join([header] + rows)


def render_sim_timeline(
    graph: TaskGraph, result: SimResult, width: int = 100
) -> str:
    """Character raster of the simulated execution (one row per stage)."""
    S = graph.num_stages
    end = result.pipeline_length
    scale = width / max(end, 1e-12)
    rows = []
    for s in range(S):
        row = ["."] * width
        for task in graph.plan.orders[s]:
            fin = result.task_finish[task.key()]
            dur = graph.task_time(task)
            a = int((fin - dur) * scale)
            b = max(int(fin * scale), a + 1)
            ch = _OP_SYMBOL.get(int(task.op), "?")
            for i in range(a, min(b, width)):
                row[i] = ch
        busy = result.busy_time[s] / end
        rows.append(f"stage {s} |{''.join(row)}| busy {busy:5.1%}")
    rows.append(f"{'':8s} 0{'.' * (width - 10)}{end:8.2f}s")
    return "\n".join(rows)
