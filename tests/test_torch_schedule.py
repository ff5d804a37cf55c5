"""The port's copy of the schedule layer against ``repro``'s.

``repro_torch.core.schedule`` and ``repro_torch.core.kinds`` are copies of
``repro.core.schedule`` and ``repro.core.kinds`` (the port imports nothing of
``repro``).  Every plan the port's pipeline engine can run is built by both
packages from the same coordinates and compared exactly
(``np.array_equal``): the lowered grid, the tasks' slots, the peak live
activations, the edges, and the engine's static tables (arrivals, queue
capacities, channels, placement).  The cases are copies of the engine
parity lists of ``tests/test_pipeline_engine.py`` plus a sweep of
(S, M, k), and the gates below hold the copied lists to the port's
registry, as that file's gates hold the originals to ``repro``'s.
"""

import os
import re

import numpy as np
import pytest

from repro.core import kinds as jkinds
from repro.core import schedule as jsched
from repro.pipeline import engine as jengine
from repro_torch.core import kinds, schedule
from repro_torch.pipeline import engine

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

#: copies of tests/test_pipeline_engine.py's executor-proof lists (held
#: equal to the originals below); each row also runs through the port's
#: engine in tests/test_torch_pipeline.py
FAMILY_PARITY_CASES = [
    ("kfkb", 1, 1, 0),
    ("kfkb", 2, 1, 0),
    ("zb_h1", 1, 1, 0),
    ("zb_h1", 2, 1, 0),
    ("zb_h2", 1, 1, 1),
    ("zb_h2", 2, 1, 2),
    ("zb_h2", 1, 1, (2, 1)),
    ("interleaved", 2, 2, 0),
    ("interleaved_zb", 1, 2, 0),
    ("interleaved_zb", 2, 2, 0),
    ("interleaved_zb", 1, 2, (1, 2)),
    ("zbv", 1, 2, 0),
    ("zbv", 2, 2, 0),
    ("zbv", 1, 2, (1, 0)),
]
SAVED_RESIDUAL_PARITY_CASES = [
    ("zb_h1", 1, 1, 0, "saved_residual"),
    ("zb_h1", 2, 1, 0, ("saved_residual", "double_remat")),
    ("zb_h2", 1, 1, (2, 1), "saved_residual"),
    ("interleaved_zb", 1, 2, 0, "saved_residual"),
    ("zbv", 1, 2, 0, "saved_residual"),
]
#: the parity lists' pipeline shape
PARITY_S, PARITY_M = 2, 4

#: (kind, S, M, k, v, w): every kind over deeper pipelines, more
#: micro-batches and group sizes that do and do not divide M
SWEEP = [
    ("kfkb", S, M, k, 1, 0)
    for S, M in ((2, 4), (3, 6), (4, 8), (4, 12))
    for k in (1, 2, 3, 4)
    if k <= M
] + [
    ("zb_h1", 4, 8, 1, 1, 0),
    ("zb_h1", 4, 12, 3, 1, 0),
    ("zb_h2", 4, 8, 2, 1, 2),
    ("zb_h2", 3, 9, 1, 1, (1, 2, 0)),
    ("interleaved", 4, 8, 1, 2, 0),
    ("interleaved", 4, 16, 2, 2, 0),
    ("interleaved", 2, 8, 2, 3, 0),
    ("interleaved_zb", 4, 8, 1, 2, 1),
    ("interleaved_zb", 3, 12, 2, 2, 0),
    ("zbv", 4, 8, 1, 2, 0),
    ("zbv", 3, 6, 2, 2, 1),
]


def _specs():
    """(id, spec kwargs, S, M) of every parity row and every sweep case."""
    out = [
        (f"parity-{kind}-k{k}-v{v}-w{w}", dict(kind=kind, k=k, num_virtual=v, extra_warmup=w), PARITY_S, PARITY_M)
        for kind, k, v, w in FAMILY_PARITY_CASES
    ]
    out += [
        (f"sr-{kind}-k{k}-v{v}-w{w}-{pol}", dict(kind=kind, k=k, num_virtual=v, extra_warmup=w, zb_policy=pol),
         PARITY_S, PARITY_M)
        for kind, k, v, w, pol in SAVED_RESIDUAL_PARITY_CASES
    ]
    out += [
        (f"sweep-{kind}-S{S}-M{M}-k{k}-v{v}-w{w}", dict(kind=kind, k=k, num_virtual=v, extra_warmup=w), S, M)
        for kind, S, M, k, v, w in SWEEP
    ]
    return out


SPECS = _specs()


def _plans(kw, S, M):
    return (
        schedule.make_plan(S, M, spec=kinds.ScheduleSpec(**kw)),
        jsched.make_plan(S, M, spec=jkinds.ScheduleSpec(**kw)),
    )


def _tasks(plan):
    return [[(int(t.op), t.stage, t.mb, t.chunk, t.slot) for t in order] for order in plan.orders]


def _edges(table):
    return [
        (e.src_stage, e.dst_stage, int(e.op), e.mb, e.src_chunk, e.dst_chunk, e.send_tick, e.recv_tick)
        for e in table.edges
    ]


@pytest.mark.parametrize("kw,S,M", [s[1:] for s in SPECS], ids=[s[0] for s in SPECS])
def test_plan_and_lowering_equal_reference(kw, S, M):
    ours, theirs = _plans(kw, S, M)
    assert ours.name == theirs.name
    assert (ours.kind, ours.k, ours.num_virtual) == (theirs.kind, theirs.k, theirs.num_virtual)
    assert ours.extra_warmup == theirs.extra_warmup and ours.zb_policy == theirs.zb_policy
    assert _tasks(ours) == _tasks(theirs)  # order and slot of every task
    assert schedule.assign_slots(ours) == jsched.assign_slots(theirs)
    assert schedule.peak_live_activations(ours) == jsched.peak_live_activations(theirs)
    t_ours, t_theirs = ours.lower(), theirs.lower()
    assert np.array_equal(t_ours.grid, t_theirs.grid)
    assert _edges(t_ours) == _edges(t_theirs)
    t_ours.validate()
    assert np.array_equal(schedule.tick_table(ours), jsched.tick_table(theirs))
    pl, jpl = ours.placement, theirs.placement
    for name in ("vstage_of", "device_of", "chunk_of"):
        assert np.array_equal(getattr(pl, name), getattr(jpl, name)), name
    assert pl.is_looped == jpl.is_looped


@pytest.mark.parametrize("kw,S,M", [s[1:] for s in SPECS], ids=[s[0] for s in SPECS])
def test_engine_tables_equal_reference(kw, S, M):
    ours, theirs = _plans(kw, S, M)
    grid, v = ours.lower().grid, ours.num_virtual
    for a, b in zip(engine.arrival_tables(grid, v), jengine.arrival_tables(theirs.lower().grid, v)):
        assert np.array_equal(a, b)
    assert engine.queue_capacities(grid, v) == jengine.queue_capacities(theirs.lower().grid, v)
    assert np.array_equal(engine._placement_perm(ours), jengine._placement_perm(theirs))
    got = engine._channel_tables(ours, grid)
    want = jengine._channel_tables(theirs, theirs.lower().grid)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_registry_equals_reference():
    assert kinds.registered_kinds() == jkinds.registered_kinds()
    assert kinds.known_kinds() == jkinds.known_kinds()
    assert kinds.warmup_kinds() == jkinds.warmup_kinds()
    assert kinds.saved_residual_kinds() == jkinds.saved_residual_kinds()
    flags = ("supports_virtual", "fixed_virtual", "supports_extra_warmup", "requires_warmup",
             "has_split_backward", "supports_saved_residual", "peak_is_exact")
    for name in kinds.registered_kinds():
        ours, theirs = kinds.get_kind(name), jkinds.get_kind(name)
        for flag in flags:
            assert getattr(ours, flag) == getattr(theirs, flag), (name, flag)
        for G, v, w in ((1, 1, (0, 0)), (4, 2, (1, 0)), (8, 2, (2, 3))):
            assert ours.peak_live_groups(2, G, v, w) == theirs.peak_live_groups(2, G, v, w), name


def test_case_lists_are_copies_of_the_engine_parity_lists():
    import test_pipeline_engine as original

    assert FAMILY_PARITY_CASES == original.FAMILY_PARITY_CASES
    assert SAVED_RESIDUAL_PARITY_CASES == original.SAVED_RESIDUAL_PARITY_CASES


def test_every_port_kind_has_an_executor_proof():
    """Gate, derived from the port's registry: every kind has a parity row,
    and every warmup-capable kind a row with a non-uniform w[s]."""
    assert {kind for kind, *_ in FAMILY_PARITY_CASES} == set(kinds.registered_kinds())
    vector_proofs = {
        kind for kind, _, _, w in FAMILY_PARITY_CASES if isinstance(w, tuple) and len(set(w)) > 1
    }
    assert vector_proofs == set(kinds.warmup_kinds())
    assert {kind for kind, *_ in SWEEP} == set(kinds.registered_kinds())


def test_every_port_saved_residual_kind_has_an_executor_proof():
    assert {kind for kind, *_ in SAVED_RESIDUAL_PARITY_CASES} == set(kinds.saved_residual_kinds())
    mixed = [pol for *_, pol in SAVED_RESIDUAL_PARITY_CASES if isinstance(pol, tuple) and len(set(pol)) > 1]
    assert mixed, "the per-stage DR/SR selection path needs a mixed-vector proof"


BAD_SPECS = [
    (dict(kind="nope"), "unknown schedule kind"),
    (dict(kind="zb_h1", num_virtual=2), "interleaved kind"),
    (dict(kind="zbv", num_virtual=3), "exactly 2 chunks"),
    (dict(kind="kfkb", extra_warmup=1), "warmup-capable"),
    (dict(kind="zb_h2"), "extra_warmup >= 1"),
    (dict(kind="kfkb", zb_policy="saved_residual"), "saved_residual"),
    (dict(kind="zb_h1", zb_policy="sometimes"), "unknown zb_policy"),
    (dict(kind="zb_h1", extra_warmup=(1, 2, 3)), "one entry per stage"),
]


@pytest.mark.parametrize("kw,match", BAD_SPECS, ids=[f"{kw['kind']}-{m.split()[0]}" for kw, m in BAD_SPECS])
def test_bad_coordinates_fail_as_in_reference(kw, match):
    for mod_sched, mod_kinds in ((schedule, kinds), (jsched, jkinds)):
        with pytest.raises(ValueError, match=match):
            mod_sched.make_plan(2, 4, spec=mod_kinds.ScheduleSpec(**kw))


def test_aliases_resolve_as_in_reference():
    for alias in ("1f1b", "gpipe"):
        ours, theirs = _plans(dict(kind=alias), 3, 6)
        assert (ours.kind, ours.k, ours.name) == (theirs.kind, theirs.k, theirs.name)
        assert np.array_equal(ours.lower().grid, theirs.lower().grid)


# -- the port-side copy of tests/test_spec_api.py's kind-dispatch scan ---------------

_PKG = os.path.join(_REPO, "src", "repro_torch")
_ALLOWED = {os.path.join("core", "kinds.py"), os.path.join("core", "schedule.py")}
_DISPATCH = [
    re.compile(
        r"kind\s*(?:==|!=)\s*[\"']"
        r"(?:kfkb|zb_h1|zb_h2|interleaved|interleaved_zb|zbv|1f1b|gpipe)[\"']"
    ),
    re.compile(r"kind\s+(?:not\s+)?in\s+\("),
    re.compile(
        r"kind\s+(?:not\s+)?in\s+"
        r"(?:PLAN_KINDS|ZB_KINDS|INTERLEAVED_KINDS|WARMUP_KINDS)"
    ),
]


def test_no_kind_string_dispatch_outside_the_port_registry():
    """Every schedule-kind decision in the port outside its registry and
    schedule module goes through KindSpec capability flags."""
    offenders = []
    for root, _, files in os.walk(_PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, _PKG)
            if rel in _ALLOWED:
                continue
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if any(p.search(line) for p in _DISPATCH):
                        offenders.append(f"{rel}:{i}: {line.strip()}")
    assert os.path.exists(os.path.join(_PKG, "core", "kinds.py"))
    assert not offenders, "schedule-kind string dispatch outside core/kinds.py + core/schedule.py:\n" + "\n".join(offenders)
