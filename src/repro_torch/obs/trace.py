"""Deterministic trace spans -> Chrome/Perfetto trace-event JSON.

A copy of ``repro/obs/trace.py`` for the port: the standard library and
numpy only, nothing of ``repro``.  ``tests/test_torch_adaptive.py`` holds it
equal to the original on the same inputs.

The observe half of Ada-Grouper's observe-then-adapt loop needs a *timeline*
view, not just aggregate numbers: which host ran which plan when, how long a
warm switch actually took relative to the iteration around it, where a
barrier epoch's PREPARE and COMMIT landed, and — crucially — how the
simulator's *predicted* schedule lines up against what the engine *observed*.
This module is that currency:

* :class:`TraceRecorder` — a low-overhead span/instant recorder with an
  **injected monotonic clock** (tests drive a tick clock, making the whole
  export byte-identical run-to-run; production uses ``time.monotonic``).
  Events are appended as plain tuples; all formatting happens at export.
* **Tracks** — every event lives on a named track ``"segment/detail"``
  (``host0/iterations``, ``coordinator/barrier``, ``predicted/stage2``,
  ``predicted/link0->1``).  The segment becomes the Chrome ``pid``, the full
  track the ``tid``, so Perfetto groups one process row per host/side with
  one thread lane per stage/link.  Track ids are assigned in first-use
  order and exported as sorted metadata, so track layout is stable.
* :func:`render_simulated_trace` — runs the discrete-event simulator on a
  plan and emits its timeline (device task spans + per-transfer link spans)
  in the SAME format, so the predicted and observed schedules open
  side-by-side in one Perfetto window.
* :func:`validate_chrome_trace` / :func:`validate_no_overlap` — the schema
  and device-track sanity checks CI runs on committed golden fixtures
  (``python -m repro_torch.obs.trace --validate <files>``).

Timestamps are microseconds (Chrome's native unit) derived from the clock's
seconds; export is ``sort_keys`` + fixed separators JSON, so two recordings
of the same event sequence under the same injected clock are byte-identical.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable

__all__ = [
    "Span",
    "TraceRecorder",
    "quantize_sim_span",
    "render_simulated_trace",
    "merge_traces",
    "spans_by_track",
    "validate_chrome_trace",
    "validate_no_overlap",
    "TraceValidationError",
]

_US = 1e6  # seconds -> microseconds (Chrome's trace-event unit)


def quantize_sim_span(start_s: float, dur_s: float) -> tuple[float, float]:
    """Snap a simulated span onto the export grid so touching spans stay
    touching.

    The exporter rounds ``ts`` and ``dur`` to 3 decimals (of µs)
    independently, so two spans whose float endpoints coincide exactly can
    come out 0.001 µs overlapped — tripping :func:`validate_no_overlap`.
    Quantizing both endpoints first and deriving the duration from the
    quantized pair makes ``ts + dur`` land exactly on the successor's ``ts``
    whenever the un-quantized floats did.
    """
    start_us = round(start_s * _US, 3)
    end_us = round((start_s + dur_s) * _US, 3)
    return start_us / _US, max(0.0, end_us - start_us) / _US


class TraceValidationError(ValueError):
    """A trace payload violates the Chrome trace-event schema or a track
    invariant (overlapping device spans, unnamed events, ...)."""


@dataclasses.dataclass
class Span:
    """An open span handle; ``args`` may be extended until the span ends."""

    track: str
    name: str
    start_us: float
    args: dict

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self._recorder.end_span(self)

    _recorder: "TraceRecorder | None" = dataclasses.field(
        default=None, repr=False, compare=False
    )


class TraceRecorder:
    """Append-only span/instant/counter recorder with an injected clock.

    Thread-safe (one lock around the event list — the background precompile
    worker and the training thread may both record).  The recorder never
    formats during recording; :meth:`to_chrome_trace` does all the work.
    """

    def __init__(self, clock: Callable[[], float] | None = None) -> None:
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        # (track, name, phase, ts_us, dur_us, args) — phase "X" | "i" | "C"
        self._events: list[tuple[str, str, str, float, float, dict | None]] = []
        self._tracks: dict[str, int] = {}  # track -> tid, first-use order

    # -- recording ------------------------------------------------------------

    def _track_id(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def _now_us(self) -> float:
        return self.clock() * _US

    def span(self, track: str, name: str, **args) -> Span:
        """Open a span (use as a context manager or end with
        :meth:`end_span`); duration comes from the injected clock."""
        sp = Span(track=track, name=name, start_us=self._now_us(), args=args)
        sp._recorder = self
        return sp

    def end_span(self, sp: Span, **more_args) -> None:
        end = self._now_us()
        if more_args:
            sp.args.update(more_args)
        with self._lock:
            self._track_id(sp.track)
            self._events.append(
                (sp.track, sp.name, "X", sp.start_us, max(0.0, end - sp.start_us),
                 sp.args or None)
            )

    def add_span(
        self, track: str, name: str, start_s: float, dur_s: float, **args
    ) -> None:
        """Record a span with EXPLICIT timestamps (seconds) — how rendered
        (simulated) timelines enter the trace without touching the clock."""
        with self._lock:
            self._track_id(track)
            self._events.append(
                (track, name, "X", start_s * _US, max(0.0, dur_s * _US),
                 args or None)
            )

    def instant(self, track: str, name: str, **args) -> None:
        with self._lock:
            self._track_id(track)
            self._events.append((track, name, "i", self._now_us(), 0.0, args or None))

    def add_instant(self, track: str, name: str, ts_s: float, **args) -> None:
        """Instant with an EXPLICIT timestamp (seconds) — for marks on a
        rendered/simulated timeline (e.g. post-hoc tuner decisions at
        simulated time) rather than the live clock."""
        with self._lock:
            self._track_id(track)
            self._events.append((track, name, "i", ts_s * _US, 0.0, args or None))

    def counter(self, track: str, name: str, value: float) -> None:
        with self._lock:
            self._track_id(track)
            self._events.append(
                (track, name, "C", self._now_us(), 0.0, {"value": value})
            )

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export ---------------------------------------------------------------

    @staticmethod
    def _segment(track: str) -> str:
        return track.split("/", 1)[0]

    def to_chrome_trace(self) -> dict:
        """The Chrome trace-event JSON payload (load in Perfetto /
        ``chrome://tracing``).  Deterministic: metadata sorted by id, events
        in recording order, pids assigned per track segment."""
        with self._lock:
            events = list(self._events)
            tracks = dict(self._tracks)
        segments: dict[str, int] = {}
        for track in tracks:
            seg = self._segment(track)
            if seg not in segments:
                segments[seg] = len(segments) + 1
        out: list[dict] = []
        for seg, pid in sorted(segments.items(), key=lambda kv: kv[1]):
            out.append(
                {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "args": {"name": seg}}
            )
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            out.append(
                {"ph": "M", "name": "thread_name",
                 "pid": segments[self._segment(track)], "tid": tid,
                 "args": {"name": track}}
            )
        for track, name, ph, ts, dur, args in events:
            ev = {
                "ph": ph, "name": name,
                "pid": segments[self._segment(track)], "tid": tracks[track],
                "ts": round(ts, 3),
            }
            if ph == "X":
                ev["dur"] = round(dur, 3)
            if ph == "i":
                ev["s"] = "t"
            if args is not None:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Byte-stable serialization (sorted keys, fixed separators)."""
        return json.dumps(self.to_chrome_trace(), sort_keys=True,
                          separators=(",", ":"), default=str)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")


# ---------------------------------------------------------------------------
# Rendering the simulator's predicted timeline
# ---------------------------------------------------------------------------


def render_simulated_trace(
    plan,
    costs,
    network,
    recorder: TraceRecorder | None = None,
    prefix: str = "predicted",
):
    """Simulate ``plan`` under ``network`` and emit its timeline as trace
    spans: one track per device (``{prefix}/stage{s}``) holding every task's
    span, and one per directed link (``{prefix}/link{a}->{b}``) holding every
    transfer — the simulator's *predicted* schedule in the same format the
    live runtime records, so both open side-by-side in Perfetto.

    Returns ``(recorder, sim_result)``.
    """
    # local imports: obs stays importable without the core stack loaded,
    # and core modules may import obs without a cycle
    from repro_torch.core.simulator import simulate
    from repro_torch.core.taskgraph import build_task_graph

    graph = build_task_graph(plan, costs)
    result = simulate(graph, network)
    rec = recorder or TraceRecorder()
    for s, order in enumerate(plan.orders):
        track = f"{prefix}/stage{s}"
        for task in order:
            finish = result.task_finish[task.key()]
            dur = graph.task_time(task)
            name = f"{task.op.name} mb{task.mb}"
            if plan.num_virtual > 1:
                name += f" c{task.chunk}"
            rec.add_span(track, name, finish - dur, dur,
                         op=task.op.name, mb=task.mb, chunk=task.chunk)
    for (src, dst), xfers in sorted(result.link_events.items()):
        track = f"{prefix}/link{src}->{dst}"
        for start, finish, nbytes in xfers:
            rec.add_span(track, f"xfer {nbytes:g}B", start, finish - start,
                         nbytes=nbytes)
    return rec, result


def merge_traces(payloads: list[dict]) -> dict:
    """Merge several Chrome trace payloads into one (e.g. per-host worker
    traces + the coordinator's) by re-assigning disjoint pid/tid ranges per
    payload — every source track stays its own lane."""
    merged: list[dict] = []
    pid_off = tid_off = 0
    for payload in payloads:
        events = payload.get("traceEvents", [])
        max_pid = max((e.get("pid", 0) for e in events), default=0)
        max_tid = max((e.get("tid", 0) for e in events), default=0)
        for e in events:
            e = dict(e)
            e["pid"] = e.get("pid", 0) + pid_off
            if e.get("tid", 0) or e.get("ph") != "M":
                e["tid"] = e.get("tid", 0) + tid_off
            merged.append(e)
        pid_off += max_pid
        tid_off += max_tid
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Validation (CI schema check for golden fixtures + the overlap gate)
# ---------------------------------------------------------------------------

_REQUIRED = ("ph", "name", "pid", "tid")


def spans_by_track(payload: dict) -> dict[str, list[dict]]:
    """Group "X" span events under their thread_name track labels."""
    names: dict[tuple[int, int], str] = {}
    for e in payload.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            names[(e["pid"], e["tid"])] = e["args"]["name"]
    out: dict[str, list[dict]] = {}
    for e in payload.get("traceEvents", []):
        if e.get("ph") == "X":
            track = names.get((e["pid"], e["tid"]), f"pid{e['pid']}/tid{e['tid']}")
            out.setdefault(track, []).append(e)
    return out


def validate_chrome_trace(payload: dict) -> None:
    """Schema check: the payload must be loadable by Perfetto — a
    ``traceEvents`` list whose entries carry the required keys, spans with
    non-negative durations, and spans on one track either disjoint or
    properly nested (partial overlap renders as garbage)."""
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise TraceValidationError("payload must be a dict with 'traceEvents'")
    events = payload["traceEvents"]
    if not isinstance(events, list):
        raise TraceValidationError("'traceEvents' must be a list")
    for i, e in enumerate(events):
        for key in _REQUIRED:
            if key not in e:
                raise TraceValidationError(f"event {i} missing {key!r}: {e}")
        if e["ph"] in ("X", "i", "C") and "ts" not in e:
            raise TraceValidationError(f"event {i} ({e['ph']}) missing 'ts'")
        if e["ph"] == "X":
            if "dur" not in e or e["dur"] < 0:
                raise TraceValidationError(
                    f"span event {i} needs a non-negative 'dur': {e}"
                )
    for track, spans in spans_by_track(payload).items():
        _check_nesting(track, spans)


def _check_nesting(track: str, spans: list[dict]) -> None:
    """Spans on one track must be disjoint or properly nested."""
    ordered = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
    stack: list[tuple[float, float, str]] = []  # (start, end, name)
    for e in ordered:
        start, end = e["ts"], e["ts"] + e["dur"]
        while stack and start >= stack[-1][1] - 1e-9:
            stack.pop()
        if stack and end > stack[-1][1] + 1e-9:
            raise TraceValidationError(
                f"track {track!r}: span {e['name']!r} [{start}, {end}] "
                f"partially overlaps {stack[-1][2]!r} "
                f"[{stack[-1][0]}, {stack[-1][1]}]"
            )
        stack.append((start, end, e["name"]))


def validate_no_overlap(payload: dict, track_prefix: str = "") -> None:
    """Strict device-track invariant: spans on each matching track must be
    pairwise DISJOINT (a device executes one task at a time — any overlap
    in a rendered schedule timeline is a renderer or simulator bug)."""
    for track, spans in spans_by_track(payload).items():
        if not track.startswith(track_prefix):
            continue
        ordered = sorted(spans, key=lambda e: e["ts"])
        for a, b in zip(ordered, ordered[1:]):
            # exported values are 3-decimal µs, so a REAL overlap is >= 1e-3;
            # the tolerance only needs to absorb float ulps (one ulp at
            # hour-scale timestamps, ~1e7 µs, is already ~4e-9)
            tol = max(1e-9, abs(b["ts"]) * 1e-12)
            if a["ts"] + a["dur"] > b["ts"] + tol:
                raise TraceValidationError(
                    f"track {track!r}: {a['name']!r} (ends {a['ts'] + a['dur']}) "
                    f"overlaps {b['name']!r} (starts {b['ts']})"
                )


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate Chrome trace-event JSON files (CI schema gate)"
    )
    ap.add_argument("files", nargs="+")
    ap.add_argument(
        "--no-overlap-prefix", default=None, metavar="PREFIX",
        help="additionally require pairwise-disjoint spans on tracks with "
        "this prefix (device-track invariant)",
    )
    args = ap.parse_args(argv)
    failed = 0
    for path in args.files:
        try:
            with open(path) as f:
                payload = json.load(f)
            validate_chrome_trace(payload)
            if args.no_overlap_prefix is not None:
                validate_no_overlap(payload, args.no_overlap_prefix)
            n = len(payload["traceEvents"])
            print(f"{path}: OK ({n} events)")
        except (OSError, json.JSONDecodeError, TraceValidationError) as e:
            print(f"{path}: FAIL — {e}")
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(_main())
