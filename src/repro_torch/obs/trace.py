"""Span tracing with Chrome trace-event export (a copy of
``repro/obs/trace.py``, stdlib only).

Every request that crosses the front door gets a lifecycle of spans —
``admission`` (validation + SLO check inside ``submit``), ``queue``
(admitted → first row routed), ``dispatch`` (first → last row handed to
a replica), ``collect`` (last dispatch → logits scattered back) — and
every pipeline tick gets one ``stage-tick`` span per busy stage plus
idle/edge markers.  Spans land in a bounded in-memory buffer and export
as Chrome trace-event JSON (``Trace.to_chrome_trace()``), loadable
directly in Perfetto / ``chrome://tracing``.

Design choices that keep this correct under load:

* **Completed spans only.**  The buffer stores spans at their *end*
  time, never open begin events.  A bounded buffer that dropped its
  oldest raw ``B``/``E`` events under pressure would orphan pairs and
  produce invalid traces; dropping whole completed spans keeps every
  export well-formed no matter how much history was evicted
  (``Trace.dropped`` counts what fell off).
* **Track layout.**  pid 0 is the front door (one tid per request id, so
  each request reads as its own Perfetto track); pid ``1 + r`` is
  replica ``r`` (one tid per pipeline stage).  ``B``/``E`` pairs are
  reconstructed per track at export time with an explicit stack, so
  pairs are matched by construction — the validator below re-checks
  anyway.
* **Clock.**  One injected ``clock()`` (default ``time.perf_counter``)
  shared with the frontend, so span timestamps and the scheduler's SLO
  arithmetic read the same axis.  Exported ``ts`` is microseconds since
  the trace epoch (clock at construction).

``python -m repro_torch.obs.trace out.json`` validates a file against the
schema (required keys, monotonic ts, matched B/E pairs) — CI runs this
over the artifact it uploads.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import sys
import time

# phase types we emit / accept
_PH_ALLOWED = ("B", "E", "i", "I", "M", "X")


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span: [ts, ts + dur] microseconds on track
    (pid, tid)."""

    name: str
    cat: str
    pid: int
    tid: int
    ts: float            # µs since trace epoch
    dur: float           # µs, >= 0
    args: dict


@dataclasses.dataclass(frozen=True)
class Instant:
    name: str
    cat: str
    pid: int
    tid: int
    ts: float
    args: dict


class Trace:
    """Bounded in-memory span buffer with Chrome trace-event export."""

    def __init__(self, capacity: int = 200_000, clock=time.perf_counter):
        assert capacity >= 1, capacity
        self.capacity = capacity
        self.clock = clock
        self.t0 = clock()
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=capacity)
        self.instants: collections.deque[Instant] = collections.deque(
            maxlen=capacity)
        self.dropped = 0
        self._proc_names: dict[int, str] = {}
        self._thread_names: dict[tuple[int, int], str] = {}

    # -- recording ---------------------------------------------------

    def now(self) -> float:
        """Absolute clock seconds (same axis the serving stack stamps)."""
        return self.clock()

    def us(self, t_abs: float) -> float:
        """Absolute clock seconds -> µs since the trace epoch."""
        return (t_abs - self.t0) * 1e6

    def span(self, name, cat, pid, tid, t_begin, t_end, **args):
        """Record a completed span; ``t_begin``/``t_end`` are absolute
        clock seconds (negative durations are clamped to zero rather
        than corrupting the export)."""
        if len(self.spans) == self.spans.maxlen:
            self.dropped += 1
        ts = self.us(t_begin)
        self.spans.append(Span(name, cat, int(pid), int(tid), ts,
                               max(self.us(t_end) - ts, 0.0), args))

    def instant(self, name, cat, pid, tid, t=None, **args):
        if len(self.instants) == self.instants.maxlen:
            self.dropped += 1
        t = self.clock() if t is None else t
        self.instants.append(Instant(name, cat, int(pid), int(tid),
                                     self.us(t), args))

    def name_process(self, pid, name):
        self._proc_names[int(pid)] = name

    def name_thread(self, pid, tid, name):
        self._thread_names[(int(pid), int(tid))] = name

    # -- export ------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON object: ``{"traceEvents": [...]}``,
        events sorted by ts with matched B/E pairs per (pid, tid)."""
        meta = []
        for pid, name in sorted(self._proc_names.items()):
            meta.append({"name": "process_name", "ph": "M", "ts": 0.0,
                         "pid": pid, "tid": 0, "args": {"name": name}})
        for (pid, tid), name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": pid, "tid": tid, "args": {"name": name}})

        by_track: dict[tuple[int, int], list[Span]] = {}
        for s in self.spans:
            by_track.setdefault((s.pid, s.tid), []).append(s)

        events = []
        for (pid, tid), spans in sorted(by_track.items()):
            # outermost-first at equal begin ts, then a stack sweep:
            # children close before (or exactly when) their parent does,
            # so B/E pairs nest by construction even under fake clocks
            # that stamp many spans at the same instant.
            spans.sort(key=lambda s: (s.ts, -s.dur))
            stack: list[tuple[Span, float]] = []

            def close(upto=None):
                while stack and (upto is None or upto >= stack[-1][1]):
                    top, end = stack.pop()
                    events.append({"name": top.name, "cat": top.cat,
                                   "ph": "E", "ts": end, "pid": pid,
                                   "tid": tid})

            for s in spans:
                close(upto=s.ts)
                end = s.ts + s.dur
                if stack:                       # clamp overlap to parent
                    end = min(end, stack[-1][1])
                events.append({"name": s.name, "cat": s.cat, "ph": "B",
                               "ts": s.ts, "pid": pid, "tid": tid,
                               "args": s.args})
                stack.append((s, end))
            close()

        for i in self.instants:
            events.append({"name": i.name, "cat": i.cat, "ph": "i",
                           "ts": i.ts, "pid": i.pid, "tid": i.tid,
                           "s": "t", "args": i.args})

        events.sort(key=lambda e: e["ts"])      # stable: per-track order
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# -- validation ------------------------------------------------------

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(obj) -> list[str]:
    """Validate a Chrome trace-event object; returns a list of problems
    (empty == valid).  Checks the schema surface CI gates on: required
    keys per event, numeric non-negative monotonically sorted ts, known
    phase types, and matched B/E pairs (stack discipline per
    (pid, tid) track, E never before its B)."""
    errs = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' key"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]

    last_ts = None
    stacks: dict[tuple, list] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED_KEYS if k not in e]
        if missing:
            errs.append(f"event {i}: missing keys {missing}")
            continue
        ph, ts = e["ph"], e["ts"]
        if ph not in _PH_ALLOWED:
            errs.append(f"event {i}: unknown ph {ph!r}")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph != "M":
            if last_ts is not None and ts < last_ts:
                errs.append(f"event {i}: ts {ts} < previous {last_ts} "
                            "(not monotonic)")
            last_ts = ts
        track = (e["pid"], e["tid"])
        if ph == "B":
            stacks.setdefault(track, []).append((e["name"], ts))
        elif ph == "E":
            stack = stacks.get(track) or []
            if not stack:
                errs.append(f"event {i}: E {e['name']!r} on track "
                            f"{track} with no open B")
                continue
            name, b_ts = stack.pop()
            if name != e.get("name", name):
                errs.append(f"event {i}: E {e['name']!r} closes B "
                            f"{name!r} on track {track}")
            if ts < b_ts:
                errs.append(f"event {i}: E ts {ts} precedes B ts {b_ts}")
    for track, stack in stacks.items():
        for name, _ in stack:
            errs.append(f"unclosed B {name!r} on track {track}")
    return errs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m repro_torch.obs.trace <trace.json>")
        return 2
    with open(argv[0]) as f:
        obj = json.load(f)
    errs = validate_chrome_trace(obj)
    n = len(obj.get("traceEvents", []))
    if errs:
        for e in errs[:40]:
            print(f"INVALID: {e}")
        print(f"{argv[0]}: {len(errs)} problem(s) in {n} events")
        return 1
    print(f"{argv[0]}: valid Chrome trace ({n} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
