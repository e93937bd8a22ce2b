"""Span tracing with Chrome trace-event export (a copy of
``repro/obs/trace.py``, stdlib only).

Every request that crosses the front door gets a lifecycle of spans —
``admission`` (validation + SLO check inside ``submit``), ``queue``
(admitted → first row routed), ``dispatch`` (first → last row handed to
a replica), ``collect`` (last dispatch → logits scattered back).  Inside
the serving path the host's work gets spans of its own: the door's
``validate`` on the request's track, the door loop's ``step`` (with
``dispatch_rows`` and ``collect``) and the set-up's ``compile`` on
``DOOR_TID``, each replica's ``engine.step`` (with ``pack``, ``h2d``,
``wait`` and ``scatter``) on its ``HOST_TID`` thread, and one
``stage{s}`` span per busy stage tick holding one ``unit`` span per
graph unit.  Microbatch spans carry ``mb``, the engine's sequence number
of the microbatch, which ``pack``, ``stage{s}`` and ``scatter`` join to
the request ids (``rids``).  Spans land in a bounded in-memory buffer and
export as Chrome trace-event JSON (``Trace.to_chrome_trace()``),
loadable directly in Perfetto / ``chrome://tracing``.

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
* **One clock with the profiler.**  ``torch.profiler`` stamps its events
  in nanoseconds of the system clock (``time.time_ns``).  The trace
  pairs its clock with that one twice — at construction and at the
  latest ``sync_point()`` (export takes one) — each pair the midpoint of
  two clock reads around one ``time_ns``; ``to_unix_ns`` interpolates
  between the two pairs, so the clocks' drift over a long window does
  not build up, and the export's ``otherData["clock_sync"]`` carries
  both pairs so a file lines up with a profiler trace.

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

# pid 0 is the front door, whose request tracks are tid = rid (warm-ups
# take small negative rids); its own loop and set-up take a tid no rid
# takes.  A replica's pid holds its stages at tid = stage and its
# engine's host work at HOST_TID.
DOOR_TID = -(2 ** 31)
HOST_TID = -1


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

    def __init__(self, capacity: int = 200_000, clock=time.perf_counter,
                 unix_ns=time.time_ns):
        assert capacity >= 1, capacity
        self.capacity = capacity
        self.clock = clock
        self._unix_ns = unix_ns
        self.t0 = clock()
        # (clock seconds, unix ns): the construction's pair and the
        # latest sync_point's (None until one is taken)
        self.sync_pairs = [self._pair(), None]
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

    def _pair(self) -> tuple:
        a = self.clock()
        u = self._unix_ns()
        b = self.clock()
        return ((a + b) / 2, u)

    def sync_point(self):
        """Pair the clock with the system clock again (the second pair
        of ``to_unix_ns``'s interpolation)."""
        self.sync_pairs[1] = self._pair()

    def to_unix_ns(self, t_abs: float) -> int:
        """Absolute clock seconds -> the profiler's nanoseconds
        (``time.time_ns``), by linear interpolation between the two sync
        pairs (an offset alone until ``sync_point`` has been called)."""
        (c0, u0), p1 = self.sync_pairs
        rate = 1e9
        if p1 is not None and p1[0] != c0:
            rate = (p1[1] - u0) / (p1[0] - c0)
        # the offset in float, the sum in int: a float of ~1.8e18 ns
        # holds only every 256th ns
        return u0 + round((t_abs - c0) * rate)

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
        events sorted by ts with matched B/E pairs per (pid, tid);
        ``otherData["clock_sync"]`` pairs the export's ``ts`` (µs) with
        the profiler's unix nanoseconds, at construction and now."""
        self.sync_point()
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
        sync = [{"ts_us": self.us(c), "unix_ns": u}
                for c, u in self.sync_pairs]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "clock_sync": sync}}

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
