"""The program's own trace spans, read against the card's activity.

With ``--trace 1`` the program (``repro_torch``) records spans where its
host work happens (``repro_torch.obs.trace``): the door's ``validate``,
the engine's ``pack``, ``h2d``, ``wait`` and ``scatter``, each stage
tick and each graph unit inside it, the set-up's ``compile``.  The
readers here take them from ``rec["trace"]`` (the run's ``Trace``) and
the card's busy intervals from ``rec["device_trace"]["busy"]`` (ns on
the profiler's clock); ``add_span_keys`` puts both into a record.  A
record without them, or a program whose trace has no such span or no
``to_unix_ns``, reads as nothing (None or an empty list), never as an
error.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

from portbench import devtrace

# request lifecycle spans that mark a request waiting, not the host
# working: they overlap every step, so they never name an idle moment
WAITING = frozenset({"queue", "dispatch", "collect"})


def add_span_keys(rec: dict, telemetry, prof, pclock) -> dict:
    """Add ``rec["trace"]`` (the run's ``Trace`` or None) and, with the
    profiler's trace, ``rec["device_trace"]["busy"]`` (the union of the
    window's kernel and copy intervals, ns) to a record of
    ``bench.record``.  The trace takes its second clock pair here, just
    after the window, where an export would take it."""
    rec["trace"] = telemetry.trace if telemetry is not None else None
    if rec["trace"] is not None and hasattr(rec["trace"], "sync_point"):
        rec["trace"].sync_point()
    if prof is not None and rec["device_trace"] is not None:
        win = rec["window"]
        ev = devtrace.window_events(
            devtrace.device_events(prof.profiler.kineto_results),
            pclock.to_ns(win.t0), pclock.to_ns(win.t_close))
        rec["device_trace"]["busy"] = devtrace.busy_intervals(ev)
    return rec


def window_spans(rec: dict, name: str, cat: str | None = None) -> list:
    """The spans named ``name`` (of category ``cat``, if given) that start
    inside the window."""
    tr = rec.get("trace")
    if tr is None:
        return []
    win = rec["window"]
    t0_us, t1_us = tr.us(win.t0), tr.us(win.t_close)
    return [s for s in tr.spans if s.name == name
            and (cat is None or s.cat == cat) and t0_us <= s.ts <= t1_us]


def mean_ms(rec: dict, name: str, cat: str | None = None):
    """The mean duration of the window's spans named ``name``, in ms, or
    None where there is none."""
    spans = window_spans(rec, name, cat)
    if not spans:
        return None
    return sum(s.dur for s in spans) / len(spans) / 1e3


def idle_under_spans(rec: dict):
    """{span name: seconds} of the window's device-idle time (the window
    less the union of kernel and copy intervals) under the innermost
    program span open at each moment, ``""`` where none is open; None
    without the program's trace, its clock mapping or the busy intervals.

    The innermost open span is the one that began last (of two that began
    together, the shorter); spans nest, so it is a graph unit's span
    where one is open.  The request lifecycle's waiting spans (``WAITING``)
    take no part.  Spans are placed on the profiler's clock with
    ``Trace.to_unix_ns``."""
    tr = rec.get("trace")
    dt = rec.get("device_trace")
    if (tr is None or dt is None or "busy" not in dt
            or not hasattr(tr, "to_unix_ns")):
        return None
    if tr.sync_pairs[1] is None:
        tr.sync_point()
    win = rec["window"]
    t0, t1 = tr.to_unix_ns(win.t0), tr.to_unix_ns(win.t_close)

    def ns(ts_us):
        return tr.to_unix_ns(tr.t0 + ts_us / 1e6)

    spans = []
    for s in tr.spans:
        if s.cat == "request" and s.name in WAITING:
            continue
        b, e = max(ns(s.ts), t0), min(ns(s.ts + s.dur), t1)
        if e > b:
            spans.append((b, e, s.name))
    idle, prev = [], t0
    for s, e in dt["busy"]:
        if s > prev:
            idle.append((prev, min(s, t1)))
        prev = max(prev, e)
        if prev >= t1:
            break
    if prev < t1:
        idle.append((prev, t1))
    idle = [(a, b) for a, b in idle if b > a]
    return _attribute(spans, idle, t0, t1)


def _attribute(spans: list, idle: list, t0: int, t1: int) -> dict:
    """Sweep the cut points of spans and idle intervals; every piece
    between two cuts is wholly idle or wholly busy, and has one innermost
    open span."""
    spans.sort(key=lambda x: (x[0], -x[1]))
    cuts = sorted({t0, t1} | {p for b, e, _ in spans for p in (b, e)}
                  | {p for a, b in idle for p in (a, b)})
    out = defaultdict(float)
    heap, i, j = [], 0, 0
    for lo, hi in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= lo:
            b, e, name = spans[i]
            heapq.heappush(heap, (-b, e, i, name))
            i += 1
        while heap and heap[0][1] <= lo:
            heapq.heappop(heap)
        while j < len(idle) and idle[j][1] <= lo:
            j += 1
        if j < len(idle) and idle[j][0] <= lo:
            out[heap[0][3] if heap else ""] += (hi - lo) / 1e9
    return dict(out)
