"""Reading the card's activity from ``torch.profiler`` (CUDA activity
only, read from the raw kineto events, never through ``key_averages``,
whose per-event records cost far more than the run): the device
intervals of the traced window, the busy time as their union, kernel
launches and time by name, and the idle gaps named by what the host was
doing, from the benchmark's own host spans.

The arithmetic is that of the program's ``chip_smoke.py`` ``[profile]``
(device events with a duration; busy and idle of the window), with the
busy time taken as the union of the intervals, so that overlapping
copies and kernels count once.  The profiler stamps events on the
system clock (``time.time_ns``); the host spans are on
``time.perf_counter``, and ``Clock`` maps one onto the other.
"""
from __future__ import annotations

import time
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")


class Clock:
    """perf_counter seconds <-> the profiler's nanoseconds."""

    def __init__(self):
        a = time.perf_counter_ns()
        b = time.time_ns()
        c = time.perf_counter_ns()
        self.offset_ns = b - (a + c) // 2

    def to_ns(self, t_perf_s: float) -> int:
        return int(t_perf_s * 1e9) + self.offset_ns


def device_events(kineto_results) -> list:
    """[(start ns, end ns, name)] of every device activity (kernels,
    copies, sets) with a duration, sorted by start."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in kineto_results.events()
           if e.device_type() == cuda and e.duration_ns() > 0]
    out.sort()
    return out


def window_events(events: list, t0_ns: int, t1_ns: int) -> list:
    """The events clipped to [t0, t1]; those wholly outside dropped."""
    return [(max(s, t0_ns), min(e, t1_ns), n) for s, e, n in events
            if e > t0_ns and s < t1_ns]


def busy_intervals(events: list) -> list:
    """The union of the events' intervals, as sorted disjoint [s, e]."""
    merged = []
    for s, e, _ in events:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(events: list) -> float:
    return sum(e - s for s, e in busy_intervals(events)) / 1e9


def kernel_launches(events: list) -> int:
    return sum(not n.startswith(COPY_PREFIXES) for _, _, n in events)


def time_by_name(events: list) -> dict:
    """name -> device seconds (clipped to the window)."""
    out = defaultdict(float)
    for s, e, n in events:
        out[n] += (e - s) / 1e9
    return dict(out)


def top_ops(events: list, n: int = 10) -> list:
    return sorted(([k, v] for k, v in time_by_name(events).items()),
                  key=lambda kv: -kv[1])[:n]


def idle_gaps(events: list, t0_ns: int, t1_ns: int, host_spans: list,
              clock: Clock, n: int = 10) -> list:
    """The longest idle gaps of the window, each named by the host span
    (``[name, t_begin, t_end]`` on perf_counter seconds) under the gap's
    middle, ``"other"`` where none is.  Returns ``[[name, seconds]]``."""
    gaps, prev = [], t0_ns
    for s, e in busy_intervals(events):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = [(clock.to_ns(b), clock.to_ns(e), name)
             for name, b, e in host_spans]
    out = []
    for s, e in gaps[:n]:
        mid = (s + e) // 2
        name = next((nm for b, en, nm in spans if b <= mid <= en), "other")
        out.append([name, (e - s) / 1e9])
    return out
