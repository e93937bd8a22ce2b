"""Metrics registry (a copy of ``repro/obs/metrics.py``, numpy only) — the
one accounting surface behind the serving stack.

Every counter the fleet used to keep as an ad-hoc ``self._foo = 0``
attribute lives here instead: a component owns a ``MetricsRegistry``,
creates named metrics once at construction time, and keeps direct Python
references to them for the hot path (``ctr.inc()`` is one attribute add —
no dict lookup per event).  ``stats()`` methods become thin views over
``registry.snapshot()``.

Scopes.  A metric is either ``wave``-scoped (zeroed by ``reset_wave()``
between measurement waves — dispatch counts, latency reservoirs, shed
counters) or ``life``-scoped (survives resets — odometers like lifetime
rows completed, calibration gauges like the EWMA row time).  The scope
split IS the ``reset_stats`` audit the frontend needed: a wave counter
that outlives a reset is now a bug you can test for structurally
(``registry.wave_names()`` vs what ``snapshot()`` reports) instead of a
list you keep in your head.

Four metric kinds, all zero-dependency and O(1) per observation:

* ``Counter``   — monotonically increasing within a wave.
* ``Gauge``     — last-write-wins scalar; ``HighWater`` keeps the max.
* ``Histogram`` — fixed bucket bounds, percentile by linear
  interpolation inside the winning bucket.  Constant memory, any stream
  length; the right tool when the window must not be bounded.
* ``Reservoir`` — bounded sliding window of the newest N samples
  (deque), exact percentiles over the window via ``np.percentile``.
  This is the frontend's latency store: p50/p95 over the last
  ``latency_window`` requests.
"""
from __future__ import annotations

import collections
import math

import numpy as np

WAVE = "wave"
LIFE = "life"
_SCOPES = (WAVE, LIFE)


def percentile(xs, q):
    """``np.percentile`` with the serving stack's empty convention:
    ``None`` when there are no samples (a fleet that served nothing has
    no p95, not a p95 of 0)."""
    xs = list(xs)
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


class _Metric:
    kind = "metric"

    def __init__(self, name: str, scope: str = WAVE, help: str = ""):
        assert scope in _SCOPES, scope
        self.name = name
        self.scope = scope
        self.help = help

    def reset(self):
        raise NotImplementedError

    def snapshot(self):
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, scope=WAVE, help=""):
        super().__init__(name, scope, help)
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def reset(self):
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, scope=WAVE, help="", initial=0.0):
        super().__init__(name, scope, help)
        self._initial = initial
        self.value = initial

    def set(self, v):
        self.value = v

    def reset(self):
        self.value = self._initial

    def snapshot(self):
        return self.value


class HighWater(Gauge):
    """Gauge that remembers the maximum observed value (queue depth)."""

    kind = "highwater"

    def observe(self, v):
        if v > self.value:
            self.value = v


class Histogram(_Metric):
    """Fixed-bucket histogram: ``bounds`` are the inclusive upper edges
    of each bucket; one implicit overflow bucket catches the rest.
    ``percentile(q)`` interpolates linearly within the winning bucket —
    constant memory for unbounded streams, resolution set by the bucket
    grid (the classic prometheus trade)."""

    kind = "histogram"

    def __init__(self, name, bounds, scope=WAVE, help=""):
        super().__init__(name, scope, help)
        bounds = tuple(float(b) for b in bounds)
        assert bounds == tuple(sorted(bounds)) and len(bounds) >= 1, bounds
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)     # + overflow
        self.total = 0
        self.sum = 0.0
        self._lo = math.inf                       # for interpolation floors

    def observe(self, v):
        v = float(v)
        self.total += 1
        self.sum += v
        if v < self._lo:
            self._lo = v
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def reset(self):
        self.counts = [0] * (len(self.bounds) + 1)
        self.total = 0
        self.sum = 0.0
        self._lo = math.inf

    def percentile(self, q):
        """Linear interpolation inside the bucket holding the q-th
        sample; ``None`` on empty, clamped to the last finite bound for
        overflow hits."""
        if self.total == 0:
            return None
        rank = (q / 100.0) * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else min(self._lo, self.bounds[0])
            hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
            if seen + c >= rank:
                frac = (rank - seen) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            seen += c
        return float(self.bounds[-1])

    def snapshot(self):
        return {"bounds": list(self.bounds), "counts": list(self.counts),
                "total": self.total, "sum": self.sum,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class Reservoir(_Metric):
    """Bounded sliding window of the newest ``window`` samples, in
    arrival order (overflow evicts the oldest).  Exact percentiles over
    the window; ``observed`` counts everything ever seen.  Supports
    ``len()`` and iteration so existing code that treated the latency
    store as a plain deque keeps working."""

    kind = "reservoir"

    def __init__(self, name, window, scope=WAVE, help=""):
        super().__init__(name, scope, help)
        assert window >= 1, window
        self.window = window
        self._buf = collections.deque(maxlen=window)
        self.observed = 0

    def observe(self, v):
        self._buf.append(float(v))
        self.observed += 1

    append = observe                              # deque-compatible alias

    def reset(self):
        self._buf.clear()
        self.observed = 0

    def percentile(self, q):
        return percentile(self._buf, q)

    def values(self):
        return list(self._buf)

    def __len__(self):
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def snapshot(self):
        return {"window": self.window, "count": len(self._buf),
                "observed": self.observed,
                "p50": self.percentile(50), "p95": self.percentile(95)}


class MetricsRegistry:
    """Named metrics with get-or-create semantics and a wave/life scope
    split.  One registry per component (frontend, engine+pipe); nesting
    is done at snapshot time by the owner, not here."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, *args, **kw):
        m = self._metrics.get(name)
        if m is not None:
            assert isinstance(m, cls), (name, type(m), cls)
            return m
        m = cls(name, *args, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name, scope=WAVE, help=""):
        return self._get_or_create(Counter, name, scope, help)

    def gauge(self, name, scope=WAVE, help="", initial=0.0):
        return self._get_or_create(Gauge, name, scope, help, initial)

    def highwater(self, name, scope=WAVE, help="", initial=0.0):
        return self._get_or_create(HighWater, name, scope, help, initial)

    def histogram(self, name, bounds, scope=WAVE, help=""):
        return self._get_or_create(Histogram, name, bounds, scope, help)

    def reservoir(self, name, window, scope=WAVE, help=""):
        return self._get_or_create(Reservoir, name, window, scope, help)

    def get(self, name):
        return self._metrics[name]

    def __contains__(self, name):
        return name in self._metrics

    def names(self):
        return sorted(self._metrics)

    def wave_names(self):
        return sorted(n for n, m in self._metrics.items() if m.scope == WAVE)

    def reset_wave(self):
        """Zero every wave-scoped metric; life-scoped metrics survive.
        THE reset between measurement waves — components must not keep
        wave counters outside the registry."""
        for m in self._metrics.values():
            if m.scope == WAVE:
                m.reset()

    def snapshot(self):
        """{name: value-or-dict} for every metric, wave and life."""
        return {n: self._metrics[n].snapshot() for n in sorted(self._metrics)}
