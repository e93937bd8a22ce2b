"""``repro_torch.obs`` — telemetry for the serving stack (ports
``repro/obs/__init__.py``).

Three pillars:

* ``trace``   — request + stage-tick span tracing, Chrome trace-event
  export (Perfetto-loadable), schema validator.
* ``metrics`` — Counter/Gauge/Histogram/Reservoir registry with a
  wave/life scope split; component ``stats()`` dicts are thin views
  over ``MetricsRegistry.snapshot()``.
* ``sparsity``— post-ReLU activation zero-fraction profiling fed by the
  conv kernels' epilogues.

``Telemetry`` is the bundle the serving stack threads through
(frontend → engine → pipeline → kernels).  It is **off by default**
(``telemetry=None`` everywhere): the instrumented code guards every
hook behind one ``is None`` check, so the off path costs a branch.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (Counter, Gauge, HighWater, Histogram,
                                     MetricsRegistry, Reservoir,
                                     percentile)
from repro_torch.obs.sparsity import SparsityProfiler
from repro_torch.obs.trace import Trace, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "HighWater", "Histogram", "MetricsRegistry",
    "Reservoir", "percentile", "SparsityProfiler", "Trace",
    "validate_chrome_trace", "Telemetry",
]


class Telemetry:
    """What a serving component receives when observability is on.

    ``trace``: ``True`` (fresh buffer), a ``Trace`` instance, or
    ``None``.  ``sparsity_groups``: ``coarse_in`` lane-group size to
    profile activation sparsity at (``None`` = profiling off — the
    model compiles its unprofiled stage programs).  ``clock`` must be
    the same callable the frontend schedules with, so spans and SLO
    arithmetic share a time axis.
    """

    def __init__(self, trace=None, sparsity_groups=None,
                 clock=time.perf_counter, trace_capacity=200_000):
        if trace is True:
            trace = Trace(capacity=trace_capacity, clock=clock)
        assert trace is None or isinstance(trace, Trace), trace
        self.trace = trace
        self.sparsity = (None if sparsity_groups is None
                         else SparsityProfiler(groups=sparsity_groups))
        self.clock = clock

    @property
    def profiled(self) -> bool:
        """True when stage programs must emit sparsity aux."""
        return self.sparsity is not None
