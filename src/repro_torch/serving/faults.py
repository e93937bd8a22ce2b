"""Failure injection for the replicated serving fleet (a copy of
``repro/serving/faults.py``, stdlib only).

The paper's deployment claim — a *persistent multichip* pipeline serving
at 10k im/s/chip — only matters in production if the fleet survives what
production brings: a chip that dies mid-request (fail-stop), a chip that
wedges (a hung DMA, a stuck host thread), or one that silently degrades
to a fraction of its rate.  ``FaultInjector`` manufactures exactly those
three conditions against a live ``serving.pipeline.PipelineEngine``
replica, deterministically, at a chosen step — so the front door's
watchdog + requeue machinery (serving/frontend.py) can be
tested and benched against the real failure modes instead of hoped at.

Fault semantics (all keyed on the engine's ``step()`` invocation count,
0-based, counted from the moment the fault is armed):

* ``kill``  — fail-stop: the armed invocation raises ``ReplicaFailure``
  before touching engine state, like a device that vanished between
  ticks.  The state it leaves behind is exactly the pre-step state, so
  extraction sees a consistent queue + inlet picture.
* ``hang``  — wedge: from the armed invocation on, ``step()`` returns
  "still busy" without ever advancing the schedule.  Nothing raises —
  only the frontend's progress watchdog can tell a wedged replica from a
  slow one, which is the point.
* ``slow``  — degrade: from the armed invocation on, only every
  ``slow_factor``-th invocation actually ticks; the rest report busy
  without progress.  A replica slowed by less than the watchdog
  threshold limps along and still completes its work; one slowed past it
  is indistinguishable from a hang and gets failed + drained — the
  boundary the watchdog threshold defines.

The injector monkey-wraps ``engine.step`` on the *instance* (the class
is untouched), counts invocations itself, and restores the original
bound method on ``disarm``.  ``ResNetFrontend.restart_replica`` swaps in
a brand-new engine object, which is automatically fault-free.
"""
from __future__ import annotations

import dataclasses


class ReplicaFailure(RuntimeError):
    """A replica died mid-step (the injected fail-stop; a real deployment
    would surface a device error here).  The front door catches this,
    marks the replica failed, and requeues its in-flight rows."""


_KINDS = ("kill", "hang", "slow")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault to inject: ``kind`` in {kill, hang, slow}, engaging at
    the ``at_step``-th ``engine.step()`` invocation after arming."""

    kind: str
    at_step: int = 0
    slow_factor: int = 4          # slow mode: tick once per this many calls

    def __post_init__(self):
        assert self.kind in _KINDS, (self.kind, _KINDS)
        assert self.at_step >= 0, self.at_step
        assert self.slow_factor >= 2, self.slow_factor


class FaultInjector:
    """Arms faults against engine instances and restores them on demand."""

    def __init__(self):
        # id(engine) -> (engine, whatever instance-level "step" override
        # existed at arm time, or a sentinel meaning "none: class method")
        self._armed: dict[int, tuple] = {}

    _NO_OVERRIDE = object()

    def arm(self, engine, fault: Fault):
        """Wrap ``engine.step`` so ``fault`` engages at its chosen
        invocation.  One fault per engine at a time; re-arming replaces
        the previous fault (and its invocation counter)."""
        self.disarm(engine)
        orig = engine.step                     # the bound method
        prev = engine.__dict__.get("step", self._NO_OVERRIDE)
        calls = [0]

        def _busyish() -> bool:
            # what a wedged replica reports: work pending, nothing moving
            return engine.pending_rows > 0 or engine.pipe.busy

        def faulty_step() -> bool:
            n = calls[0]
            calls[0] += 1
            if n < fault.at_step:
                return orig()
            if fault.kind == "kill":
                raise ReplicaFailure(
                    f"injected kill at engine step {n} "
                    f"(replica {engine.pipe.replica})")
            if fault.kind == "hang":
                return _busyish()
            if (n - fault.at_step) % fault.slow_factor:
                return _busyish()              # slow: skip this tick
            return orig()

        engine.step = faulty_step
        self._armed[id(engine)] = (engine, prev)

    def disarm(self, engine):
        """Restore the engine's original ``step`` (no-op if not armed):
        the class method becomes visible again, or whatever instance
        override predated arming is put back."""
        entry = self._armed.pop(id(engine), None)
        if entry is not None:
            eng, prev = entry
            if prev is self._NO_OVERRIDE:
                eng.__dict__.pop("step", None)
            else:
                eng.step = prev

    def disarm_all(self):
        for engine, _ in list(self._armed.values()):
            self.disarm(engine)
