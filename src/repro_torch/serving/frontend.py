"""Replicated-pipeline serving front-end — many Fig 7 chains behind one
front door (ports ``repro/serving/frontend.py``).

The paper's deployment story does not stop at one multi-chip pipeline:
"heavy traffic from millions of users" means N *data-parallel replicas*
of the layer-pipelined network running over disjoint device groups, the
same scale-out move HPIPE makes across independent device clusters.  At
that point the Memory-Efficient Dataflow literature's lesson applies:
the front door — admission and batching — becomes the bottleneck before
the kernels do, so it gets its own component.

``ResNetFrontend`` owns the shared request queue and N
``serving.pipeline.PipelineEngine`` replicas:

* **Replica carving** — ``launch.mesh.replica_pipeline_devices`` splits
  the local device list into disjoint contiguous groups, one stage chain
  per replica (on one card, every replica shares it); every replica
  holds the FULL network (split over its own stages), and all replicas
  share ONE compiled param tree — compile once, ``nn.to_device`` per
  stage (spy-tested in tests/test_torch_frontend.py).  The fleet runs on
  the card by default (``device="cuda"``) and raises when CUDA is absent
  unless the caller passes ``device="cpu"``; the door keeps numpy
  images.
* **Admission + routing** — requests wait in the front-door queue until
  the least-loaded healthy replica (by ``PipelineEngine.pending_rows``)
  has room under ``admit_rows``.  Dispatch is ROW granular by default
  (``continuous=True``): two small requests can share a microbatch on
  one replica, a large request never head-of-line-blocks the door.
  ``continuous=False`` restores whole-request dispatch.
* **SLO-aware admission** — with ``slo_p95_s`` set, ``submit`` sheds
  instead of queueing forever: the estimated wait (door backlog + fleet
  in-flight rows, times the EWMA per-row service time measured from
  completions) is compared against the p95 budget, and a request that
  cannot make it gets a typed ``Rejected`` outcome at the door — load
  the fleet cannot carry is refused where the client can see it, not
  buried in an unbounded queue.  ``admit_rows`` stays the inner,
  per-replica backpressure.
* **Failure detection + recovery** (DESIGN.md §10) — a replica that
  raises ``ReplicaFailure`` mid-step (fail-stop) is marked failed on the
  spot; one whose ``progress_marker`` freezes for ``watchdog_ticks``
  steps while it claims work (wedged or degraded-past-usefulness) is
  failed by the watchdog.  Either way its unfinished rows are extracted
  (``PipelineEngine.extract_pending``) and requeued to healthy replicas;
  per-row quantization domains (§9) make the re-executed rows
  bit-identical to the never-failed reference.  ``restart_replica``
  re-admits a failed replica with a fresh engine (fresh ``to_device``
  of its stage subtrees, same shared tree).
* **Quantization-domain safety** — quantization domains are PER ROW
  (DESIGN.md §9): one image's logits depend only on its own pixels, so
  any packing — across requests inside a replica's microbatch, one
  request's rows split across replicas, or a requeue after failure — is
  bit-identical to ``serving.pipeline.reference_logits`` no matter the
  replica count, arrival order, interleaving, or fault schedule.
* **Front-door validation** — ``submit`` rejects malformed requests with
  a clear ``ValueError`` (mirroring ``ServingEngine.submit``'s
  hardening) instead of shape-erroring deep inside a packed microbatch:
  images must be float-castable, rank-4, matching the compiled graph's
  entry-node geometry ``(n, H, W, C)``, and finite.  It also rejects re-submission of
  a request object that is still queued or in flight, and a duplicate
  ``rid`` among live requests — both used to silently reset the victim's
  dispatch accounting mid-flight.
* **Accounting** — queue depth (current + max), per-replica bubble and
  rows dispatched, failure/requeue/shed counters, the service-rate
  estimate, and wall-clock request latency (submit -> done) reported as
  p50/p95 over a bounded sliding window of the most recent
  ``latency_window`` completions (an open-loop serve runs indefinitely;
  an append-forever list would leak).

Surface mirrors the existing engines: ``submit`` / ``step`` / ``run`` /
``stats`` (plus ``run_batch`` for one anonymous request).  ``run`` takes
a ``max_steps`` last-resort guard: if the fleet cannot drain (e.g. a
wedge with the watchdog disabled), it raises a diagnosable
``TimeoutError`` with the fleet stats attached instead of spinning
forever.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core.compiled_linear import ensure_compiled
from repro_torch.launch.mesh import local_devices, replica_pipeline_devices
from repro_torch.obs.metrics import LIFE, MetricsRegistry, percentile
from repro_torch.serving.faults import ReplicaFailure
from repro_torch.serving.pipeline import PipelineEngine, PipelineRequest


@dataclasses.dataclass
class FrontendRequest(PipelineRequest):
    """A ``PipelineRequest`` plus the front-end's lifecycle accounting."""
    replica: int | None = None          # first replica assigned at dispatch
    rows_routed: int = 0                # dispatch cursor (continuous mode)
    rejected: bool = False              # shed by SLO-aware admission
    t_submit: float | None = None
    t_admitted: float | None = None     # admission decision made
    t_first_dispatch: float | None = None
    t_last_dispatch: float | None = None
    t_done: float | None = None

    @property
    def latency_s(self) -> float | None:
        if self.t_submit is None or self.t_done is None:
            return None
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class Admitted:
    """``submit`` outcome: the request is queued (or, zero-row, already
    complete).  ``estimated_wait_s`` is None until the fleet has measured
    a service rate."""
    rid: int
    rows: int
    estimated_wait_s: float | None


@dataclasses.dataclass(frozen=True)
class Rejected:
    """``submit`` outcome: the request was SHED at the door — its
    estimated wait exceeds the p95 latency budget, so queueing it would
    only break the SLO for it *and* everyone behind it.  The client sees
    a typed outcome (retry later / elsewhere) instead of a silent,
    unbounded queue."""
    rid: int
    rows: int
    estimated_wait_s: float
    slo_p95_s: float
    reason: str = "p95-budget"


def _percentile(xs, q: float) -> float | None:
    """Kept as the frontend's percentile spelling; one implementation
    (``obs.metrics.percentile``) serves the whole stack."""
    return percentile(xs, q)


class ResNetFrontend:
    """Admission queue + least-loaded routing over N pipeline replicas,
    with failure recovery and SLO-aware shedding.

    Despite the historical name, the front door serves any model exposing
    the zoo protocol (``cfg.graph()``/``cfg.apply()``, DESIGN.md §12) —
    the expected input geometry is derived from the compiled graph's
    entry node, not hardcoded."""

    def __init__(self, cfg, params, *,
                 mode: str = "int8", sparsity: float = 0.8,
                 n_replicas: int = 2, n_stages: int = 1,
                 stage_blocks=None, plan=None, microbatch: int = 2,
                 device="cuda", devices=None,
                 admit_rows: int | None = None,
                 continuous: bool = True,
                 watchdog_ticks: int | None = 8, recover: bool = True,
                 slo_p95_s: float | None = None,
                 latency_window: int = 2048,
                 clock=time.perf_counter, telemetry=None):
        assert n_replicas >= 1, n_replicas
        devices = (local_devices(device) if devices is None
                   else list(devices))
        self.cfg = cfg
        self._in_shape = cfg.graph().in_shape()
        self.microbatch = microbatch
        self.continuous = continuous
        self.telemetry = telemetry
        if telemetry is not None and telemetry.trace is not None:
            # spans and SLO arithmetic must share one time axis: the
            # trace's clock wins (Telemetry docstring) — callers with a
            # fake clock pass it to Telemetry too
            clock = telemetry.clock
            telemetry.trace.name_process(0, "frontend")
        # compile ONCE; every replica shares this tree and only moves its
        # own stages' subtrees onto its device group
        self.params = ensure_compiled(params, mode, sparsity)
        self._groups = replica_pipeline_devices(n_replicas, n_stages,
                                                devices)
        # kept so restart_replica can rebuild an engine identically
        # (fresh to_device onto the same group, same shared tree;
        # telemetry rides along so a restarted replica keeps tracing)
        self._replica_kwargs = dict(
            mode=mode, sparsity=sparsity, n_stages=n_stages,
            stage_blocks=stage_blocks, plan=plan, microbatch=microbatch,
            pack_requests=continuous, telemetry=telemetry)
        self.replicas = [
            PipelineEngine(cfg, self.params, devices=self._groups[r],
                           replica=r, **self._replica_kwargs)
            for r in range(n_replicas)]
        # front door: a replica chain absorbs n_stages in-flight
        # microbatches; double that before the queue holds requests back
        self.admit_rows = (2 * n_stages * microbatch
                           if admit_rows is None else admit_rows)
        assert self.admit_rows >= 1, (
            "admit_rows must be >= 1 — 0 would deadlock the front door "
            "(an idle replica could never be handed work)", admit_rows)
        assert watchdog_ticks is None or watchdog_ticks >= 1, watchdog_ticks
        assert latency_window >= 1, latency_window
        self.watchdog_ticks = watchdog_ticks
        self.recover = recover
        self.slo_p95_s = slo_p95_s
        self.latency_window = latency_window
        self._clock = clock
        self.queue: deque = deque()
        self._requeue: deque = deque()         # (req, start, stop) spans
        self._inflight: list = []
        self._live: dict = {}                  # rid -> live request
        self._door_rows = 0                    # rows waiting at the door
        # every wave/lifetime statistic lives in the registry: the
        # wave/life scope split IS the reset_stats contract, testable
        # structurally (registry.wave_names()); direct references keep
        # the hot path at one attribute add per event, and the old
        # attribute names survive as read-only property views below
        self.metrics = m = MetricsRegistry()
        self._rows_dispatched_c = [
            m.counter(f"door.replica{r}.rows_dispatched")
            for r in range(n_replicas)]
        self._requests_dispatched_c = [
            m.counter(f"door.replica{r}.requests_dispatched")
            for r in range(n_replicas)]
        self._max_queue_depth = m.highwater("door.max_queue_depth")
        # bounded reservoir: p50/p95 over the most recent latency_window
        # completions — an open-loop serve must not grow without bound
        self._latencies = m.reservoir("door.latency_s", latency_window)
        self._requests_done = m.counter("door.requests_done")
        # failure / shed accounting
        self.failed = [False] * n_replicas
        self.failures: list = []               # {replica, reason, step}
        self._replicas_failed = m.counter("door.replicas_failed")
        self._requeues = m.counter("door.requeues")   # spans requeued
        self._rows_requeued = m.counter("door.rows_requeued")
        self._rejected = m.counter("door.rejected_requests")
        self._rejected_rows = m.counter("door.rejected_rows")
        self._steps_c = m.counter("door.steps")
        self._marker = [None] * n_replicas     # watchdog progress markers
        self._stall = [0] * n_replicas
        # EWMA per-row service time, measured fleet-wide from completions
        # (calibration, not a wave stat: LIFE scope survives reset_wave)
        self._row_time_g = m.gauge("door.row_time_s", scope=LIFE,
                                   initial=None)
        self._rows_seen_g = m.gauge("door.rows_seen", scope=LIFE,
                                    initial=0)

    # -- registry views (the pre-registry attribute surface) -----------
    @property
    def rows_dispatched(self) -> list:
        return [c.value for c in self._rows_dispatched_c]

    @property
    def requests_dispatched(self) -> list:
        return [c.value for c in self._requests_dispatched_c]

    @property
    def max_queue_depth(self) -> int:
        return int(self._max_queue_depth.value)

    @property
    def requests_done(self) -> int:
        return self._requests_done.value

    @property
    def replicas_failed(self) -> int:
        return self._replicas_failed.value

    @property
    def requeues(self) -> int:
        return self._requeues.value

    @property
    def rows_requeued(self) -> int:
        return self._rows_requeued.value

    @property
    def rejected_count(self) -> int:
        return self._rejected.value

    @property
    def rejected_rows(self) -> int:
        return self._rejected_rows.value

    @property
    def _steps(self) -> int:
        return self._steps_c.value

    @property
    def _row_time(self):
        return self._row_time_g.value

    @_row_time.setter
    def _row_time(self, v):                    # tests seed calibration
        self._row_time_g.set(v)

    @property
    def _rows_seen(self):
        return self._rows_seen_g.value

    @_rows_seen.setter
    def _rows_seen(self, v):
        self._rows_seen_g.set(v)

    # -- request management --------------------------------------------
    def _validate(self, req) -> np.ndarray:
        """Front-door request hardening: reject malformed image payloads
        with a clear ValueError instead of shape-erroring deep inside a
        packed microbatch (where the failure would also take DOWN the
        innocent requests sharing that microbatch)."""
        try:
            images = np.asarray(req.images, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"request {req.rid}: images must be castable to float32 "
                f"(got {type(req.images).__name__}: {e})") from None
        # expected geometry comes from the compiled graph's entry node,
        # not a hardcoded 224x224x3: the fleet serves whatever model the
        # config's graph describes (regression: tests/test_graph.py)
        want = self._in_shape
        if images.ndim != 4 or images.shape[1:] != want:
            raise ValueError(
                f"request {req.rid}: images must have shape "
                f"(n, {want[0]}, {want[1]}, {want[2]}) — rows from "
                f"different requests are packed into one microbatch, so "
                f"every request must match the model's input geometry "
                f"exactly; got {images.shape}")
        if images.size and not np.isfinite(images).all():
            raise ValueError(
                f"request {req.rid}: images contain NaN/Inf pixels — a "
                f"non-finite row would corrupt its per-row quantization "
                f"scale and produce garbage logits; sanitize upstream")
        return images

    def _check_not_live(self, req):
        """Re-submitting a live request object used to silently reset its
        ``rows_routed``/``done`` mid-flight, corrupting dispatch
        accounting for rows a replica was already executing; a second
        request reusing a live ``rid`` would corrupt the live registry
        the same way.  Both are caller bugs — reject loudly."""
        for live in self._live.values():
            if live is req:
                raise ValueError(
                    f"request {req.rid} is already queued or in flight — "
                    f"re-submitting would reset its dispatch accounting "
                    f"mid-flight; wait for done (or submit a new request "
                    f"object)")
        if req.rid in self._live:
            raise ValueError(
                f"request rid={req.rid} duplicates a live request's rid — "
                f"rids must be unique among queued/in-flight requests")

    def _estimate_wait_s(self, extra_rows: int) -> float | None:
        """Queue-theory estimate of a new request's completion wait:
        (door backlog + healthy replicas' pending rows + its own rows)
        x the measured per-row service time.  None until the fleet has
        completed enough rows to measure a rate (then admission cannot
        shed — it has no evidence yet)."""
        if self._row_time is None:
            return None
        healthy = [self.replicas[r] for r in self._healthy()]
        if not healthy:
            return None
        backlog = self._door_rows + sum(e.pending_rows for e in healthy)
        return (backlog + extra_rows) * self._row_time

    def submit(self, req):
        """Validate and admit a request into the front-door queue
        (routing happens at ``step`` time, when replica load is
        current).  Raises ValueError on malformed images, re-submission
        of a live request, or a duplicate live rid.  Returns a typed
        outcome: ``Admitted``, or — when ``slo_p95_s`` is set and the
        estimated wait exceeds it — ``Rejected`` (the request is NOT
        queued; ``req.rejected`` is set)."""
        images = self._validate(req)
        self._check_not_live(req)
        req.images = images
        req.logits = None
        req.done = False
        req.rejected = False
        req.replica = None
        req.rows_submitted = req.rows_done = req.rows_routed = 0
        req.t_submit = self._clock()
        req.t_admitted = req.t_first_dispatch = req.t_last_dispatch = None
        req.t_done = None
        tr = (self.telemetry.trace if self.telemetry is not None else None)
        n_rows = len(req.images)
        est = self._estimate_wait_s(n_rows)
        if (self.slo_p95_s is not None and est is not None and n_rows
                and est > self.slo_p95_s):
            req.rejected = True
            self._rejected.inc()
            self._rejected_rows.inc(n_rows)
            if tr is not None:
                tr.instant("shed", "door", 0, req.rid, rid=req.rid,
                           rows=n_rows, estimated_wait_s=est,
                           slo_p95_s=self.slo_p95_s)
            return Rejected(rid=req.rid, rows=n_rows, estimated_wait_s=est,
                            slo_p95_s=self.slo_p95_s)
        self._live[req.rid] = req
        req.t_admitted = self._clock()
        if n_rows == 0:
            # zero-row request: complete at the front door — it owns no
            # microbatch slot, so don't make a replica tick for it; its
            # queue/dispatch spans collapse to zero duration
            req.t_first_dispatch = req.t_last_dispatch = req.t_admitted
            req.logits = np.zeros((0, self.cfg.num_classes), np.float32)
            req.done = True
            self._inflight.append(req)      # _collect stamps t_done
            return Admitted(rid=req.rid, rows=0, estimated_wait_s=est)
        self.queue.append(req)
        self._door_rows += n_rows
        self._max_queue_depth.observe(len(self.queue))
        return Admitted(rid=req.rid, rows=n_rows, estimated_wait_s=est)

    # -- routing ---------------------------------------------------------
    def _healthy(self) -> list:
        return [r for r in range(len(self.replicas)) if not self.failed[r]]

    def _best_replica(self):
        """(replica index, spare rows) of the least-loaded healthy
        replica, or (None, 0) when every replica is failed."""
        healthy = self._healthy()
        if not healthy:
            return None, 0
        loads = [(self.replicas[r].pending_rows, r) for r in healthy]
        load, r = min(loads)
        return r, self.admit_rows - load

    def _dispatch(self):
        """Route rows to the least-loaded healthy replica while it has
        room under ``admit_rows`` — requeued failure spans first (they
        are the oldest work in the system), then the FIFO queue.
        Continuous mode hands off ROWS (the replica packs them into
        shared microbatches); whole-request mode keeps fresh requests
        intact (requeued spans are row-granular by nature).  Each
        hand-off reads ``pending_rows`` — O(1), incrementally maintained
        by the engine — so dispatching R requests costs
        O(R · n_replicas), not the O(R²) a per-hand-off queue scan used
        to cost under load."""
        while self._requeue or self.queue:
            r, room = self._best_replica()
            if r is None or room <= 0:
                return                      # backpressure: hold the door
            now = self._clock()
            if self._requeue:
                req, start, stop = self._requeue[0]
                take = min(room, stop - start)
                self.replicas[r].submit_rows(req, start, start + take)
                self._rows_dispatched_c[r].inc(take)
                self._door_rows -= take
                if getattr(req, "t_first_dispatch", 0) is None:
                    req.t_first_dispatch = now
                req.t_last_dispatch = now
                if start + take >= stop:
                    self._requeue.popleft()
                else:
                    self._requeue[0] = (req, start + take, stop)
                continue
            req = self.queue[0]
            if self.continuous:
                take = min(room, len(req.images) - req.rows_routed)
                if req.rows_routed == 0:    # first rows of this request
                    req.replica = r
                    req.t_first_dispatch = now
                    self._requests_dispatched_c[r].inc()
                    self._inflight.append(req)
                self.replicas[r].submit_rows(
                    req, req.rows_routed, req.rows_routed + take)
                req.rows_routed += take
                req.t_last_dispatch = now
                self._rows_dispatched_c[r].inc(take)
                self._door_rows -= take
                if req.rows_routed >= len(req.images):
                    self.queue.popleft()
            else:
                self.queue.popleft()
                req.replica = r
                self.replicas[r].submit(req)
                req.rows_routed = len(req.images)
                req.t_first_dispatch = req.t_last_dispatch = now
                self._rows_dispatched_c[r].inc(len(req.images))
                self._door_rows -= len(req.images)
                self._requests_dispatched_c[r].inc()
                self._inflight.append(req)

    def _scan_door_rows(self) -> int:
        """Linear-scan oracle for ``_door_rows`` (tests only)."""
        return (sum(len(r.images) - r.rows_routed for r in self.queue)
                + sum(stop - start for _, start, stop in self._requeue))

    # -- failure detection + recovery -----------------------------------
    def _fail_replica(self, r: int, reason: str):
        """Mark replica ``r`` failed, drain its bookkeeping, and (with
        ``recover``) requeue every row it still owed — per-row
        quantization domains make the re-execution bit-identical to the
        never-failed reference, so recovery is invisible in the logits
        (DESIGN.md §10)."""
        self.failed[r] = True
        self._replicas_failed.inc()
        self.failures.append({"replica": r, "reason": reason,
                              "step": self._steps})
        if (self.telemetry is not None
                and self.telemetry.trace is not None):
            self.telemetry.trace.instant("replica-failed", "door", 0, 0,
                                         replica=r, reason=reason)
        if not self.recover:
            return
        spans = self.replicas[r].extract_pending()
        for req, start, stop in spans:
            self._requeue.append((req, start, stop))
            self._rows_requeued.inc(stop - start)
            self._door_rows += stop - start
        self._requeues.inc(len(spans))

    def _watch(self, r: int, eng):
        """Per-replica progress watchdog: an engine whose
        ``progress_marker`` freezes for ``watchdog_ticks`` consecutive
        steps while it has work is wedged (hung device, or degraded past
        usefulness) — mark it failed and requeue.  A healthy busy
        replica changes its marker on EVERY step (the inlet occupancy
        pattern shifts even when row counts hold), so the threshold
        costs no false positives."""
        marker = eng.progress_marker
        has_work = eng.pending_rows > 0 or eng.pipe.busy
        if has_work and marker == self._marker[r]:
            self._stall[r] += 1
            if self._stall[r] >= self.watchdog_ticks:
                self._fail_replica(
                    r, f"watchdog: no progress in {self._stall[r]} steps "
                       f"with {eng.pending_rows} rows pending")
        else:
            self._stall[r] = 0
        self._marker[r] = marker

    def restart_replica(self, r: int):
        """Re-admit replica ``r`` with a brand-new engine: fresh
        ``to_device`` of its stage subtrees onto the same device group,
        aliasing the same shared compiled tree.  Restarting a
        live replica first drains and requeues whatever it holds (a
        failed one was already drained), so no rows are lost either way.
        Returns the new engine."""
        for req, start, stop in self.replicas[r].extract_pending():
            self._requeue.append((req, start, stop))
            self._rows_requeued.inc(stop - start)
            self._door_rows += stop - start
        self.replicas[r] = PipelineEngine(
            self.cfg, self.params, devices=self._groups[r], replica=r,
            **self._replica_kwargs)
        self.failed[r] = False
        self._marker[r] = None
        self._stall[r] = 0
        return self.replicas[r]

    # -- the drive loop --------------------------------------------------
    def _measure_service_rate(self, t_step_start: float):
        """EWMA the fleet's per-row service time from the rows that
        completed this step, over this step's own duration (idle steps
        contribute nothing, so open-loop arrival gaps never pollute the
        estimate): the admission controller's denominator.  Survives
        ``reset_stats`` — it is calibration, not a wave statistic — and
        tolerates engine restarts (the odometer total can only step
        backwards then, which is skipped)."""
        total = sum(eng.rows_completed for eng in self.replicas)
        delta = total - self._rows_seen
        self._rows_seen = total
        if delta > 0:
            dt = self._clock() - t_step_start
            if dt > 0:
                sample = dt / delta
                self._row_time = (sample if self._row_time is None else
                                  0.7 * self._row_time + 0.3 * sample)

    def reset_service_rate(self):
        """Forget the measured per-row service time.  The EWMA's first
        samples absorb whatever the first wave cost — including the
        kernels' first build, which can be 1000x the steady-state rate — so
        benches and drivers call this after their warmup wave to let the
        admission controller calibrate on steady-state completions
        only."""
        self._row_time = None

    def _trace_request(self, tr, req):
        """Emit the request's lifecycle as four contiguous spans on its
        own pid-0 track (tid = rid): admission → queue → dispatch →
        collect; the stage-tick spans it rode live on the replica pids.
        Missing stamps (zero-row requests own no dispatch) collapse the
        corresponding span to zero duration, keeping the chain complete
        for every completed request."""
        a = req.t_admitted if req.t_admitted is not None else req.t_submit
        fd = (req.t_first_dispatch if req.t_first_dispatch is not None
              else a)
        ld = (req.t_last_dispatch if req.t_last_dispatch is not None
              else fd)
        rid, rows = req.rid, len(req.images)
        tr.name_thread(0, rid, f"req {rid}")
        tr.span("admission", "request", 0, rid, req.t_submit, a,
                rid=rid, rows=rows)
        tr.span("queue", "request", 0, rid, a, fd, rid=rid, rows=rows)
        tr.span("dispatch", "request", 0, rid, fd, ld, rid=rid, rows=rows,
                replica=req.replica)
        tr.span("collect", "request", 0, rid, ld, req.t_done,
                rid=rid, rows=rows)

    def _collect(self):
        done, still = [], []
        for req in self._inflight:
            (done if req.done else still).append(req)
        now = self._clock()
        tr = (self.telemetry.trace if self.telemetry is not None else None)
        for req in done:
            req.t_done = now
            self._latencies.append(req.t_done - req.t_submit)
            self._live.pop(req.rid, None)
            if tr is not None:
                self._trace_request(tr, req)
        self._inflight = still                 # one linear pass per step
        self._requests_done.inc(len(done))
        return done

    def step(self) -> bool:
        """Dispatch what the healthy replicas can absorb, advance each
        one tick (catching fail-stops, running the watchdog), and harvest
        completed requests.  Returns False once the whole fleet is idle.
        Raises RuntimeError when work is pending but every replica has
        failed — a dead fleet is diagnosable, not an infinite loop."""
        self._steps_c.inc()
        t_start = self._clock()
        if not self._healthy() and (self.queue or self._requeue
                                    or self._inflight):
            err = RuntimeError(
                f"all {len(self.replicas)} replicas failed with work "
                f"pending ({len(self._live)} live requests); failures: "
                f"{self.failures} — restart_replica() to recover")
            err.fleet_stats = self.stats()
            raise err
        self._dispatch()
        busy = False
        for r, eng in enumerate(self.replicas):
            if self.failed[r]:
                continue
            # host-dispatch-gap hint for bubble attribution: rows still
            # held at the door when this replica ticks
            eng.door_rows = self._door_rows
            try:
                busy = eng.step() or busy
            except ReplicaFailure as e:
                self._fail_replica(r, f"step raised: {e}")
                busy = True                 # the requeued rows are work
                continue
            if self.watchdog_ticks is not None:
                self._watch(r, eng)
        self._measure_service_rate(t_start)
        self._collect()
        return (busy or bool(self.queue) or bool(self._requeue)
                or bool(self._inflight))

    def _default_max_steps(self) -> int:
        """A generous completion bound for ``run``: every live row costs
        at most a few steps (dispatch + pipeline depth + drain), plus
        watchdog + requeue slack per replica.  Normal serving finishes
        in a small fraction of this; only a wedge the watchdog cannot
        clear (or watchdog_ticks=None) reaches it."""
        rows = sum(len(r.images) for r in self._live.values())
        stages = max(len(eng.pipe.stages) for eng in self.replicas)
        slack = (self.watchdog_ticks or 0) + 16
        return 256 + 16 * (rows + len(self._live)) + \
            len(self.replicas) * (stages + slack)

    def run(self, requests: list, *, max_steps: int | None = None) -> list:
        """Submit and drive to completion.  ``max_steps`` is the
        last-resort guard under the per-replica watchdog: if the fleet
        has not drained within it (default: a generous bound computed
        from the offered rows), raise a diagnosable ``TimeoutError``
        carrying the fleet stats (``err.fleet_stats``) instead of
        spinning on ``step()`` forever.  Requests shed by SLO admission
        are returned un-run (``req.rejected``)."""
        for r in requests:
            self.submit(r)
        limit = self._default_max_steps() if max_steps is None else max_steps
        steps = 0
        while self.step():
            steps += 1
            if steps >= limit:
                stuck = [r.rid for r in self._live.values() if not r.done]
                err = TimeoutError(
                    f"fleet did not drain within max_steps={limit} "
                    f"({len(stuck)} requests incomplete: rids {stuck[:8]}"
                    f"{'...' if len(stuck) > 8 else ''}; replicas failed: "
                    f"{self.replicas_failed}, failures: {self.failures})")
                err.fleet_stats = self.stats()
                raise err
        return requests

    def run_batch(self, x) -> np.ndarray:
        """Convenience: one anonymous request, returns stacked logits."""
        req = FrontendRequest(rid=-1, images=np.asarray(x))
        self.run([req])
        return np.asarray(req.logits)

    # -- accounting -----------------------------------------------------
    def reset_stats(self):
        """Zero the wave-scoped statistics (latency reservoir,
        queue-depth high-water mark, dispatch/failure/shed tallies, and
        each replica's schedule tick/bubble/occupancy basis) without
        touching the replicas' compiled state or health flags — benches
        call this between measured waves, while idle.  The reset is ONE
        registry sweep: a statistic is wave-scoped iff ``reset_wave``
        zeroes it, so the coverage audit is structural
        (``metrics.wave_names()``; tested) instead of a hand-maintained
        attribute list.  The service-rate estimate survives (LIFE
        scope): it is calibration the admission controller needs from
        step one of the next wave, not a per-wave statistic."""
        self.metrics.reset_wave()
        self._max_queue_depth.observe(len(self.queue))
        self.failures = []
        for r, eng in enumerate(self.replicas):
            if not self.failed[r]:
                eng.reset_counters()
        self._rows_seen = sum(eng.rows_completed for eng in self.replicas)

    def snapshot(self) -> dict:
        """The registries behind ``stats()``: the door's metrics plus
        each replica engine's (engine + pipe share one registry)."""
        return {"door": self.metrics.snapshot(),
                "replicas": [eng.snapshot() for eng in self.replicas]}

    def stats(self) -> dict:
        reps = [eng.stats() for eng in self.replicas]
        return {
            "n_replicas": len(self.replicas),
            "microbatch": self.microbatch,
            "admit_rows": self.admit_rows,
            "continuous": self.continuous,
            "queue_depth": len(self.queue),
            "max_queue_depth": self.max_queue_depth,
            "door_rows": self._door_rows,
            "requests_done": self.requests_done,
            "rows_dispatched": list(self.rows_dispatched),
            "requests_dispatched": list(self.requests_dispatched),
            # p50/p95 over a bounded sliding window: the most recent
            # latency_window completed requests (latency_samples of them
            # populated) — identical to the old unbounded semantics until
            # the window fills, O(1) memory forever after
            "latency_p50_s": _percentile(self._latencies, 50),
            "latency_p95_s": _percentile(self._latencies, 95),
            "latency_window": self.latency_window,
            "latency_samples": len(self._latencies),
            "replica_bubble": [s["bubble_fraction"] for s in reps],
            "microbatch_occupancy": [s["microbatch_occupancy"]
                                     for s in reps],
            # failure / overload surface (DESIGN.md §10)
            "watchdog_ticks": self.watchdog_ticks,
            "failed": list(self.failed),
            "replicas_failed": self.replicas_failed,
            "failures": list(self.failures),
            "requeues": self.requeues,
            "rows_requeued": self.rows_requeued,
            "slo_p95_s": self.slo_p95_s,
            "rejected": self.rejected_count,
            "rejected_rows": self.rejected_rows,
            "est_row_time_s": self._row_time,
            "est_rows_per_s": (1.0 / self._row_time
                               if self._row_time else None),
            "replicas": reps,
        }
