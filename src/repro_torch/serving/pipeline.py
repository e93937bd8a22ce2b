"""Pipeline-parallel conv-DAG serving engine — persistent per-stage
weights, microbatched requests, the executable Fig 7 (ports
``repro/serving/pipeline.py``).

Requests carry image batches; the engine splits them into rows, and a
``distributed.conv_pipeline.ConvPipeline`` rotates microbatches through
per-device stages whose (disjoint) constant weights were placed at
construction time.

Stage planning accepts, in precedence order:

* ``plan``        — explicit ``partition.StagePlan`` list (or a
                    ``PartitionResult``, re-balanced to ``n_stages``);
* ``stage_blocks``— an explicit stage map: tuple of block-id tuples;
* ``n_stages``    — MAC-balanced contiguous split (partition.plan_stages).

Quantization domains are PER ROW (per image): every edge of the compiled
forward carries ``(int8, scale[row])``, so one row's logits depend only on
its own pixels.  That makes continuous cross-request batching sound: the
engine packs rows from different requests into one microbatch
(``_next_microbatch``), and every request is still bit-identical to the
single-device ``reference_logits`` for any packing, stage count or
arrival order.

The row-granular surface of the replicated front door
(serving/frontend.py) is here too: ``submit_rows`` enqueues one row span
of a request, ``pending_rows`` is the O(1) load the router compares,
``progress_marker`` what its watchdog watches, and ``extract_pending``
the drain half of replica failure recovery.  With a
``repro_torch.obs.Telemetry`` the stages record trace spans and, with
sparsity groups, run the profiled stage programs (units return their
zero-count dicts, which feed ``telemetry.sparsity``);
``reference_profile`` is the single-device oracle of that profile.

The engine runs on the card by default (``device="cuda"``) and raises
when CUDA is absent unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core import partition
from repro_torch.core.compiled_linear import ensure_compiled
from repro_torch.distributed.conv_pipeline import ConvPipeline, PipelineStage
from repro_torch.launch.mesh import local_devices, pipeline_stage_devices
from repro_torch.models.graph import compile_graph
from repro_torch.obs.metrics import LIFE, MetricsRegistry
from repro_torch.obs.sparsity import SparsityProfiler


@dataclasses.dataclass
class PipelineRequest:
    rid: int
    images: np.ndarray                  # (n, H, W, 3) f32
    logits: np.ndarray | None = None
    rows_submitted: int = 0
    rows_done: int = 0
    done: bool = False


@dataclasses.dataclass
class _RowSpan:
    """A contiguous row range of one request waiting in the engine queue;
    ``cursor`` advances as rows enter microbatches.  Whole-request
    submission makes one span; the front door may enqueue several spans
    of one request, possibly on different replicas, and per-row
    quantization domains keep every split bit-identical."""

    req: PipelineRequest
    cursor: int
    stop: int

    @property
    def remaining(self) -> int:
        return self.stop - self.cursor


def _make_stage_fn(unit_fns, profiled: bool = False):
    if profiled:
        # profiled units return (carry, aux); the stage program merges its
        # units' aux dicts (layer names are globally unique) and the pipe
        # feeds them to telemetry.sparsity
        def stage_fn(stage_params, carry):
            aux = {}
            for fn, p in zip(unit_fns, stage_params):
                carry, a = fn(p, carry)
                aux.update(a)
            return carry, aux
    else:
        def stage_fn(stage_params, carry):
            for fn, p in zip(unit_fns, stage_params):
                carry = fn(p, carry)
            return carry
    return stage_fn


@torch.inference_mode()
def reference_logits(params, cfg, x: torch.Tensor,
                     microbatch: int) -> torch.Tensor:
    """The single-device compiled forward at microbatch granularity — the
    bit-identity reference for every stage count and every packing of
    rows into microbatches (domains are per row, so the split here is a
    memory bound, not a numerics choice).  Runs on the device that holds
    ``params`` and ``x``."""
    if x.shape[0] == 0:
        return torch.zeros((0, cfg.num_classes), dtype=torch.float32,
                           device=x.device)
    return torch.cat([cfg.apply(params, x[i:i + microbatch])
                      for i in range(0, x.shape[0], microbatch)])


@torch.inference_mode()
def reference_profile(params, cfg, x, microbatch: int, groups: int):
    """Single-device activation-sparsity oracle: run the PROFILED compiled
    units over ``x`` at microbatch granularity and return ``(logits as
    numpy, SparsityProfiler snapshot)``.  ``params`` must already be
    compiled (``ensure_compiled``) and lie on ``x``'s device (a numpy
    ``x`` runs on the CPU).  The JAX function's ``lowering=`` argument
    pins its lowering switch; the port has none (each op dispatches on
    its tensors' device alone), so on CPU tensors the plain versions are
    the oracle and on CUDA tensors the kernels' epilogues are measured."""
    prof = SparsityProfiler(groups=groups)
    units = compile_graph(cfg.graph(), params, sparsity_groups=groups)
    x = torch.as_tensor(x, dtype=torch.float32)
    outs = []
    for i in range(0, x.shape[0], microbatch):
        mb, aux_all = x[i:i + microbatch], {}
        for u in units:
            mb, aux = u.fn(u.params, mb)
            aux_all.update(aux)
        prof.add(aux_all)
        outs.append(mb.cpu().numpy())
    logits = (np.concatenate(outs) if outs
              else np.zeros((0, cfg.num_classes), np.float32))
    return logits, prof.snapshot()


class PipelineEngine:
    """Persistent pipeline-parallel serving of a compiled conv-DAG.

    ``cfg`` exposes ``graph()`` (a ``models.graph.Graph``), ``apply`` and
    ``num_classes``: ``ResNetConfig``, ``MobileNetV2Config``, or
    ``RepVGGConfig`` with fused params (``cfg.fuse``).  Stages go
    round-robin over ``devices`` (a replica's group, as the front door
    carves them) or, without it, over the devices ``device`` names: every
    visible card for ``"cuda"``."""

    def __init__(self, cfg, params, *, mode: str = "int8",
                 sparsity: float = 0.8, n_stages: int | None = None,
                 stage_blocks=None, plan=None, microbatch: int = 2,
                 device="cuda", devices=None, replica: int = 0,
                 pack_requests: bool = True, telemetry=None):
        devices = (local_devices(device) if devices is None
                   else list(devices))
        assert mode != "dense", "the pipeline serves the compiled network"
        self.cfg = cfg
        self.microbatch = microbatch
        # continuous cross-request batching (sound under per-row
        # domains); False keeps microbatches inside one request
        self.pack_requests = pack_requests
        # params: the boxed training tree (compiled here) or an
        # already-compiled unboxed tree
        self.params = ensure_compiled(params, mode, sparsity)
        self.telemetry = telemetry
        # one registry per engine; the pipe shares it
        self.metrics = MetricsRegistry()
        self._mb_injected = self.metrics.counter("engine.mb_injected")
        self._rows_injected = self.metrics.counter("engine.rows_injected")
        # lifetime odometer (LIFE scope: survives reset_counters): rows
        # delivered back to requests — the front door differences it to
        # estimate the fleet's service rate, and the watchdog reads it in
        # progress_marker
        self._rows_completed = self.metrics.counter(
            "engine.rows_completed", scope=LIFE)
        # activation-sparsity profiling compiles other stage programs
        # (units return (carry, aux)); off by default
        groups = (telemetry.sparsity.groups
                  if telemetry is not None and telemetry.profiled else None)
        self._profiled = groups is not None
        self.graph = cfg.graph()
        units = compile_graph(self.graph, self.params,
                              sparsity_groups=groups)
        n_blocks = len(units) - 1              # head rides the last stage
        self.plan = self._resolve_plan(plan, stage_blocks, n_stages,
                                       n_blocks)
        self.stage_block_ids = [p.block_ids for p in self.plan]
        stage_devices = pipeline_stage_devices(len(self.plan), devices)
        self.pipe = ConvPipeline(
            self._build_stages(units, self.stage_block_ids, stage_devices),
            replica=replica, metrics=self.metrics, telemetry=telemetry)
        self.queue: list[_RowSpan] = []
        # row accounting kept exactly in step with the span queue
        # (_scan_pending_rows is the linear oracle the tests compare), so
        # pending_rows is O(1) for the front door's routing loop
        self._queued_rows = 0
        self._rows_in_flight = 0
        # host-dispatch-gap hint for bubble attribution: rows the FRONT
        # DOOR holds undispatched (the frontend refreshes it every step;
        # a standalone engine leaves it 0)
        self.door_rows = 0

    @property
    def rows_completed(self) -> int:
        return self._rows_completed.value

    # -- stage planning -------------------------------------------------
    def _resolve_plan(self, plan, stage_blocks, n_stages, n_blocks):
        blocks = self.graph.blocks()
        edge_bytes = self.graph.edge_bytes()
        assert len(blocks) == n_blocks, (len(blocks), n_blocks)
        if isinstance(plan, partition.PartitionResult):
            return plan.stage_plans(blocks, n_stages, edge_bytes)
        if plan is not None:                   # explicit StagePlan list
            return list(plan)
        if stage_blocks is not None:           # explicit stage map
            return partition.explicit_stage_plans(blocks, stage_blocks,
                                                  edge_bytes)
        return partition.plan_stages(blocks, n_stages or 1, edge_bytes)

    def _build_stages(self, units, stage_block_ids, devices):
        covered = [b for ids in stage_block_ids for b in ids]
        assert covered == list(range(len(units) - 1)), (
            "stage map must cover blocks 0..%d contiguously" % (len(units) - 2),
            stage_block_ids)
        stages = []
        for s, ids in enumerate(stage_block_ids):
            mine = [u for u in units if u.block_id in ids]
            if s == len(stage_block_ids) - 1:
                mine.append(units[-1])         # the head
            # the stage's device holds ONLY these units' constant weights
            stage_params = nn.to_device(tuple(u.params for u in mine),
                                        devices[s])
            stages.append(PipelineStage(
                index=s, device=devices[s],
                fn=_make_stage_fn(tuple(u.fn for u in mine),
                                  profiled=self._profiled),
                params=stage_params,
                unit_names=tuple(u.name for u in mine)))
        return stages

    # -- request management --------------------------------------------
    def submit(self, req: PipelineRequest):
        """Enqueue a whole request (resets its lifecycle)."""
        req.logits = None
        req.rows_submitted = req.rows_done = 0
        req.done = False
        self.queue.append(_RowSpan(req, 0, len(req.images)))
        self._queued_rows += len(req.images)

    def submit_rows(self, req: PipelineRequest, start: int, stop: int):
        """Enqueue one row span of a request WITHOUT touching its
        lifecycle — the front door's row-granular dispatch: a request's
        rows may be spread over several spans (even on different
        replicas), and per-row quantization domains keep every split
        bit-identical.  The caller owns the lifecycle reset."""
        assert 0 <= start <= stop <= len(req.images), (
            start, stop, len(req.images))
        self.queue.append(_RowSpan(req, start, stop))
        self._queued_rows += stop - start

    def _complete_empty(self, req):
        req.logits = np.zeros((0, self.cfg.num_classes), np.float32)
        req.done = True

    def _next_microbatch(self):
        """Pack up to ``microbatch`` head-of-queue rows into one
        microbatch.  With ``pack_requests`` rows from DIFFERENT requests
        share a microbatch; otherwise a microbatch stops at the first
        span boundary.  Returns (segments, rows): segments are per-row
        request tags ``(request, start_row, n_rows)`` in row order."""
        segs, parts = [], []
        need = self.microbatch
        while self.queue and need > 0:
            span = self.queue[0]
            if span.remaining == 0:            # zero-row request: complete
                if len(span.req.images) == 0:
                    self._complete_empty(span.req)
                self.queue.pop(0)
                continue
            take = min(need, span.remaining)
            segs.append((span.req, span.cursor, take))
            parts.append(span.req.images[span.cursor:span.cursor + take])
            span.cursor += take
            span.req.rows_submitted += take
            self._queued_rows -= take
            need -= take
            if span.remaining == 0:
                self.queue.pop(0)
            if not self.pack_requests:
                break                          # never cross a span boundary
        if not segs:
            return None, None
        rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return segs, torch.as_tensor(np.asarray(rows, np.float32))

    @torch.inference_mode()
    def step(self) -> bool:
        """Inject one microbatch (if any rows are queued) and advance the
        schedule one tick; completed rows scatter back to their segments'
        requests.  Returns False once idle."""
        tag = mb = None
        if self.pipe.inlet_free:
            tag, mb = self._next_microbatch()
        if mb is None and not self.pipe.busy:
            return False
        if mb is not None:
            self._rows_in_flight += int(mb.shape[0])
            self._mb_injected.inc()
            self._rows_injected.inc(int(mb.shape[0]))
        self.pipe.door_rows = self.door_rows
        for segs, out in self.pipe.tick(inject=mb, tag=tag):
            out = out.cpu().numpy()
            off = 0
            for req, start, n in segs:
                if req.logits is None:
                    req.logits = np.zeros((len(req.images), out.shape[-1]),
                                          out.dtype)
                req.logits[start:start + n] = out[off:off + n]
                req.rows_done += n
                req.done = req.rows_done >= len(req.images)
                off += n
            assert off == out.shape[0], (off, out.shape)
            self._rows_in_flight -= out.shape[0]
            self._rows_completed.inc(int(out.shape[0]))
        return True

    def run(self, requests: list) -> list:
        for r in requests:
            self.submit(r)
        while self.step():
            pass
        return requests

    @property
    def pending_rows(self) -> int:
        """Rows accepted but not yet delivered: the queue's unsubmitted
        rows plus the rows still rotating through the stages (a partial
        microbatch counts its real size) — the load the front door's
        least-loaded router compares across replicas.  O(1), kept in
        step incrementally (``_scan_pending_rows`` is its oracle)."""
        return self._queued_rows + self._rows_in_flight

    def _scan_pending_rows(self) -> int:
        """The linear-scan oracle for ``pending_rows`` (tests only)."""
        return sum(sp.remaining for sp in self.queue) + self._rows_in_flight

    # -- health surface (consumed by serving/frontend.py) ----------------
    @property
    def progress_marker(self) -> tuple:
        """A value that changes on EVERY healthy busy step: rows
        delivered, rows queued, rows in flight, and the stage inlets'
        occupancy (a microbatch advancing one stage flips two cells even
        when the counts hold still).  The front door's watchdog fails a
        replica whose marker freezes for ``watchdog_ticks`` steps while
        it has work."""
        return (self.rows_completed, self._queued_rows,
                self._rows_in_flight, self.pipe.inlet_occupancy)

    def extract_pending(self) -> list:
        """Cancel everything this engine still owes and return it as
        ``(request, start, stop)`` row spans — the drain half of replica
        failure recovery: the un-injected queue spans and the rows
        buffered in stage inlets (``ConvPipeline.cancel_in_flight``;
        their ``rows_submitted`` is rewound).  Rows already scattered
        back to their requests are not extracted: per-row quantization
        domains make the re-executed remainder bit-identical to the
        never-failed reference.  Leaves the engine idle."""
        spans = []
        for segs in self.pipe.cancel_in_flight():
            for req, start, n in segs:
                req.rows_submitted -= n
                spans.append((req, start, start + n))
        self._rows_in_flight = 0
        for sp in self.queue:
            if sp.remaining:
                spans.append((sp.req, sp.cursor, sp.stop))
            elif len(sp.req.images) == 0 and not sp.req.done:
                # a queued zero-row request completes here, as
                # _next_microbatch would have
                self._complete_empty(sp.req)
        self.queue.clear()
        self._queued_rows = 0
        return spans

    def run_batch(self, x) -> np.ndarray:
        """Convenience: one anonymous request, returns stacked logits."""
        req = PipelineRequest(rid=-1, images=np.asarray(x))
        self.run([req])
        return req.logits

    def reset_counters(self):
        """Zero the wave-scoped schedule and occupancy counters (idle
        only); the lifetime ``rows_completed`` odometer survives."""
        self.pipe.reset_counters()
        self.metrics.reset_wave()

    def snapshot(self) -> dict:
        """The registry behind ``stats()``: every engine and pipe metric
        (the pipe shares this engine's registry) by name."""
        return self.metrics.snapshot()

    def stats(self) -> dict:
        out = self.pipe.stats()
        out["microbatch"] = self.microbatch
        out["pack_requests"] = self.pack_requests
        out["mb_injected"] = self._mb_injected.value
        out["rows_injected"] = self._rows_injected.value
        # mean fraction of microbatch slots filled (1.0 = the pipe runs
        # full)
        out["microbatch_occupancy"] = (
            self._rows_injected.value
            / (self._mb_injected.value * self.microbatch)
            if self._mb_injected.value else None)
        out["stage_blocks"] = [list(ids) for ids in self.stage_block_ids]
        out["planned_link_bytes"] = [p.link_bytes for p in self.plan[:-1]]
        return out
