"""Pipeline-parallel conv execution — the executable Fig 7 (ports
``repro/distributed/conv_pipeline.py``).

The paper's multi-chip deployment is a *layer pipeline*: each chip holds
one contiguous slice of the network as constant parameters (persistent
weights), 8-bit feature maps cross the chip boundaries, and every chip
processes a different image at once.  Here:

* each ``PipelineStage`` owns a device-resident, disjoint subtree of the
  compiled parameters (only its own units' constant weights) and one
  stage program;
* edges carry the quantization-domain pair ``(int8 activations, f32
  scale)``; per-edge payload bytes are *measured* from the tensors
  actually moved and cross-checked against ``partition.StagePlan``;
* microbatches rotate through the stages on a GPipe-style fill/steady/
  drain schedule (``tick``).  Stages are visited in reverse order, so a
  stage's launch for microbatch ``m`` and the move of ``m+1`` into its
  inlet are issued in the same tick; CUDA launches are asynchronous, so
  nothing blocks until the caller reads an output.

Bubble accounting: M microbatches over S stages run ``M + S - 1`` ticks;
every idle stage-tick is attributed to exactly one cause — ``fill``,
``starved``, ``drain`` or ``host`` — so the per-cause counts sum to
``S*ticks - launches``.

With a ``repro_torch.obs.Telemetry`` attached, each busy stage-tick
records a span (pid ``1 + replica``, tid = stage) covering the host-side
launch window, the injection's copy to stage 0's device an ``h2d`` span
on the replica's host thread, both with the microbatch's number ``mb``
(``inject_mb``, set by the engine), and profiled stage programs'
zero-count dicts feed ``telemetry.sparsity``.  Idle stage-ticks are the
``pipe.stage{s}.idle.{cause}`` counters and edge payloads ``stats()``'s
``edge_bytes``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import HOST_TID

# every idle stage-tick gets exactly one of these (DESIGN.md §11)
BUBBLE_CAUSES = ("fill", "starved", "drain", "host")


@dataclasses.dataclass
class PipelineStage:
    """One device's slice of the network: stage program + resident
    params."""

    index: int
    device: object
    fn: object                 # (stage_params, carry) -> carry
    params: object             # device-resident param subtree (disjoint)
    unit_names: tuple

    def weight_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in nn.tree_leaves(self.params)
                       if isinstance(t, torch.Tensor)))


def carry_bytes(carry) -> dict:
    """Measured payload of one edge transfer: int8 feature-map bytes vs
    everything else (the f32 scale scalar)."""
    int8_b = meta_b = 0
    for leaf in nn.tree_leaves(carry):
        nbytes = leaf.numel() * leaf.element_size()
        if leaf.dtype == torch.int8:
            int8_b += nbytes
        else:
            meta_b += nbytes
    return {"int8_bytes": int(int8_b), "meta_bytes": int(meta_b)}


class ConvPipeline:
    """Rotating-microbatch schedule over per-device pipeline stages.

    ``tick(inject=None, tag=None)`` advances every stage by one
    microbatch slot and returns the ``(tag, output)`` pairs that left the
    last stage this tick; ``serving.pipeline.PipelineEngine`` drives the
    fill/steady/drain loop and consumes ``stats()``.
    """

    def __init__(self, stages: list, replica: int = 0, metrics=None,
                 telemetry=None):
        self.stages = stages
        self.replica = replica          # which fleet replica owns this chain
        self.n_stages = len(stages)
        self._inlet = [None] * self.n_stages    # per-stage input buffer
        self._tags = [None] * self.n_stages
        # microbatch numbers riding with the inlets (trace args): the
        # engine sets inject_mb before a tick that injects; a traced tick
        # lists the numbers of the microbatches it completes in done_mbs
        self._mbs = [None] * self.n_stages
        self.inject_mb = None
        self.done_mbs = []
        self.edge_bytes: list = [None] * max(self.n_stages - 1, 0)
        # schedule counters live in the registry (shared with the owning
        # engine when it passes its own)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._ticks = m.counter("pipe.ticks")
        self._mb_done = m.counter("pipe.microbatches_done")
        self._launches = [m.counter(f"pipe.stage{s}.launches")
                          for s in range(self.n_stages)]
        self._idle = {c: [m.counter(f"pipe.stage{s}.idle.{c}")
                          for s in range(self.n_stages)]
                      for c in BUBBLE_CAUSES}
        # attribution state: has stage s launched since the pipe was last
        # empty?  (distinguishes fill from starved)
        self._seen = [False] * self.n_stages
        # host-dispatch-gap hint: rows a front door holds undispatched
        # (0 for a standalone engine)
        self.door_rows = 0
        self.telemetry = telemetry
        self._profiled = bool(telemetry is not None and telemetry.profiled)
        tr = telemetry.trace if telemetry is not None else None
        self._trace = tr
        if tr is not None:
            pid = 1 + replica
            tr.name_process(pid, f"replica {replica}")
            for s in range(self.n_stages):
                tr.name_thread(pid, s, f"stage {s}")

    @property
    def ticks(self) -> int:
        return self._ticks.value

    @property
    def microbatches_done(self) -> int:
        return self._mb_done.value

    @property
    def busy(self) -> bool:
        return any(b is not None for b in self._inlet)

    @staticmethod
    def _tag_args(tag) -> dict:
        """Span args from an engine segment tag (best-effort: direct
        ``ConvPipeline`` users may pass arbitrary tags)."""
        try:
            return {"rids": [req.rid for req, _, _ in tag],
                    "rows": sum(n for _, _, n in tag)}
        except (TypeError, ValueError, AttributeError):
            return {}

    def tick(self, inject=None, tag=None) -> list:
        """One schedule step.  ``inject`` (optional) enters stage 0's
        inlet and is computed this tick; returns completed ``(tag, out)``
        pairs (possibly empty during fill).  Raises if stage 0 is still
        busy — callers gate injection on ``inlet_free``.  M microbatches
        over S stages complete in exactly M + S - 1 ticks."""
        done = []
        self._ticks.inc()
        tel = self.telemetry
        tr = self._trace
        pid = 1 + self.replica
        if tr is not None:
            self.done_mbs = []
        if inject is not None:
            assert self._inlet[0] is None, "stage 0 inlet busy"
            t_begin = tr.now() if tr is not None else 0.0
            self._inlet[0] = nn.to_device(inject, self.stages[0].device)
            if tr is not None:
                tr.span("h2d", "engine", pid, HOST_TID, t_begin, tr.now(),
                        mb=self.inject_mb,
                        bytes=inject.numel() * inject.element_size(),
                        pinned=inject.is_pinned())
            self._tags[0] = tag
            self._mbs[0] = self.inject_mb
        # bubble attribution over the post-injection occupancy: every
        # stage-tick is either a launch or gets exactly ONE idle cause
        occ = [b is not None for b in self._inlet]
        for s, busy_s in enumerate(occ):
            if busy_s:
                self._launches[s].inc()
                self._seen[s] = True
                continue
            if not any(occ[:s]):
                cause = ("host" if s == 0 and self.door_rows > 0
                         else "drain")
            else:
                cause = "starved" if self._seen[s] else "fill"
            self._idle[cause][s].inc()
        # reverse stage order: stage s launches on the microbatch its
        # inlet buffered, then frees the inlet for the predecessor's
        # output issued later in this same tick
        for s in reversed(range(self.n_stages)):
            if self._inlet[s] is None:
                continue
            stage = self.stages[s]
            carry, t, m = self._inlet[s], self._tags[s], self._mbs[s]
            self._inlet[s] = None
            if tr is None:
                out = stage.fn(stage.params, carry)
            else:
                t_begin = tr.now()
                out = stage.fn(stage.params, carry, mb=m)
            if self._profiled:
                out, aux = out
                tel.sparsity.add(aux, count_microbatch=(s == 0))
            if tr is not None:
                # the span covers the host-side launch window (CUDA
                # launches are asynchronous; a sync here would serialize
                # the very overlap the pipe exists for)
                tr.span(f"stage{s}", "pipeline", pid, s, t_begin,
                        tr.now(), tick=self._ticks.value, mb=m,
                        **self._tag_args(t))
            if s + 1 < self.n_stages:
                if self.edge_bytes[s] is None:
                    self.edge_bytes[s] = carry_bytes(out)
                out = nn.to_device(out, self.stages[s + 1].device)
                self._inlet[s + 1], self._tags[s + 1] = out, t
                self._mbs[s + 1] = m
            else:
                self._mb_done.inc()
                done.append((t, out))
                if tr is not None:
                    self.done_mbs.append(m)
        if not self.busy:
            # pipe drained: the next wave's early idle stage-ticks are
            # fill again, not starvation
            self._seen = [False] * self.n_stages
        return done

    @property
    def inlet_free(self) -> bool:
        return self._inlet[0] is None

    @property
    def inlet_occupancy(self) -> tuple:
        """Which stage inlets hold a buffered microbatch — a microbatch
        advancing one stage flips two cells, so any healthy busy tick
        changes this pattern.  Part of the progress marker the serving
        front-end's per-replica watchdog compares."""
        return tuple(b is not None for b in self._inlet)

    def cancel_in_flight(self) -> list:
        """Drop every buffered microbatch and return their tags (the
        per-row segment lists the engine injected) so the caller can
        requeue the rows elsewhere — the drain half of replica failure
        recovery.  Cancelled microbatches never reach
        ``microbatches_done``; the chain is idle afterwards."""
        tags = []
        for s in range(self.n_stages):
            if self._inlet[s] is not None and self._tags[s] is not None:
                tags.append(self._tags[s])
            self._inlet[s] = None
            self._tags[s] = None
            self._mbs[s] = None
        self._seen = [False] * self.n_stages
        return tags

    def reset_counters(self):
        """Zero the schedule counters so the next wave's stats stand
        alone; only legal while idle."""
        assert not self.busy, "reset_counters with microbatches in flight"
        self._ticks.reset()
        self._mb_done.reset()
        for c in self._launches:
            c.reset()
        for per_stage in self._idle.values():
            for c in per_stage:
                c.reset()
        self._seen = [False] * self.n_stages

    @property
    def in_flight(self) -> int:
        """Microbatches currently buffered in stage inlets."""
        return sum(b is not None for b in self._inlet)

    def stats(self) -> dict:
        s, m = self.n_stages, self.microbatches_done
        total = s * self.ticks
        launches = [c.value for c in self._launches]
        return {
            "replica": self.replica,
            "n_stages": s,
            "in_flight": self.in_flight,
            "microbatches": m,
            "ticks": self.ticks,
            "bubble_fraction": 1.0 - (s * m) / total if total else 0.0,
            "bubble_fraction_analytic": (s - 1) / (m + s - 1) if m else 0.0,
            # which stage, which cause, for every idle stage-tick: the
            # per-cause counts sum to S*ticks - sum(launches) exactly
            "stage_launches": launches,
            "bubble_attribution": {
                cause: [c.value for c in per_stage]
                for cause, per_stage in self._idle.items()},
            "idle_stage_ticks": total - sum(launches),
            "edge_bytes": list(self.edge_bytes),
            "stage_weight_bytes": [st.weight_bytes() for st in self.stages],
            "stage_devices": [str(st.device) for st in self.stages],
        }
