"""The spans inside the port's serving path (``repro_torch.obs.trace``,
``serving/frontend.py``, ``serving/pipeline.py``,
``distributed/conv_pipeline.py``) on the CPU, with a fake clock that
steps by a microsecond a read, so that every span nests strictly:

* the door's ``validate`` inside the request's ``admission``;
* the door loop's ``step`` holding ``dispatch_rows`` and ``collect``;
* each engine step holding ``pack``, ``h2d``, the stage spans, ``wait``
  and ``scatter``, joined by the microbatch number ``mb`` and the request
  ids;
* one ``unit`` span per graph unit inside each stage span, and one
  ``compile`` span;
* the Chrome export valid, with its clock pairs;
* untraced, the engine and the pipe never read a clock;
* ``Trace.to_unix_ns`` interpolating between its two clock pairs.
"""
import itertools
import time

import numpy as np
import pytest
import torch

from repro_torch.models.resnet import ResNetConfig
from repro_torch.obs import Telemetry
from repro_torch.obs.trace import (DOOR_TID, HOST_TID, Trace,
                                   validate_chrome_trace)
from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
from repro_torch.serving.pipeline import PipelineEngine, PipelineRequest

CFG = ResNetConfig(width_mult=0.125, num_classes=4, in_hw=8)
POOL = np.random.RandomState(3).randn(16, 8, 8, 3).astype(np.float32)
MB = 2
ROW_BYTES = 8 * 8 * 3 * 4
# (rid, first row, rows): 7 rows in microbatches of 2, so rows of two
# requests share a microbatch
SPANS = ((0, 0, 3), (1, 3, 1), (2, 4, 3))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_params = {}


def params():
    if "p" not in _params:
        _params["p"] = CFG.init(torch.Generator().manual_seed(0))
    return _params["p"]


def fake_clock(step=1e-6):
    ticks = itertools.count(1)
    return lambda: next(ticks) * step


def traced_wave(n_stages):
    clock = fake_clock()
    tr = Trace(clock=clock, unix_ns=lambda: 10 ** 18)
    tel = Telemetry(trace=tr, clock=clock)
    fe = ResNetFrontend(CFG, params(), mode="int8", n_replicas=1,
                        n_stages=n_stages, microbatch=MB, device="cpu",
                        telemetry=tel)
    reqs = [FrontendRequest(rid=r, images=POOL[a:a + n])
            for r, a, n in SPANS]
    fe.run(reqs)
    assert all(r.done for r in reqs)
    return fe, tr, reqs


def named(tr, name, pid=None, tid=None):
    return [s for s in tr.spans if s.name == name
            and (pid is None or s.pid == pid)
            and (tid is None or s.tid == tid)]


def inside(child, parent):
    return (parent.ts <= child.ts
            and child.ts + child.dur <= parent.ts + parent.dur)


@pytest.mark.parametrize("n_stages", [1, 2])
def test_validate_inside_admission(n_stages):
    _, tr, reqs = traced_wave(n_stages)
    for req in reqs:
        (v,) = named(tr, "validate", 0, req.rid)
        (adm,) = named(tr, "admission", 0, req.rid)
        assert v.cat == "door" and inside(v, adm)
        assert v.ts == adm.ts                  # t_submit stamped first
        rows = len(req.images)
        assert v.args == {"rid": req.rid, "rows": rows,
                          "bytes": rows * ROW_BYTES}
        assert tr.us(req.t_submit) == v.ts


@pytest.mark.parametrize("n_stages", [1, 2])
def test_door_loop_steps_hold_dispatch_and_collect(n_stages):
    fe, tr, _ = traced_wave(n_stages)
    steps = named(tr, "step", 0, DOOR_TID)
    assert [s.args["step"] for s in steps] == list(
        range(1, fe.metrics.get("door.steps").value + 1))
    for name in ("dispatch_rows", "collect"):
        spans = named(tr, name, 0, DOOR_TID)
        assert len(spans) == len(steps)
        for s, step in zip(spans, steps):
            assert s.cat == "door" and inside(s, step)
            assert s.args["step"] == step.args["step"]
    collected = [r for s in named(tr, "collect", 0, DOOR_TID)
                 for r in s.args["rids"]]
    assert sorted(collected) == [r for r, _, _ in SPANS]


@pytest.mark.parametrize("n_stages", [1, 2])
def test_engine_spans_inside_engine_steps_joined_by_mb(n_stages):
    fe, tr, reqs = traced_wave(n_stages)
    host = named(tr, "engine.step", 1, HOST_TID)
    n_mb = -(-sum(n for _, _, n in SPANS) // MB)
    assert len(host) == n_mb + n_stages - 1
    by_mb = {}
    for name, tid in (("pack", HOST_TID), ("h2d", HOST_TID),
                      ("stage0", 0), (f"stage{n_stages - 1}", n_stages - 1),
                      ("wait", HOST_TID), ("scatter", HOST_TID)):
        spans = named(tr, name, 1, tid)
        assert len(spans) == n_mb, name
        for s in spans:
            assert sum(inside(s, h) for h in host) == 1, (name, s)
            by_mb.setdefault(s.args["mb"], {})[name] = s
    assert sorted(by_mb) == list(range(1, n_mb + 1))
    rids = {r.rid: r for r in reqs}
    for mb, spans in by_mb.items():
        pack, h2d = spans["pack"], spans["h2d"]
        last = spans[f"stage{n_stages - 1}"]
        rows = pack.args["rows"]
        assert h2d.args == {"mb": mb, "bytes": rows * ROW_BYTES,
                            "pinned": False}
        assert pack.args["bytes"] == (rows * ROW_BYTES
                                      if pack.args["parts"] > 1 else 0)
        assert spans["stage0"].args["rows"] == rows == last.args["rows"]
        assert spans["scatter"].args["rids"] == last.args["rids"]
        assert all(r in rids for r in last.args["rids"])
        assert pack.ts < h2d.ts < spans["stage0"].ts
        assert last.ts < spans["wait"].ts < spans["scatter"].ts
    assert any(s["pack"].args["parts"] == 2 for s in by_mb.values())


@pytest.mark.parametrize("n_stages", [1, 2])
def test_one_unit_span_per_graph_unit_inside_each_stage(n_stages):
    fe, tr, _ = traced_wave(n_stages)
    stages = fe.replicas[0].pipe.stages
    assert [u for st in stages for u in st.unit_names][-1] == "head"
    for st in stages:
        for stage_span in named(tr, f"stage{st.index}", 1, st.index):
            units = sorted((s for s in tr.spans if s.cat == "unit"
                            and s.pid == 1 and s.tid == st.index
                            and inside(s, stage_span)),
                           key=lambda s: s.ts)
            assert tuple(s.name for s in units) == st.unit_names
            assert {s.args["mb"] for s in units} == {
                stage_span.args["mb"]}
    (compile_span,) = named(tr, "compile", 0, DOOR_TID)
    assert compile_span.cat == "setup"
    assert compile_span.args == {"mode": "int8", "sparsity": 0.8}


def test_export_validates_with_clock_pairs(tmp_path):
    _, tr, _ = traced_wave(2)
    obj = tr.to_chrome_trace()
    assert validate_chrome_trace(obj) == []
    sync = obj["otherData"]["clock_sync"]
    assert len(sync) == 2 and sync[0]["ts_us"] < sync[1]["ts_us"]
    assert all(p["unix_ns"] == 10 ** 18 for p in sync)
    rows = [e["args"]["rows"] for e in obj["traceEvents"]
            if e["ph"] == "B" and e["name"] == "stage0"]
    assert rows and all(r in (1, 2) for r in rows)
    names = {e["name"] for e in obj["traceEvents"] if e["ph"] == "B"}
    assert {"validate", "step", "engine.step", "pack", "h2d", "wait",
            "scatter", "compile", "stem", "head"} <= names
    assert not any(e["ph"] == "i" for e in obj["traceEvents"])


def _raise(*a, **kw):
    raise AssertionError("a clock was read with tracing off")


@pytest.mark.parametrize("telemetry", [None, "profiled"])
def test_untraced_engine_and_pipe_read_no_clock(telemetry):
    tel = (None if telemetry is None
           else Telemetry(sparsity_groups=4, clock=_raise))
    eng = PipelineEngine(CFG, params(), mode="int8", n_stages=2,
                         microbatch=MB, device="cpu", telemetry=tel)
    reqs = [PipelineRequest(rid=r, images=POOL[a:a + n])
            for r, a, n in SPANS]
    with pytest.MonkeyPatch.context() as mp:
        for name in ("perf_counter", "perf_counter_ns", "time", "time_ns",
                     "monotonic", "monotonic_ns"):
            mp.setattr(time, name, _raise)
        eng.run(reqs)
    assert all(r.done for r in reqs)
    assert eng.pipe.done_mbs == []


def test_to_unix_ns_interpolates_between_its_two_pairs():
    reads = iter([5.0, 10.0, 10.5, 20.0, 20.5])
    unix = iter([1_000_000_000_000, 1_000_000_000_000 + 10 * 10 ** 9 + 1000])
    tr = Trace(clock=lambda: next(reads), unix_ns=lambda: next(unix))
    assert tr.t0 == 5.0
    u0 = 1_000_000_000_000
    # one pair: the offset at the midpoint of the clock reads
    assert tr.sync_pairs[0] == (10.25, u0)
    assert tr.to_unix_ns(15.25) == u0 + 5 * 10 ** 9
    tr.sync_point()
    assert tr.sync_pairs[1] == (20.25, u0 + 10 * 10 ** 9 + 1000)
    # two pairs: 1000 ns of drift over 10 s, half of it at the middle
    assert tr.to_unix_ns(15.25) == u0 + 5 * 10 ** 9 + 500
    assert tr.to_unix_ns(20.25) == u0 + 10 * 10 ** 9 + 1000
    assert tr.to_unix_ns(10.25) == u0
