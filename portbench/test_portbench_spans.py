"""The readers of the program's own spans (``spans.py`` and
``metrics/{validate,pack,h2d,device_wait,launch,head_launch}_ms.offline``,
``idle_unattributed.offline``, ``compile_s``):

* on a synthetic record, each returns the number it should, and
  ``idle_under_spans`` splits the idle time across nested and absent
  spans;
* the readers the benchmark already has read the same with and without
  the record's two new keys;
* a CPU run of each cell at the tiny size reads every new ``.offline``
  metric but the card's;
* on the card (``cuda``), the trace's clock lands on the profiler's:
  each ``wait`` ends just after the last device event before it, and
  each ``h2d`` holds its host-to-device copy.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import bench, devtrace, models, spans

CELLS = ("resnet50-sparse80.offline", "resnet50-int8.offline")
NEW = ("validate_ms.offline", "pack_ms.offline", "h2d_ms.offline",
       "device_wait_ms.offline", "launch_ms.offline",
       "head_launch_ms.offline", "idle_unattributed.offline", "compile_s")
MS = 1e-3
NS = 10 ** 6            # ns in a ms


def fake_trace():
    """A ``Trace`` whose clock reads 1.0 s at every sync, paired with
    1e18 ns, so that clock second t maps to 1e18 + (t - 1) * 1e9 ns."""
    from repro_torch.obs.trace import Trace
    return Trace(clock=lambda: 1.0, unix_ns=lambda: 10 ** 18)


def at(ms: float) -> float:
    """Clock seconds of ``ms`` past the window's start (clock 1.0 s)."""
    return 1.0 + ms * MS


def to_ns(ms: float) -> int:
    return 10 ** 18 + round(ms * NS)


def synthetic_rec(loop="closed"):
    """A 100 ms window: one door step [10, 60] holding an engine step
    [20, 60] with pack [20, 30], h2d [30, 32], stage0 [32, 50] (units
    stem [32, 40] and head [40, 50]) and wait [50, 60]; then the next
    request's admission [70, 76] holding validate [70, 75]; a request
    waiting in the queue all window long; a compile before the window.
    The card is busy [30, 35] and [45, 55]."""
    tr = fake_trace()
    tr.span("compile", "setup", 0, 0, at(-500), at(-100), mode="int8")
    tr.span("queue", "request", 0, 7, at(0), at(100), rid=7)
    tr.span("step", "door", 0, 0, at(10), at(60), step=1)
    tr.span("engine.step", "engine", 1, -1, at(20), at(60), mb=1)
    tr.span("pack", "engine", 1, -1, at(20), at(30), mb=1)
    tr.span("h2d", "engine", 1, -1, at(30), at(32), mb=1)
    tr.span("stage0", "pipeline", 1, 0, at(32), at(50), mb=1, rows=4)
    tr.span("stem", "unit", 1, 0, at(32), at(40), mb=1)
    tr.span("head", "unit", 1, 0, at(40), at(50), mb=1)
    tr.span("wait", "engine", 1, -1, at(50), at(60), mb=1)
    tr.span("admission", "request", 0, 8, at(70), at(76), rid=8)
    tr.span("validate", "door", 0, 8, at(70), at(75), rid=8)
    tr.span("validate", "door", 0, 9, at(90), at(93), rid=9)
    win = bench.Window()
    win.t0, win.t_close = at(0), at(100)
    config = json.loads((bench.ROOT / "portbench" / "configs"
                         / "resnet50-int8.json").read_text())
    return {
        "window": win, "loop": loop, "config": config,
        "arch": models.load("resnet50"), "setup_s": 9.5, "window_s": 0.1,
        "images_done": 1024, "requests": 4, "latency_s": [0.05, 0.06],
        "step_s": [0.05, 0.04], "occupancy": 1.0,
        "microbatch_rows": [512, 512],
        "device_trace": {
            "busy_s": 0.015, "launches": 4400,
            "by_name": {"conv_mma_kernel<false, 16>": 0.004,
                        "conv_mma_kernel<true, 16>": 0.003,
                        "Memcpy HtoD (Pageable -> Device)": 0.002},
            "top_ops": [], "idle_gaps": []},
        "trace": tr,
    }


def with_busy(rec):
    rec["device_trace"]["busy"] = [[to_ns(30), to_ns(35)],
                                   [to_ns(45), to_ns(55)]]
    return rec


def test_idle_splits_across_nested_and_absent_spans():
    got = spans.idle_under_spans(with_busy(synthetic_rec()))
    # idle [0, 30], [35, 45], [55, 100]; no span open over [0, 10],
    # [60, 70], [76, 90] and [93, 100]; the waiting request is no cause
    want = {"": 10 + 10 + 14 + 7, "step": 10, "pack": 10, "stem": 5,
            "head": 5, "wait": 5, "validate": 5 + 3, "admission": 1}
    want = {k: v * MS for k, v in want.items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k
    assert sum(got.values()) == pytest.approx(0.1 - 0.015, abs=1e-9)


def test_each_new_reader_reads_what_it_should():
    rec = with_busy(synthetic_rec())
    want = {"validate_ms.offline": 4.0, "pack_ms.offline": 10.0,
            "h2d_ms.offline": 2.0, "device_wait_ms.offline": 10.0,
            "launch_ms.offline": 18.0, "head_launch_ms.offline": 10.0,
            "idle_unattributed.offline": 100.0 * 0.041 / 0.1,
            "compile_s": 0.4}
    for name in NEW:
        assert bench.reader(name)(rec) == pytest.approx(
            want[name], rel=1e-9), name
    rec["loop"] = "open"
    assert [bench.reader(n)(rec) for n in NEW[:-1]] == [None] * 7
    assert bench.reader("compile_s")(rec) == pytest.approx(0.4)


@pytest.mark.parametrize("missing", ["trace", "busy", "mapping"])
def test_new_readers_read_nothing_without_their_keys(missing):
    """A record of a harness that adds neither key, or of a program
    whose trace cannot be put on the profiler's clock, reads as
    nothing."""
    rec = with_busy(synthetic_rec())
    if missing == "trace":
        del rec["trace"]
    elif missing == "busy":
        del rec["device_trace"]["busy"]
    else:
        rec["trace"] = SimpleNamespace(spans=rec["trace"].spans,
                                       us=rec["trace"].us)
    reads = {n: bench.reader(n)(rec) for n in NEW}
    assert reads["idle_unattributed.offline"] is None
    if missing == "trace":
        assert set(reads.values()) == {None}


def test_existing_readers_read_the_same_with_the_new_keys():
    spec = bench.load_spec()
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert not set(names) & set(NEW)
    rec = synthetic_rec()
    del rec["trace"]
    before = {n: bench.reader(n)(rec) for n in names}
    after = {n: bench.reader(n)(with_busy(synthetic_rec())) for n in names}
    assert before == after
    assert sum(v is not None for v in before.values()) == len(names) - 1


def traced_record(mp, captured=None):
    """Patch ``bench.record`` to add the two keys (and keep the window's
    device events, and every copy kineto saw, device or host call, in
    ``captured``)."""
    record = bench.record

    def wrapped(win, mix, config, arch, setup_s, telemetry, prof, pclock):
        rec = record(win, mix, config, arch, setup_s, telemetry, prof,
                     pclock)
        if captured is not None and prof is not None:
            kr = prof.profiler.kineto_results
            captured["events"] = devtrace.window_events(
                devtrace.device_events(kr), pclock.to_ns(win.t0),
                pclock.to_ns(win.t_close))
            cuda = torch.autograd.DeviceType.CUDA
            captured["copies"] = [
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
                 e.device_type() == cuda, e.correlation_id())
                for e in kr.events() if "emcpy" in e.name()]
        return spans.add_span_keys(rec, telemetry, prof, pclock)
    mp.setattr(bench, "record", wrapped)


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_traced_run_reads_every_new_metric_but_the_cards(tiny_root,
                                                              workload):
    with pytest.MonkeyPatch.context() as mp:
        traced_record(mp)
        out, rec = bench.run_cell(workload, 2 ** 31 + 5, 0.6, True,
                                  t_process=time.perf_counter(),
                                  root=tiny_root, device="cpu")
    assert out["correct"], out["checks"]
    reads = {n: bench.reader(n, tiny_root)(rec) for n in NEW}
    assert reads.pop("idle_unattributed.offline") is None
    for name, v in reads.items():
        assert v is not None and v > 0, (name, v)
    assert len(spans.window_spans(rec, "validate")) >= 1
    assert len(spans.window_spans(rec, "pack")) == len(
        rec["microbatch_rows"])


def clock_readings(workload: str, seconds: float = 10.0) -> dict:
    """One traced window of the cell on the card, read against the
    profiler: for each ``h2d`` span the ``cudaMemcpyAsync`` call kineto
    records on the host for its copy (slack each side, ms) and how far
    the device copy's end sits from the call's end; for each ``wait``
    span its lag after the last device event before it; for each ``h2d``
    span its slack to the device copy."""
    torch.set_num_threads(2)
    captured = {}
    with pytest.MonkeyPatch.context() as mp:
        traced_record(mp, captured)
        out, rec = bench.run_cell(workload, 2 ** 31 + 3517, seconds, True,
                                  t_process=time.perf_counter(),
                                  device="cuda")
    tr, ev = rec["trace"], captured["events"]
    tol = 0.5 * NS

    def ns(t_us):
        return tr.to_unix_ns(tr.t0 + t_us / 1e6)

    on_card = {c: (s, e) for s, e, n, dev, c in captured["copies"]
               if dev and "HtoD" in n}
    calls = {c: (s, e) for s, e, n, dev, c in captured["copies"]
             if not dev and c in on_card}
    h2d = spans.window_spans(rec, "h2d")
    call_slack, drift, missing = [], [], 0
    for h in h2d:
        b, e = ns(h.ts), ns(h.ts + h.dur)
        mine = [c for c, (cs, ce) in calls.items() if cs < e and ce > b]
        if not mine:
            missing += 1
            continue
        c = max(mine, key=lambda c: on_card[c][1] - on_card[c][0])
        call_slack += [(calls[c][0] - b) / NS, (e - calls[c][1]) / NS]
        drift.append((on_card[c][1] - calls[c][1]) / NS)
    ends = sorted(e for _, e, _ in ev)
    lags = []
    for w in spans.window_spans(rec, "wait"):
        end = ns(w.ts + w.dur)
        before = [x for x in ends if x <= end]
        lags.append((end - before[-1]) / NS if before else float("inf"))
    copies = [(s, e) for s, e, n in ev if "HtoD" in n]
    slack = []
    for h in h2d:
        b, e = ns(h.ts), ns(h.ts + h.dur)
        near = [(cs, ce) for cs, ce in copies
                if ce > b - tol and cs < e + tol]
        if not near:
            slack.append(float("-inf"))
            continue
        cs, ce = max(near, key=lambda c: c[1] - c[0])
        slack += [(cs - b) / NS, (e - ce) / NS]
    return {"correct": out["correct"], "h2d": len(h2d), "missing": missing,
            "call_slack": call_slack, "drift": drift, "lags": lags,
            "slack": slack}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_trace_clock_lands_on_the_profilers_clock(workload):
    """A 10 s traced window of the cell on the card (25-50 microbatches,
    so that 95 % is a share of many), in a process of its own as the
    benchmark runs a cell: in a process's second profiler session kineto
    has missed the window's first events and let its device clock drift.
    On the profiler's host clock, each ``h2d`` span holds the
    ``cudaMemcpyAsync`` call kineto records for its copy to within
    0.5 ms.  On its device events, each ``wait`` span ends within 0.5 ms
    after the last device event before it (the logits' copy back) in at
    least 95 % of microbatches, and each ``h2d`` span holds its
    host-to-device copy to within 0.5 ms.  Kineto puts device events on
    its host clock through CUPTI's timestamps; how far a device copy's
    end sits from its call's end, first and last, is printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    code = ("import json\n"
            "from portbench.test_portbench_spans import clock_readings\n"
            f"print('READ ' + json.dumps(clock_readings({workload!r})))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        str(p) for p in (bench.ROOT / "src", bench.ROOT))}
    res = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    r = json.loads(next(line for line in res.stdout.splitlines()
                        if line.startswith("READ "))[5:])
    lags, slack, drift = r["lags"], r["slack"], r["drift"]
    assert r["correct"] and lags and slack and drift, r
    print(f"{workload}: {r['h2d'] - r['missing']} of {r['h2d']} h2d hold "
          f"their copy call, least slack ms {min(r['call_slack']):.4f}; "
          f"device copy end less call end ms first {drift[0]:.4f} last "
          f"{drift[-1]:.4f}; {len(lags)} waits, lag after the last device "
          f"event ms median {statistics.median(lags):.4f} max "
          f"{max(lags):.4f}, {sum(lag <= 0.5 for lag in lags)} within "
          f"0.5 ms; least slack of h2d to the device copy ms "
          f"{min(slack):.4f}", flush=True)
    assert r["missing"] == 0 and min(r["call_slack"]) >= -0.5
    assert sum(lag <= 0.5 for lag in lags) >= 0.95 * len(lags)
    assert min(slack) >= -0.5
