"""One run of one cell: set-up, the measured window, the check of what
the window served, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by its name in ``BENCHMARK.json``: the configuration's file (its
``file``), the module of the architecture that file names
(``models/<arch>.py``), ``traffic/<mix>.json``, and
``metrics/<metric>.py``, a reader ``read(rec) -> number | None`` of the
run's record.  A reader that finds nothing to read returns None and the
metric is left out of the line.

The program is driven only through the front door that the architecture
module builds (for the CNNs ``repro_torch.serving.frontend
.ResNetFrontend``'s ``submit`` / ``step``); from it the benchmark takes
the served logits, the engine's counters, the trace spans of its
``obs.Telemetry`` and the names of its kernels.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import devtrace, models, traffic

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0             # how long past the close a due answer may take
CHECK_ROWS = 64            # served rows compared with the reference
TRACE_CAPACITY = 2_000_000


# ---------------------------------------------------------------------------
# The cell, found by name
# ---------------------------------------------------------------------------

def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(spec: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, mix) of a workload name, each read from the
    file its name leads to."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((Path(root) / entry["file"]).read_text())
    if config.get("name") != entry["name"]:
        raise ValueError(f"{entry['file']} names {config.get('name')!r}, "
                         f"not {entry['name']!r}")
    mix = traffic.load(Path(root) / "portbench" / "traffic"
                       / f"{cell['traffic']}.json")
    return cell, config, mix


def cell_metrics(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str, root: Path = ROOT):
    path = Path(root) / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sync(device: str):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

class Window:
    """What the measured window saw, on the host clock."""

    def __init__(self):
        self.t0 = self.t_close = None
        self.sent = []           # [rid, pool offset, rows, due]
        self.done = {}           # rid -> completion time
        self.reqs = {}           # rid -> request (its logits)
        self.step_s = []         # every step of the window
        self.images_done = 0     # images answered within the window
        self.host_spans = []     # [name, begin, end]
        self.occupancy = None


def _harvest(win: Window, open_reqs: list, t: float) -> list:
    """Move the answered requests out of ``open_reqs``; return them."""
    done = [r for r in open_reqs if r.done]
    if done:
        open_reqs[:] = [r for r in open_reqs if not r.done]
        for r in done:
            win.done[r.rid] = t
    return done


def closed_loop(fe, arch, mix: dict, seed: int, seconds: float, pool,
                clock, win: Window, spans: bool):
    gen = traffic.ClosedLoop(mix, seed, len(pool))
    open_reqs, rid = [], 0

    def send(now):
        nonlocal rid
        off = gen.next_offset()
        r = arch.request(rid, pool[off:off + gen.rows])
        fe.submit(r)
        win.sent.append([rid, off, gen.rows, now - win.t0])
        win.reqs[rid] = r
        open_reqs.append(r)
        if spans:
            win.host_spans.append(["submit", now, clock()])
        rid += 1

    win.t0 = clock()
    for _ in range(gen.clients):
        send(clock())
    deadline = win.t0 + seconds
    while True:
        b = clock()
        fe.step()
        e = clock()
        win.step_s.append(e - b)
        if spans:
            win.host_spans.append(["step", b, e])
        for r in _harvest(win, open_reqs, e):
            win.images_done += gen.rows
            if e < deadline:
                send(clock())
        if e >= deadline:
            win.t_close = e
            return open_reqs


def open_loop(fe, arch, mix: dict, seed: int, seconds: float, pool,
              clock, win: Window, spans: bool):
    plan = traffic.open_plan(mix, seed, seconds, len(pool))
    open_reqs, i = [], 0
    win.t0 = clock()
    while True:
        now = clock() - win.t0
        if i < len(plan) and plan[i][0] <= now:
            b = clock()
            while i < len(plan) and plan[i][0] <= now:
                due, off, rows = plan[i]
                r = arch.request(i, pool[off:off + rows])
                fe.submit(r)
                win.sent.append([i, off, rows, due])
                win.reqs[i] = r
                open_reqs.append(r)
                i += 1
            if spans:
                win.host_spans.append(["submit", b, clock()])
        if open_reqs:
            b = clock()
            fe.step()
            e = clock()
            win.step_s.append(e - b)
            if spans:
                win.host_spans.append(["step", b, e])
            _harvest(win, open_reqs, e)
        elif i < len(plan):
            b = clock()
            time.sleep(max(0.0, min(plan[i][0] - (b - win.t0), 0.001)))
            if spans:
                win.host_spans.append(["idle wait", b, clock()])
        if i >= len(plan):
            win.t_close = win.t0 + seconds
            return open_reqs


def drain(fe, open_reqs: list, win: Window, clock):
    """Step until every request of the window is answered, or until
    ``DRAIN_S`` past the close."""
    while open_reqs and clock() - win.t_close < DRAIN_S:
        fe.step()
        _harvest(win, open_reqs, clock())


# ---------------------------------------------------------------------------
# The check of what the window served
# ---------------------------------------------------------------------------

def sample_rows(win: Window, seed: int, n: int = CHECK_ROWS) -> list:
    """(rid, row) pairs drawn from the seed over the window's answered
    requests, with the last row of the last request sent among them."""
    answered = [s for s in win.sent if s[0] in win.done]
    if not answered:
        return []
    g = traffic.rng(seed, 2)
    rows = np.array([s[2] for s in answered])
    flat = g.choice(int(rows.sum()), size=min(n - 1, int(rows.sum())),
                    replace=False)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
    picks = set()
    for f in flat:
        j = int(np.searchsorted(starts, f, "right")) - 1
        picks.add((answered[j][0], int(f - starts[j])))
    last = answered[-1]
    picks.add((last[0], last[2] - 1))
    return sorted(picks)


def compare(served: np.ndarray, reference: np.ndarray) -> float:
    """The widest gap of a served row's logits from the reference's,
    relative to the reference row's largest |logit|, over the rows."""
    gap = np.abs(served.astype(np.float64) - reference.astype(np.float64))
    scale = np.abs(reference.astype(np.float64)).max(axis=1)
    rel = gap.max(axis=1) / np.maximum(scale, 1e-30)
    if not np.isfinite(rel).all():
        return float("inf")
    return float(rel.max())


def check(win: Window, picks: list, fw: dict, config: dict, arch, pool,
          device: str) -> dict:
    """The numbers compared, each beside its limit."""
    limits = config["limits"]
    sent = {s[0]: s for s in win.sent}
    unanswered = sum(1 for s in win.sent if s[0] not in win.done)
    checks = {"unanswered": {"value": unanswered,
                             "limit": limits["unanswered"]}}
    if picks:
        x = np.stack([pool[sent[rid][1] + row] for rid, row in picks])
        served = np.stack([np.asarray(win.reqs[rid].logits[row])
                           for rid, row in picks])
        want = arch.reference_logits(
            config, fw, torch.from_numpy(x).to(device)).cpu().numpy()
        gap = compare(served, want)
    else:
        gap = float("inf")
    checks["logit_gap"] = {"value": gap, "limit": limits["logit_gap"]}
    return checks


def checks_pass(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_process: float, root: Path = ROOT, device: str = "cuda",
             spec: dict | None = None):
    """Run one cell once; return its result (the JSON line's object)
    and the record the metric readers read."""
    clock = time.perf_counter
    spec = load_spec(root) if spec is None else spec
    cell, config, mix = find_cell(spec, workload, root)
    arch = models.load(config["model"]["arch"], root)
    model, serve = config["model"], config["serve"]
    on_card = device.startswith("cuda")
    marks = [("start", clock())]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        marks.append(("CUDA context", clock()))
    fw = arch.float_weights(model, seed, device)
    pool = arch.input_pool(model, mix["pool_images"], seed, device)
    sync(device)
    marks.append(("weights and pool", clock()))
    telemetry = None
    if trace:
        from repro_torch.obs import Telemetry
        from repro_torch.obs.trace import Trace
        telemetry = Telemetry(trace=Trace(capacity=TRACE_CAPACITY,
                                          clock=clock), clock=clock)
    fe = arch.front_door(config, fw, device, telemetry)
    sync(device)
    marks.append(("compile", clock()))
    # warm the cell's shapes: a full microbatch and a partial one
    mb = serve["microbatch"]
    fe.run([arch.request(-2, pool[:mb]), arch.request(-1, pool[mb:mb + 1])])
    fe.reset_stats()
    fe.reset_service_rate()
    sync(device)
    marks.append(("warm-up", clock()))
    print("portbench: set-up " + ", ".join(
        f"{name} {b - a:.2f} s" for (_, a), (name, b) in
        zip(marks, marks[1:])) + f"; imports {marks[0][1] - t_process:.2f} s",
        file=sys.stderr)

    win = Window()
    prof = None
    if trace and on_card:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    pclock = devtrace.Clock()
    loop = closed_loop if mix["loop"] == "closed" else open_loop
    open_reqs = loop(fe, arch, mix, seed, seconds, pool, clock, win, trace)
    win.occupancy = fe.stats()["microbatch_occupancy"][0]
    if prof is not None:
        sync(device)
        prof.__exit__(None, None, None)
    setup_s = win.t0 - t_process
    drain(fe, open_reqs, win, clock)
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0

    rec = record(win, mix, config, arch, setup_s, telemetry, prof, pclock)
    del fe, telemetry, prof, open_reqs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = check(win, sample_rows(win, seed), fw, config, arch, pool,
                   device)

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": int(cell["chips"]), "memory_peak_bytes": int(mem_peak)}
    out = {"correct": checks_pass(checks), "attempted": len(win.sent),
           "failed": checks["unanswered"]["value"], "metrics": metrics,
           "device": dev}
    if trace and rec["device_trace"] is not None:
        dt = rec["device_trace"]
        dev["busy_s"] = dt["busy_s"]
        dev["window_s"] = rec["window_s"]
        out["breakdown"] = {"device_ops": dt["top_ops"],
                            "idle_gaps": dt["idle_gaps"]}
    out["checks"] = checks
    return out, rec


def record(win: Window, mix: dict, config: dict, arch, setup_s: float,
           telemetry, prof, pclock) -> dict:
    """The run's record, which the metric readers read."""
    window_s = win.t_close - win.t0
    lat = [win.done[s[0]] - (win.t0 + s[3]) for s in win.sent
           if s[0] in win.done]
    rec = {"window": win, "loop": mix["loop"], "config": config,
           "arch": arch, "setup_s": setup_s, "window_s": window_s,
           "images_done": win.images_done, "requests": len(win.sent),
           "latency_s": lat, "step_s": win.step_s,
           "occupancy": win.occupancy, "microbatch_rows": None,
           "device_trace": None}
    if telemetry is not None:
        tr = telemetry.trace
        t0_us, t1_us = tr.us(win.t0), tr.us(win.t_close)
        rec["microbatch_rows"] = [
            sp.args["rows"] for sp in tr.spans
            if sp.cat == "pipeline" and sp.name == "stage0"
            and t0_us <= sp.ts <= t1_us and "rows" in sp.args]
    if prof is not None:
        t0_ns, t1_ns = pclock.to_ns(win.t0), pclock.to_ns(win.t_close)
        ev = devtrace.window_events(
            devtrace.device_events(prof.profiler.kineto_results),
            t0_ns, t1_ns)
        if ev:
            print(f"portbench: {len(ev)} device events in the traced "
                  f"window of {(t1_ns - t0_ns) / 1e6:.1f} ms, the first at "
                  f"+{(ev[0][0] - t0_ns) / 1e6:.3f} ms, the last ending at "
                  f"+{(ev[-1][1] - t0_ns) / 1e6:.3f} ms", file=sys.stderr)
        rec["device_trace"] = {
            "busy_s": devtrace.busy_s(ev),
            "launches": devtrace.kernel_launches(ev),
            "by_name": devtrace.time_by_name(ev),
            "top_ops": devtrace.top_ops(ev),
            "idle_gaps": devtrace.idle_gaps(ev, t0_ns, t1_ns,
                                            win.host_spans, pclock)}
    return rec
