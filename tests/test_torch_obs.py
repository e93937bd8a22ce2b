"""Port parity for the serving stack's telemetry (``repro_torch/obs/``:
``Telemetry``, ``trace``, ``sparsity``) and the zero-count output of the
conv ops, on the CPU, against the JAX package under its jnp lowering.

Held bit for bit:

* ``ops.conv2d(zero_count=g)`` against JAX ``ops.conv2d`` — dense and
  packed weights, per-row and scalar scales, g in {1, 4, 8}, f32 and
  requantized outputs: every key of the dict equal, and ``y`` (or
  ``y_q``, ``s_y``) equal to JAX's and to the unprofiled call's;
* ``reference_profile`` against JAX ``reference_profile(lowering="jnp")``
  for ResNet and a tiny MobileNetV2 (the depthwise counts): equal
  snapshots and logits;
* the profiled fleet's ``telemetry.sparsity`` snapshot equal to the
  port's ``reference_profile``, its logits equal to the unprofiled JAX
  reference (observation only);
* the fleet's Chrome trace valid under both the port's and JAX's
  ``validate_chrome_trace``, with the full admission -> queue ->
  dispatch -> collect chain for every request;
* the bubble-cause partition and the registry's scope audit.
"""
import functools
import itertools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import mobilenet_v2 as jmb
from repro.obs.trace import validate_chrome_trace as jax_validate
from repro.serving import pipeline as jpipe
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.kernels import ops as tops
from repro_torch.models import mobilenet_v2 as tmb
from repro_torch.obs import Telemetry
from repro_torch.obs.metrics import LIFE
from repro_torch.obs.sparsity import SparsityProfiler
from repro_torch.obs.trace import Trace, main as trace_main
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.serving.loadgen import poisson_plan, run_open_loop
from repro_torch.serving.pipeline import reference_profile
from test_torch_frontend import (JCFG, MB, POOL, TCFG,  # noqa: F401
                                 _jnp_lowering_one_torch_thread,
                                 check_vs_jax, compiled, fleet, to_jax, wave)

# ---------------------------------------------------------------------------
# ops.conv2d(zero_count=) against JAX
# ---------------------------------------------------------------------------

ZC_CASES = list(itertools.product((1, 4, 8), ("dense", "packed"),
                                  ("row", "scalar"), (False, True)))


@functools.lru_cache(maxsize=None)
def _conv_case():
    """A 3x3 conv of 16 channels whose BN bias zeroes some channels
    outright (whole-group zeros) and others partly."""
    rng = np.random.RandomState(5)
    c_in, c_out, k = 8, 16, 3
    w = (rng.randn(k * k * c_in, c_out) / np.sqrt(k * k * c_in)).astype(
        np.float32)
    dense = tcl._compile_leaf_2d(torch.from_numpy(w), "int8", 0.8, conv_k=k)
    packed = tcl._compile_leaf_2d(torch.from_numpy(w), "sparse_cfmm", 0.5,
                                  conv_k=k)
    beta = (0.2 * rng.randn(c_out)).astype(np.float32)
    beta[:4] = -1e3                            # channels 0-3 always zero
    return dict(
        x=rng.randint(-127, 128, (2, 9, 9, c_in)).astype(np.int8),
        codes=dense["values"].numpy(), scale_w=dense["scale"].numpy(),
        bitmap=packed["bitmap"].numpy(), values=packed["values"].numpy(),
        scale_p=packed["scale"].numpy(), s_scalar=np.float32(0.023),
        s_row=(0.01 + 0.02 * rng.rand(2)).astype(np.float32),
        gamma=(0.5 + rng.rand(c_out)).astype(np.float32), beta=beta)


@functools.lru_cache(maxsize=None)
def _conv_zc_jax():
    """JAX ``ops.conv2d(zero_count=g)`` for every case, from one jit."""
    c = _conv_case()

    def run(x, codes, bitmap, values, scale_w, scale_p, s_scalar, s_row,
            gamma, beta):
        out = []
        for g, kind, scale, quant_out in ZC_CASES:
            w = codes if kind == "dense" else (bitmap, values)
            out.append(jops.conv2d(
                x, w, 3, 1, x_scale=s_scalar if scale == "scalar" else s_row,
                w_scale=scale_w if kind == "dense" else scale_p,
                gamma=gamma, beta=beta, relu=True, quant_out=quant_out,
                w_layout="spatial", zero_count=g))
        return out

    names = ("x", "codes", "bitmap", "values", "scale_w", "scale_p",
             "s_scalar", "s_row", "gamma", "beta")
    res = jax.jit(run)(*(jnp.asarray(c[n]) for n in names))
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("g,kind,scale,quant_out", ZC_CASES)
def test_conv2d_zero_counts_equal_jax(g, kind, scale, quant_out):
    c = _conv_case()
    want = _conv_zc_jax()[ZC_CASES.index((g, kind, scale, quant_out))]
    t = torch.from_numpy
    w = (t(c["codes"]) if kind == "dense"
         else (t(c["bitmap"]), t(c["values"])))
    kw = dict(x_scale=(torch.tensor(c["s_scalar"]) if scale == "scalar"
                       else t(c["s_row"])),
              w_scale=t(c["scale_w"] if kind == "dense" else c["scale_p"]),
              gamma=t(c["gamma"]), beta=t(c["beta"]), relu=True,
              quant_out=quant_out)
    got = tops.conv2d(t(c["x"]), w, 3, 1, zero_count=g, **kw)
    plain = tops.conv2d(t(c["x"]), w, 3, 1, **kw)
    plain = plain if quant_out else (plain,)
    assert len(got) == len(want) == (3 if quant_out else 2)
    for a, b, p in zip(got[:-1], want[:-1], plain):
        np.testing.assert_array_equal(a.numpy(), b)
        assert torch.equal(a, p)              # y unchanged by profiling
    zc, zc_j = got[-1], want[-1]
    assert sorted(zc) == sorted(zc_j)
    for key in zc:
        assert zc[key].dtype == torch.float32
        assert tuple(zc[key].shape) == zc_j[key].shape, key
        np.testing.assert_array_equal(zc[key].numpy(), zc_j[key])
    assert float(zc["group_allzero"].sum()) > 0


# ---------------------------------------------------------------------------
# reference_profile against JAX's jnp oracle
# ---------------------------------------------------------------------------

MB_CFGS = (jmb.MobileNetV2Config(0.25, 4, 16),
           tmb.MobileNetV2Config(0.25, 4, 16))
_prof_cache = {}


def _mobilenet_compiled():
    if "mbv2" not in _prof_cache:
        jcfg = MB_CFGS[0]
        tree = tnn.params_from_numpy(jax.jit(
            jmb.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg))
        _prof_cache["mbv2"] = tcl.ensure_compiled(tree, "int8", 0.5)
    return _prof_cache["mbv2"]


@pytest.mark.parametrize("model,groups", [("resnet", 4),
                                          ("mobilenet_v2", 8)])
def test_reference_profile_equals_jax(model, groups):
    """The port's single-device profile oracle against JAX's
    ``reference_profile(lowering="jnp")``: the same snapshot, key for key
    (every layer's zeros, histogram and group fractions), and the same
    logits."""
    if model == "resnet":
        params, (jcfg, tcfg), x = compiled("int8"), (JCFG, TCFG), POOL[:5]
    else:
        params, (jcfg, tcfg) = _mobilenet_compiled(), MB_CFGS
        x = np.random.RandomState(2).randn(3, 16, 16, 3).astype(np.float32)
    logits, snap = reference_profile(params, tcfg, x, MB, groups)
    j_logits, j_snap = jpipe.reference_profile(to_jax(params), jcfg, x, MB,
                                               groups, lowering="jnp")
    np.testing.assert_array_equal(logits, np.asarray(j_logits))
    assert snap == j_snap
    assert snap["microbatches_profiled"] == -(-len(x) // MB)
    assert 0.0 < snap["overall_zero_fraction"] < 1.0
    if model == "mobilenet_v2":                # depthwise layers profiled
        assert any("dw" in name for name in snap["layers"]), snap["layers"]


def test_fleet_sparsity_matches_reference_profile():
    """The profiled fleet (2 stages): its snapshot equals the port's
    ``reference_profile`` of the same rows, and its logits equal the
    unprofiled JAX reference — profiling only observes."""
    groups = 4
    tel = Telemetry(trace=True, sparsity_groups=groups)
    fe = fleet(n_replicas=1, n_stages=2, telemetry=tel)
    reqs = wave([(0, 2), (2, 4), (4, 6)])
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    served = tel.sparsity.snapshot()
    _, oracle = reference_profile(compiled("int8"), TCFG, POOL[:6], MB,
                                  groups)
    assert served == oracle
    assert served["microbatches_profiled"] == 3


def test_profiler_keeps_tensors_as_given_until_snapshot():
    """``add`` stores the count tensors themselves (no copy, no move to
    the host); ``snapshot`` reduces them."""
    prof = SparsityProfiler(groups=2)
    counts = {"row_zeros": torch.tensor([1.0, 3.0]),
              "group_zeros": torch.tensor([2.0, 2.0]),
              "group_allzero": torch.tensor([1.0, 0.0]),
              "elems_per_row": torch.tensor(4.0),
              "cells": torch.tensor(4.0)}
    prof.add({"conv": counts})
    assert prof._acc["conv"][0] is counts
    lay = prof.snapshot()["layers"]["conv"]
    assert lay["zeros"] == 4.0 and lay["zero_fraction"] == 0.5


def test_sparsity_profiler_matches_numpy_recount():
    """Synthetic post-ReLU maps through the profiler's aux contract (as
    CPU tensors), every reduced number against a numpy recount."""
    rng = np.random.RandomState(0)
    groups, n, hw, c = 4, 3, 2, 8
    prof = SparsityProfiler(groups=groups, hist_buckets=4)
    acts = []
    for _ in range(2):
        a = np.maximum(rng.randn(n, hw, hw, c), 0.0)
        acts.append(a)
        z = a == 0.0
        zg = z.reshape(n, hw, hw, c // groups, groups)
        f = lambda v: torch.tensor(np.asarray(v, np.float32))
        prof.add({"layer0": {
            "row_zeros": f(z.reshape(n, -1).sum(1)),
            "group_zeros": f(zg.sum((0, 1, 2, 4))),
            "group_allzero": f(zg.all(4).sum((0, 1, 2))),
            "elems_per_row": f(hw * hw * c), "cells": f(n * hw * hw)}})
    snap = prof.snapshot()
    lay = snap["layers"]["layer0"]
    allz = np.concatenate(acts)
    zeros, elems = float((allz == 0.0).sum()), allz.size
    assert snap["microbatches_profiled"] == 2 and lay["n_rows"] == 2 * n
    assert lay["zeros"] == zeros
    assert lay["zero_fraction"] == pytest.approx(zeros / elems)
    fr = (allz == 0.0).reshape(2 * n, -1).mean(1)
    ref_hist, _ = np.histogram(fr, bins=np.linspace(0, 1, 5))
    assert lay["row_fraction_hist"]["counts"] == [int(x) for x in ref_hist]
    zg = (allz == 0.0).reshape(2 * n, hw, hw, c // groups, groups)
    np.testing.assert_allclose(lay["group_zero_fraction"],
                               zg.sum((0, 1, 2, 4)) / (elems / (c // groups)))
    np.testing.assert_allclose(lay["group_allzero_cell_fraction"],
                               zg.all(4).sum((0, 1, 2)) / (2 * n * hw * hw))


# ---------------------------------------------------------------------------
# trace export + validator
# ---------------------------------------------------------------------------

def _fake_clock(times):
    it = iter(times)
    last = [0.0]

    def clock():
        try:
            last[0] = next(it)
        except StopIteration:
            pass
        return last[0]
    return clock


def test_trace_export_nests_and_validates():
    tr = Trace(clock=_fake_clock([0.0]))
    tr.name_process(1, "replica0")
    tr.name_thread(1, 0, "stage0")
    tr.span("outer", "t", 1, 0, 0.001, 0.009)
    tr.span("inner", "t", 1, 0, 0.002, 0.005)
    tr.instant("edge", "t", 1, 0, t=0.004, bytes=128)
    obj = tr.to_chrome_trace()
    assert validate_chrome_trace(obj) == [] == jax_validate(obj)
    phs = [(e["ph"], e["name"]) for e in obj["traceEvents"]]
    assert phs[:2] == [("M", "process_name"), ("M", "thread_name")]
    names = [e["name"] for e in obj["traceEvents"] if e["ph"] in "BE"]
    assert names == ["outer", "inner", "inner", "outer"]


def test_trace_buffer_bounded_and_still_valid():
    tr = Trace(capacity=2, clock=_fake_clock([0.0]))
    for i in range(5):
        tr.span(f"s{i}", "t", 0, 0, i * 0.01, i * 0.01 + 0.005)
    assert len(tr.spans) == 2 and tr.dropped == 3
    obj = tr.to_chrome_trace()
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"]["dropped_events"] == 3


def test_validator_rejects_broken_traces():
    ev = {"name": "a", "ph": "B", "ts": 1.0, "pid": 0, "tid": 0}
    bad_order = [dict(ev, ts=5.0), dict(ev, ph="E", ts=6.0),
                 dict(ev, name="b", ts=1.0),
                 dict(ev, name="b", ph="E", ts=2.0)]
    cases = [([], None), ({"traceEvents": []}, None),
             ({"traceEvents": [{"ph": "B"}]}, "missing keys"),
             ({"traceEvents": [ev]}, "unclosed"),
             ({"traceEvents": [dict(ev, ph="E")]}, "no open B"),
             ({"traceEvents": bad_order}, "not monotonic")]
    for obj, word in cases:
        errs = validate_chrome_trace(obj)
        assert errs and errs == jax_validate(obj)
        assert word is None or any(word in e for e in errs)


def test_trace_cli_validates_files(tmp_path):
    tr = Trace(clock=_fake_clock([0.0]))
    tr.span("a", "t", 0, 0, 0.0, 0.001)
    good = tr.save(tmp_path / "good.json")
    assert trace_main([str(good)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "E", "ts": 0.0, "pid": 0, "tid": 0}]}))
    assert trace_main([str(bad)]) == 1
    assert trace_main([]) == 2
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.trace",
                        str(good)], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# traced serving, bubble attribution, the registry audit
# ---------------------------------------------------------------------------

def test_traced_open_loop_wave_full_span_chain(tmp_path):
    tel = Telemetry(trace=True)
    fe = fleet(n_replicas=2, n_stages=2, telemetry=tel)
    fe.run(wave([(0, 2)], base=-1))            # warm-up
    plan = poisson_plan(rate_rps=400.0, n_requests=6,
                        image_pool=POOL[:4], size_mix=((1, 2.0), (2, 1.0)),
                        seed=0)
    res = run_open_loop(fe, plan, max_wall_s=60.0)
    done = [a.req for a in plan if a.req.done]
    assert res["admitted"] == len(plan) == len(done)
    obj = json.loads(open(tel.trace.save(tmp_path / "wave.json")).read())
    assert validate_chrome_trace(obj) == [] == jax_validate(obj)
    spans_by_rid, stage_spans, arrivals = {}, 0, set()
    for e in obj["traceEvents"]:
        if e["ph"] == "B" and e.get("cat") == "request":
            spans_by_rid.setdefault(e["tid"], set()).add(e["name"])
        if e["ph"] == "B" and e.get("cat") == "pipeline":
            stage_spans += 1
            assert e["name"].startswith("stage")
        if e["ph"] == "i" and e["name"] == "arrival":
            arrivals.add(e["args"]["rid"])
    for req in done:
        assert spans_by_rid.get(req.rid) == {"admission", "queue",
                                             "dispatch", "collect"}
    assert arrivals == {a.req.rid for a in plan} and stage_spans > 0
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert "frontend" in names and any("replica" in n for n in names)


def test_bubble_attribution_partitions_bubble_fraction():
    fe = fleet(n_replicas=2, n_stages=2)
    fe.run(wave([(2 * i, 2 * i + 2) for i in range(6)]))
    for rs in fe.stats()["replicas"]:
        attr = rs["bubble_attribution"]
        assert sorted(attr) == ["drain", "fill", "host", "starved"]
        S = rs["n_stages"]
        total = sum(sum(v) for v in attr.values())
        assert total == rs["idle_stage_ticks"]
        assert total == S * rs["ticks"] - sum(rs["stage_launches"])
        assert total == pytest.approx(rs["bubble_fraction"] * S * rs["ticks"])


def test_frontend_snapshot_and_reset_wave_audit():
    fe = fleet(n_replicas=2, n_stages=2)
    fe.run(wave([(2 * i, 2 * i + 2) for i in range(4)]))
    snap = fe.snapshot()
    assert set(snap) == {"door", "replicas"}
    assert snap["door"]["door.requests_done"] == 4
    assert sum(snap["door"][f"door.replica{r}.rows_dispatched"]
               for r in range(2)) == 8
    assert any(n.startswith("pipe.stage0.idle.") for n in snap["replicas"][0])
    assert all(s["engine.rows_completed"] > 0 for s in snap["replicas"])
    life_before = {n: fe.metrics.get(n).snapshot() for n in fe.metrics.names()
                   if fe.metrics.get(n).scope == LIFE}
    assert life_before["door.row_time_s"] is not None
    odometers = [eng.rows_completed for eng in fe.replicas]
    fe.reset_stats()
    after = fe.snapshot()
    for name in fe.metrics.wave_names():
        m, v = fe.metrics.get(name), after["door"][name]
        if m.kind == "counter":
            assert v == 0, name
        elif m.kind == "reservoir":
            assert v["count"] == 0 and v["p50"] is None, name
    for eng_snap, eng in zip(after["replicas"], fe.replicas):
        for name in eng.metrics.wave_names():
            if eng.metrics.get(name).kind == "counter":
                assert eng_snap[name] == 0, name
    for name, v in life_before.items():
        assert after["door"][name] == v, name
    assert [eng.rows_completed for eng in fe.replicas] == odometers


def test_telemetry_off_by_default_and_unprofiled_programs():
    """Without telemetry the stages run the unprofiled programs (units
    return a carry, not a pair) and nothing is recorded."""
    fe = fleet(n_replicas=1)
    assert fe.telemetry is None and not fe.replicas[0]._profiled
    assert fe.replicas[0].pipe.telemetry is None
    tel = Telemetry(sparsity_groups=8)
    assert tel.trace is None and tel.profiled
    fe2 = fleet(n_replicas=1, telemetry=tel)
    reqs = wave([(0, 3)])
    fe2.run(reqs)
    check_vs_jax(reqs, "int8")
    assert tel.sparsity.microbatches_profiled == 2
