"""Port parity for the replicated serving front door
(``repro_torch/serving/frontend.py``, ``launch/serve_frontend.py``,
``launch/mesh.replica_pipeline_devices`` and the front-door surface of
``serving/pipeline.py``) on the CPU, at the JAX tests' size,
``ResNetConfig(width_mult=0.125, num_classes=4, in_hw=8)``.

Weights are initialised on the JAX side and carried across with
``params_from_numpy``; the JAX side runs the port's compiled bytes (held
byte-equal to its own by test_torch_compile.py) under its exact jnp
lowering.  Held bit for bit: every request's logits through the port's
fleet (1-2 replicas x 1-2 stages, ``int8`` and ``sparse_cfmm``, any
arrival order and interleaving) against the JAX package's jitted
``reference_logits`` of the same rows.  Port-internal invariants from
tests/test_frontend.py: one shared compiled tree, disjoint and complete
stage subtrees, device carving, least-loaded routing, backpressure,
``pending_rows`` against its scan, validation, the latency window, the
``reset_stats`` audit and continuous batching.  The fleet's entry points
refuse to run without CUDA unless asked for the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiled_linear as jcl
from repro.models import resnet as jres
from repro.serving import pipeline as jpipe
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.launch import serve_frontend
from repro_torch.launch.mesh import replica_pipeline_devices
from repro_torch.models.graph import compile_graph
from repro_torch.models import resnet as tres
from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
from repro_torch.serving.pipeline import PipelineEngine

JCFG = jres.ResNetConfig(width_mult=0.125, num_classes=4, in_hw=8)
TCFG = tres.ResNetConfig(width_mult=0.125, num_classes=4, in_hw=8)
MODES = ("int8", "sparse_cfmm")
MB = 2
POOL = np.random.RandomState(1).randn(16, 8, 8, 3).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its exact jnp lowering.  Torch runs one thread:
    beside XLA's CPU thread pool, torch's own pool oversubscribes the
    cores and slows these small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


_cache = {}


def boxed_tree():
    """The JAX package's initial tree, carried into the port."""
    if "boxed" not in _cache:
        _cache["boxed"] = tnn.params_from_numpy(
            jax.jit(jres.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                 JCFG))
    return _cache["boxed"]


def compiled(mode):
    """The port's compiled tree of ``mode`` (sparsity 0.5, as the JAX
    tests compile)."""
    if mode not in _cache:
        _cache[mode] = tcl.ensure_compiled(boxed_tree(), mode, 0.5)
    return _cache[mode]


def to_jax(tree):
    """The port's compiled tree as the JAX package's (same bytes)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_jax(v) for v in tree)
    if isinstance(tree, tcl.ConvGeom):
        return jcl.ConvGeom(tree.k, tree.stride, tree.c_in, tree.dw)
    return jnp.asarray(tree.numpy())


def reference(mode):
    """The JAX package's jitted ``reference_logits`` of the whole pool:
    per-row quantization domains make a row's logits independent of its
    microbatch, so every request's reference is a slice of it."""
    key = ("ref", mode)
    if key not in _cache:
        _cache[key] = np.asarray(jpipe.reference_logits(
            to_jax(compiled(mode)), JCFG, jnp.asarray(POOL), MB))
    return _cache[key]


def request(rid, a, b):
    """A request of the pool's rows ``[a, b)``."""
    req = FrontendRequest(rid=rid, images=POOL[a:b])
    req.pool_rows = (a, b)
    return req


def wave(spans, base=0):
    return [request(base + i, a, b) for i, (a, b) in enumerate(spans)]


def check_vs_jax(reqs, mode):
    """Every request done, its logits bit-identical to the JAX
    reference of its rows."""
    ref = reference(mode)
    for r in reqs:
        assert r.done, r.rid
        a, b = r.pool_rows
        np.testing.assert_array_equal(r.logits, ref[a:b])


def fleet(mode="int8", **kw):
    kw.setdefault("microbatch", MB)
    return ResNetFrontend(TCFG, compiled(mode), mode=mode, device="cpu",
                          **kw)


SPANS = [(0, 3), (3, 4), (4, 6), (6, 11), (11, 12), (12, 16)]


@pytest.mark.parametrize("n_stages", (1, 2))
@pytest.mark.parametrize("n_replicas", (1, 2))
@pytest.mark.parametrize("mode", MODES)
def test_fleet_bit_identical_to_jax(mode, n_replicas, n_stages):
    fe = fleet(mode, n_replicas=n_replicas, n_stages=n_stages)
    reqs = wave(SPANS)
    fe.run(reqs)
    check_vs_jax(reqs, mode)
    st = fe.stats()
    assert st["requests_done"] == len(SPANS)
    assert sum(st["rows_dispatched"]) == 16


def test_arrival_order_and_interleaving_do_not_change_bits():
    """The same requests in opposite arrival orders, half of them
    submitted mid-flight (odd sizes: partial microbatches ride along):
    every request matches the JAX reference of its own rows."""
    for order in (1, -1):
        fe = fleet(n_replicas=2, n_stages=2)
        reqs = wave([(0, 3), (3, 4), (4, 9), (9, 10)])[::order]
        for r in reqs[:2]:
            fe.submit(r)
        for _ in range(3):                     # partially drain
            fe.step()
        for r in reqs[2:]:                     # interleave mid-flight
            fe.submit(r)
        while fe.step():
            pass
        check_vs_jax(reqs, "int8")


def test_zero_row_request_completes():
    fe = fleet(n_replicas=2)
    req = FrontendRequest(rid=0, images=POOL[:0])
    fe.run([req])
    assert req.done and req.logits.shape == (0, TCFG.num_classes)
    assert req.latency_s is not None


@pytest.mark.parametrize("mode", MODES)
def test_replicas_share_one_tree_and_split_stage_subtrees(mode):
    """The fleet compiles ONE tree that every replica engine aliases, and
    each replica's stages hold exactly their own units' weights — on one
    device the stage tensors are the shared tree's own (no copy)."""
    fe = fleet(mode, n_replicas=2, n_stages=2)
    shared = {t.data_ptr() for t in tnn.tree_leaves(fe.params)
              if isinstance(t, torch.Tensor)}
    names = [u.name for u in compile_graph(TCFG.graph(), fe.params)]
    for eng in fe.replicas:
        assert eng.params is fe.params
        seen = []
        for stage in eng.pipe.stages:
            seen.extend(stage.unit_names)
            assert {t.data_ptr() for t in tnn.tree_leaves(stage.params)
                    if isinstance(t, torch.Tensor)} <= shared
        assert sorted(seen) == sorted(names)      # disjoint, complete
    # a boxed tree compiles exactly once, at the front door
    fe2 = ResNetFrontend(TCFG, boxed_tree(), mode=mode, sparsity=0.5,
                         n_replicas=2, microbatch=MB, device="cpu")
    assert all(eng.params is fe2.params for eng in fe2.replicas)


def test_replica_device_carving():
    """Contiguous disjoint groups where the devices exist, round-robin
    where they do not (one card serves every replica)."""
    devs = list("abcdefgh")
    groups = replica_pipeline_devices(2, 3, devs)
    assert groups == [["a", "b", "c"], ["d", "e", "f"]]
    assert replica_pipeline_devices(3, 2, devs[:4]) == [
        ["a", "b"], ["c", "d"], ["a", "b"]]
    assert replica_pipeline_devices(2, 1, ["cuda:0"]) == [["cuda:0"],
                                                          ["cuda:0"]]


def test_least_loaded_routing_spreads_requests():
    fe = fleet(n_replicas=2)
    reqs = wave([(0, 4), (4, 8)])
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    assert sorted(r.replica for r in reqs) == [0, 1]
    st = fe.stats()
    assert st["rows_dispatched"] == [4, 4]
    assert st["requests_dispatched"] == [1, 1]


def test_admission_backpressure_holds_queue():
    fe = fleet(n_replicas=2, n_stages=1, admit_rows=2)
    reqs = wave([(2 * i, 2 * i + 2) for i in range(6)])
    for r in reqs:
        fe.submit(r)
    assert len(fe.queue) == 6
    fe.step()
    assert len(fe.queue) > 0                   # held back, not dumped
    assert max(eng.pending_rows for eng in fe.replicas) <= 2 + MB
    while fe.step():
        pass
    check_vs_jax(reqs, "int8")
    st = fe.stats()
    assert st["max_queue_depth"] == 6 and st["queue_depth"] == 0
    assert st["requests_done"] == 6


def test_admit_rows_validated_and_partial_microbatch_load_exact():
    with pytest.raises(AssertionError, match="admit_rows"):
        fleet(n_replicas=2, admit_rows=0)
    fe = fleet(n_replicas=1, n_stages=2)
    eng = fe.replicas[0]
    eng.submit(request(0, 0, 1))               # 1 row, microbatch 2
    assert eng.pending_rows == 1
    eng.step()                                 # in flight, stage 0
    assert eng.pending_rows == 1               # its real size
    while eng.step():
        pass
    assert eng.pending_rows == 0


def test_submit_validation_rejects_malformed():
    fe = fleet(n_replicas=1)
    hw = TCFG.in_hw
    bad = [
        (np.zeros((2, hw, hw), np.float32), "shape"),
        (np.zeros((2, hw, hw, 1), np.float32), "shape"),
        (np.zeros((2, hw + 1, hw + 1, 3), np.float32), "shape"),
        (np.asarray([["nope"]], dtype=object), "castable"),
        (np.full((1, hw, hw, 3), np.nan, np.float32), "NaN/Inf"),
        (np.full((1, hw, hw, 3), np.inf, np.float32), "NaN/Inf"),
    ]
    for images, match in bad:
        with pytest.raises(ValueError, match=match):
            fe.submit(FrontendRequest(rid=99, images=images))
    assert len(fe.queue) == 0 and not fe._inflight
    ok = FrontendRequest(rid=1, images=POOL[5:6].tolist())
    ok.pool_rows = (5, 6)
    fe.run([ok])
    assert isinstance(ok.images, np.ndarray)
    check_vs_jax([ok], "int8")


def test_resubmit_live_request_and_duplicate_rid_rejected():
    fe = fleet(n_replicas=1)
    req = request(7, 0, 6)                     # 3 microbatches
    fe.submit(req)
    with pytest.raises(ValueError, match="already queued or in flight"):
        fe.submit(req)
    with pytest.raises(ValueError, match="duplicates a live request"):
        fe.submit(request(7, 6, 8))
    fe.step()
    assert not req.done and req.rows_done < 6
    with pytest.raises(ValueError, match="already queued or in flight"):
        fe.submit(req)
    while fe.step():
        pass
    check_vs_jax([req], "int8")
    fe.run([req])                              # drained: legal again
    other = request(7, 3, 4)
    fe.run([other])
    check_vs_jax([req, other], "int8")


def test_reset_stats_audit_is_structural():
    fe = fleet(n_replicas=2)
    fe.run(wave([(0, 2), (2, 4), (4, 6), (6, 8)]))
    assert fe.metrics.wave_names()
    fe.reset_stats()
    snap = fe.snapshot()["door"]
    for name in fe.metrics.wave_names():
        kind = fe.metrics.get(name).kind
        if kind == "counter":
            assert snap[name] == 0, name
        elif kind == "reservoir":
            assert snap[name]["count"] == 0, name
        elif kind in ("gauge", "highwater"):
            assert snap[name] == 0, name
    assert fe.stats()["est_row_time_s"] is not None   # life survives


def test_latency_window_bounds_samples():
    fe = fleet(n_replicas=1, latency_window=4)
    for i in range(8):
        fe.run([request(i, i, i + 1)])
    st = fe.stats()
    assert st["requests_done"] == 8 and st["latency_samples"] == 4
    assert st["latency_window"] == 4 and len(fe._latencies) == 4
    assert st["latency_p95_s"] >= st["latency_p50_s"] > 0
    with pytest.raises(AssertionError):
        fleet(latency_window=0)


def test_two_small_requests_share_a_microbatch():
    """Continuous batching: two 1-row requests ride ONE microbatch and
    each still equals the JAX reference of its row; the whole-request
    baseline needs two half-empty microbatches."""
    reqs = wave([(0, 1), (1, 2)])
    fe = fleet(n_replicas=1, n_stages=1)
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    st = fe.replicas[0].stats()
    assert st["mb_injected"] == 1 and st["microbatch_occupancy"] == 1.0
    base = fleet(n_replicas=1, n_stages=1, continuous=False)
    breqs = wave([(0, 1), (1, 2)])
    base.run(breqs)
    check_vs_jax(breqs, "int8")
    stb = base.replicas[0].stats()
    assert stb["mb_injected"] == 2 and stb["microbatch_occupancy"] == 0.5


def test_row_granular_dispatch_splits_across_replicas():
    fe = fleet(n_replicas=2, n_stages=1, admit_rows=2)
    req = request(0, 0, 6)
    fe.run([req])
    check_vs_jax([req], "int8")
    assert req.replica == 0
    st = fe.stats()
    assert sum(st["rows_dispatched"]) == 6
    assert all(n > 0 for n in st["rows_dispatched"])


def test_pending_rows_match_scan_at_every_step():
    fe = fleet(n_replicas=2, n_stages=2, admit_rows=3)
    reqs = wave([(i, i + 1 + i % 4) for i in range(8)])
    for r in reqs:
        fe.submit(r)
    while True:
        busy = fe.step()
        for eng in fe.replicas:
            assert eng.pending_rows == eng._scan_pending_rows()
        assert fe._door_rows == fe._scan_door_rows()
        if not busy:
            break
    check_vs_jax(reqs, "int8")
    assert all(eng.pending_rows == 0 for eng in fe.replicas)


def test_stats_latency_and_replica_accounting():
    fe = fleet(n_replicas=2, n_stages=2)
    reqs = wave([(0, 2), (2, 4), (4, 6), (6, 8)])
    fe.run(reqs)
    st = fe.stats()
    assert st["n_replicas"] == 2 and len(st["replicas"]) == 2
    assert [s["replica"] for s in st["replicas"]] == [0, 1]
    assert all(s["in_flight"] == 0 for s in st["replicas"])
    assert st["latency_p95_s"] >= st["latency_p50_s"] > 0
    assert all(r.latency_s > 0 for r in reqs)
    assert sum(st["rows_dispatched"]) == 8
    assert all(s["stage_devices"] == ["cpu", "cpu"] for s in st["replicas"])
    fe.reset_stats()
    assert fe.stats()["requests_done"] == 0
    assert fe.stats()["latency_p50_s"] is None


def test_entry_points_default_to_cuda():
    """Without CUDA the fleet, its engines and its driver raise unless
    asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResNetFrontend(TCFG, compiled("int8"), mode="int8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PipelineEngine(TCFG, compiled("int8"), mode="int8")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_frontend.main(["--width", "0.125", "--hw", "8"])


def test_serve_frontend_driver_on_the_cpu(capsys):
    """The driver on the CPU: a wave, a killed and restarted replica, an
    open-loop wave, a trace and the sparsity summary."""
    fe = serve_frontend.main([
        "--device", "cpu", "--width", "0.125", "--hw", "16",
        "--replicas", "2", "--requests", "6", "--rows", "3",
        "--kill-replica", "1", "--open-loop", "0.7",
        "--sparsity-groups", "8"])
    out = capsys.readouterr().out
    assert "[frontend] 2 replica(s) x 1 stage(s) (cpu)" in out
    assert "6/6 requests completed" in out and "replica 1 restarted" in out
    assert "[open-loop]" in out and "[sparsity]" in out
    assert fe.stats()["replicas_failed"] == 0
