"""Port parity for the fleet's failure recovery, SLO admission and
open-loop load (``repro_torch/serving/{faults,loadgen}.py`` and the
frontend's watchdog and requeue) on the CPU, against the JAX package.

The contract: a replica can die (``kill``), wedge (``hang``) or degrade
(``slow``) before its rows dispatch, mid-pipeline or on its last tick,
and every request still completes with logits bit-identical to the JAX
package's jitted ``reference_logits`` of its rows (jnp lowering, the
same compiled bytes), because per-row quantization domains make the
re-execution exact.  Plus the port's own invariants from
tests/test_faults.py: no row span orphaned, the door's row counter
against its scan, replica restarts, the watchdog's thresholds, typed
shedding and the service-rate calibration, and the open-loop generator's
conservation.
"""
import numpy as np
import pytest

from repro_torch.serving.faults import Fault, FaultInjector, ReplicaFailure
from repro_torch.serving.frontend import (Admitted, FrontendRequest,
                                          Rejected)
from repro_torch.serving.loadgen import (offered_rows_per_s, poisson_plan,
                                         run_open_loop)
from test_torch_frontend import (MB, POOL,  # noqa: F401
                                 _jnp_lowering_one_torch_thread, check_vs_jax,
                                 fleet, reference, request, wave)


def _wave(base, n_reqs=4, rows=MB):
    """Full microbatches of the pool's rows (a requeue never changes a
    microbatch's rows' bits either way: domains are per row)."""
    return wave([(i * rows, (i + 1) * rows) for i in range(n_reqs)], base)


def _fleet(pack, n_stages, **kw):
    kw.setdefault("watchdog_ticks", 4)
    return fleet(n_replicas=2, n_stages=n_stages, continuous=pack, **kw)


def _assert_drained(fe):
    """No row span left anywhere: engine queues and stage inlets empty,
    every row counter at zero, on failed and healthy replicas; the door
    holds nothing."""
    for eng in fe.replicas:
        assert not eng.queue, eng.queue
        assert eng.pending_rows == 0 == eng._scan_pending_rows()
        assert not eng.pipe.busy
    assert not fe.queue and not fe._requeue and not fe._inflight
    assert fe._door_rows == fe._scan_door_rows() == 0


def _check_open_loop(reqs):
    """Requests of a ``poisson_plan`` over the pool: find each one's
    rows in the pool and hold its logits to the JAX reference."""
    ref = reference("int8")
    for r in reqs:
        n = len(r.images)
        a = next(a for a in range(len(POOL) - n + 1)
                 if np.array_equal(POOL[a:a + n], r.images))
        assert r.done
        np.testing.assert_array_equal(r.logits, ref[a:a + n])


def _run_fault_cell(fe, inj, fault, base):
    inj.arm(fe.replicas[0], fault)
    reqs = _wave(base)
    fe.reset_stats()
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    _assert_drained(fe)
    st = fe.stats()
    assert st["replicas_failed"] == 1 and st["failed"] == [True, False], st
    assert st["requeues"] >= 1 and st["rows_requeued"] >= 1, st
    assert st["rows_dispatched"][1] >= st["rows_requeued"], st
    inj.disarm(fe.replicas[0])
    fe.restart_replica(0)
    return st


@pytest.mark.parametrize("kind", ("kill", "hang"))
@pytest.mark.parametrize("n_stages", (1, 2))
@pytest.mark.parametrize("pack", (True, False))
def test_fault_matrix(pack, n_stages, kind):
    """A kill or a hang before dispatch, mid-pipeline and on the last
    tick: every request bit-identical to JAX, nothing orphaned, the
    requeue accounted; a hang is caught by the watchdog."""
    fe = _fleet(pack, n_stages)
    inj = FaultInjector()
    reqs = _wave(0)
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    ticks = fe.replicas[0].pipe.ticks
    for i, at in enumerate((0, max(1, ticks // 2), max(1, ticks - 1))):
        st = _run_fault_cell(fe, inj, Fault(kind, at_step=at),
                             base=100 * (i + 1))
        if kind == "hang":
            assert "watchdog" in st["failures"][0]["reason"], st


def test_slow_replica_limps_to_completion():
    fe = _fleet(True, 1, watchdog_ticks=8)
    FaultInjector().arm(fe.replicas[0], Fault("slow", at_step=0,
                                              slow_factor=3))
    reqs = _wave(0)
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    _assert_drained(fe)
    st = fe.stats()
    assert st["replicas_failed"] == 0 and st["requeues"] == 0, st


def test_slow_replica_past_watchdog_is_failed():
    fe = _fleet(True, 1, watchdog_ticks=4)
    FaultInjector().arm(fe.replicas[0], Fault("slow", at_step=0,
                                              slow_factor=50))
    reqs = _wave(0)
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    _assert_drained(fe)
    st = fe.stats()
    assert st["replicas_failed"] == 1 and st["rows_requeued"] >= 1, st


def test_kill_requeue_sparse_cfmm_at_microbatch_one():
    """The recovery path in ``sparse_cfmm`` at microbatch 1: every row
    equal to the JAX reference after a kill and its requeue."""
    fe = fleet("sparse_cfmm", n_replicas=2, n_stages=1, microbatch=1,
               watchdog_ticks=4)
    FaultInjector().arm(fe.replicas[0], Fault("kill", at_step=1))
    reqs = wave([(i, i + 1) for i in range(4)])
    fe.run(reqs)
    check_vs_jax(reqs, "sparse_cfmm")
    _assert_drained(fe)
    st = fe.stats()
    assert st["replicas_failed"] == 1 and st["rows_requeued"] >= 1, st


def test_restart_replica_rejoins_the_fleet():
    fe = _fleet(True, 1)
    inj = FaultInjector()
    inj.arm(fe.replicas[0], Fault("kill", at_step=0))
    old = fe.replicas[0]
    fe.run(_wave(0))
    assert fe.failed[0]
    fe.restart_replica(0)
    assert fe.replicas[0] is not old and fe.replicas[0].params is fe.params
    assert not fe.failed[0]
    fe.reset_stats()
    reqs = _wave(100)
    fe.run(reqs)
    check_vs_jax(reqs, "int8")
    st = fe.stats()
    assert all(n > 0 for n in st["rows_dispatched"]), st
    assert st["replicas_failed"] == 0


def test_restart_live_replica_requeues_its_work():
    fe = _fleet(True, 2)
    fe.run(_wave(0))
    reqs = _wave(100)
    for r in reqs:
        fe.submit(r)
    fe.step()
    assert any(eng.pending_rows for eng in fe.replicas)
    fe.restart_replica(0)
    while fe.step():
        pass
    check_vs_jax(reqs, "int8")
    _assert_drained(fe)


def test_all_replicas_failed_raises_diagnosable():
    fe = _fleet(True, 1)
    inj = FaultInjector()
    for eng in fe.replicas:
        inj.arm(eng, Fault("kill", at_step=0))
    with pytest.raises(RuntimeError, match="all 2 replicas failed") as ei:
        fe.run(_wave(0))
    assert ei.value.fleet_stats["replicas_failed"] == 2


def test_run_max_steps_timeout_attaches_stats():
    fe = fleet(n_replicas=1, n_stages=1, watchdog_ticks=None)
    FaultInjector().arm(fe.replicas[0], Fault("hang", at_step=0))
    with pytest.raises(TimeoutError, match="max_steps=25") as ei:
        fe.run(_wave(0), max_steps=25)
    st = ei.value.fleet_stats
    assert st["replicas_failed"] == 0 and st["watchdog_ticks"] is None


def test_watchdog_no_false_positive_at_threshold_one():
    """A healthy busy replica changes its progress marker on every step,
    so even ``watchdog_ticks=1`` fails nothing."""
    fe = _fleet(True, 2, watchdog_ticks=1)
    reqs = wave([(i, i + 1 + i % 3) for i in range(6)])
    fe.run(reqs)
    assert fe.stats()["replicas_failed"] == 0, fe.stats()["failures"]
    check_vs_jax(reqs, "int8")


def test_door_rows_counter_matches_scan_through_failure():
    fe = _fleet(True, 1, admit_rows=3)
    fe.run(_wave(0))
    FaultInjector().arm(fe.replicas[0], Fault("kill", at_step=2))
    reqs = wave([(i, i + 1 + i % 4) for i in range(6)], base=100)
    for r in reqs:
        fe.submit(r)
        assert fe._door_rows == fe._scan_door_rows()
    while True:
        busy = fe.step()
        assert fe._door_rows == fe._scan_door_rows()
        for eng in fe.replicas:
            assert eng.pending_rows == eng._scan_pending_rows()
        if not busy:
            break
    check_vs_jax(reqs, "int8")
    _assert_drained(fe)


def test_fault_injector_disarm_restores():
    fe = _fleet(True, 1)
    eng = fe.replicas[0]
    inj = FaultInjector()
    inj.arm(eng, Fault("kill", at_step=0))
    assert "step" in eng.__dict__
    with pytest.raises(ReplicaFailure):
        eng.step()
    inj.disarm(eng)
    assert "step" not in eng.__dict__
    assert eng.step() is False
    inj.disarm(eng)
    with pytest.raises(AssertionError):
        Fault("explode")
    with pytest.raises(AssertionError):
        Fault("slow", slow_factor=1)


def test_slo_admission_sheds_typed_outcome():
    fe = _fleet(True, 1, admit_rows=2)
    fe._row_time = 0.1                         # seeded calibration
    fe.slo_p95_s = 1.0
    r0, r1, shed = wave([(0, 4), (4, 8), (8, 12)])
    out0 = fe.submit(r0)
    assert isinstance(out0, Admitted)
    assert out0.estimated_wait_s == pytest.approx(0.4)
    assert isinstance(fe.submit(r1), Admitted)
    out2 = fe.submit(shed)
    assert isinstance(out2, Rejected)
    assert out2.estimated_wait_s == pytest.approx(1.2)
    assert out2.slo_p95_s == 1.0 and out2.reason == "p95-budget"
    assert shed.rejected and not shed.done
    assert shed.rid not in fe._live and len(fe.queue) == 2
    st = fe.stats()
    assert st["rejected"] == 1 and st["rejected_rows"] == 4
    while fe.step():
        pass
    check_vs_jax([r0, r1], "int8")
    fe.slo_p95_s = None
    assert isinstance(fe.submit(shed), Admitted) and not shed.rejected
    while fe.step():
        pass
    check_vs_jax([shed], "int8")


def test_slo_none_or_uncalibrated_always_admits():
    fe = _fleet(True, 1)
    assert fe._row_time is None
    fe.slo_p95_s = 1e-9                        # absurd budget, no data
    out = fe.submit(request(0, 0, 2))
    assert isinstance(out, Admitted) and out.estimated_wait_s is None
    while fe.step():
        pass
    fe.slo_p95_s = None
    fe._row_time = 10.0                        # huge, but no budget
    assert isinstance(fe.submit(request(1, 2, 4)), Admitted)
    while fe.step():
        pass


def test_reset_service_rate_and_survival_across_reset_stats():
    fe = _fleet(True, 1)
    fe.run(_wave(0))
    assert fe._row_time is not None
    fe.reset_stats()
    assert fe._row_time is not None
    assert fe.stats()["est_row_time_s"] == fe._row_time
    fe.reset_service_rate()
    assert fe._row_time is None


def test_poisson_plan_deterministic_and_shaped():
    mix = ((1, 0.75), (2, 0.25))
    p1 = poisson_plan(rate_rps=50, n_requests=20, image_pool=POOL[:8],
                      size_mix=mix, seed=7)
    p2 = poisson_plan(rate_rps=50, n_requests=20, image_pool=POOL[:8],
                      size_mix=mix, seed=7)
    assert [a.t for a in p1] == [a.t for a in p2]
    for a, b in zip(p1, p2):
        np.testing.assert_array_equal(a.req.images, b.req.images)
    assert {len(a.req.images) for a in p1} <= {1, 2}
    assert all(p1[i].t < p1[i + 1].t for i in range(len(p1) - 1))
    assert offered_rows_per_s(p1) > 0
    rids = [a.req.rid for a in poisson_plan(rate_rps=1, n_requests=3,
                                            image_pool=POOL, seed=0,
                                            rid_base=100)]
    assert rids == [100, 101, 102]


def _calibrated(fe):
    """Warm both microbatch shapes, then measure the service rate on
    steady completions only; returns the fleet's rows per second."""
    fe.run([FrontendRequest(rid=-2, images=POOL[:MB]),
            FrontendRequest(rid=-1, images=POOL[:1])])
    fe.reset_service_rate()
    fe.run([FrontendRequest(rid=-3, images=POOL[:MB])])
    return 1.0 / fe._row_time


def test_open_loop_conservation_and_exactness():
    fe = _fleet(True, 1)
    cap = _calibrated(fe)
    fe.reset_stats()
    plan = poisson_plan(rate_rps=0.5 * cap / 1.25, n_requests=8,
                        image_pool=POOL[:8], size_mix=((1, 3), (2, 1)),
                        seed=3)
    res = run_open_loop(fe, plan, max_wall_s=120)
    assert res["admitted"] + res["rejected"] == res["offered"] == 8
    assert res["rejected"] == 0
    assert res["latency_p95_s"] >= res["latency_p50_s"] > 0
    _check_open_loop(res["admitted_requests"])


def test_open_loop_overload_sheds_under_slo():
    fe = _fleet(True, 1)
    cap = _calibrated(fe)
    fe.slo_p95_s = 10 * fe._row_time
    fe.reset_stats()
    plan = poisson_plan(rate_rps=16 * cap / 1.25, n_requests=16,
                        image_pool=POOL[:8], size_mix=((1, 3), (2, 1)),
                        seed=5)
    res = run_open_loop(fe, plan, max_wall_s=120)
    assert res["admitted"] + res["rejected"] == 16
    assert res["rejected"] > 0, res
    assert fe.stats()["rejected"] == res["rejected"]
    _check_open_loop(res["admitted_requests"])
    for r in res["rejected_requests"]:
        assert r.rejected and r.logits is None
