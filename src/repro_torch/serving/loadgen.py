"""Open-loop load generation for the serving fleet (a copy of
``repro/serving/loadgen.py``, numpy only).

Every bench before this one was *closed-loop*: submit a wave, drain it,
measure.  Closed loops flatter a server — offered load automatically
throttles to service rate, so the queue can never run away.  Production
traffic is OPEN loop: arrivals are a Poisson process that does not care
how busy the fleet is, and the front door must hold (queue) or refuse
(shed) what the replicas cannot absorb.  This module manufactures that
traffic deterministically:

* ``poisson_plan`` draws exponential inter-arrival gaps at a target
  request rate plus a request-size mix (the "millions of users" traffic
  is mostly 1-image requests with a heavier tail), seeded, with every
  request's images taken as a contiguous row slice of a caller-provided
  pool — so the bit-identity reference for any request is just
  ``reference_logits`` over the same slice.
* ``run_open_loop`` replays a plan against a ``ResNetFrontend`` in wall
  time: submit every arrival whose time has come, step the fleet,
  sleep only when genuinely idle, and classify each submit outcome by
  its type (``Admitted`` vs ``Rejected`` — the SLO admission surface).

``chip_smoke.py``'s fleet phase replays a plan at a fraction of the
fleet's measured capacity on the card and reports p50/p95 latency.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.serving.frontend import FrontendRequest, Rejected


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One planned request: submit at ``t`` seconds after wave start."""
    t: float
    req: FrontendRequest


def poisson_plan(*, rate_rps: float, n_requests: int,
                 image_pool: np.ndarray,
                 size_mix=((1, 1.0),), seed: int = 0,
                 rid_base: int = 0) -> list:
    """A deterministic open-loop arrival plan: ``n_requests`` requests
    with exponential inter-arrival gaps at ``rate_rps`` requests/s and
    row counts drawn from ``size_mix`` (pairs of ``(rows, weight)``).
    Each request's images are a contiguous slice of ``image_pool``
    (shape ``(P, H, W, 3)``), so its logits reference is cheap to
    compute and bit-comparisons stay trivial.  Same seed, same plan."""
    assert rate_rps > 0 and n_requests >= 0, (rate_rps, n_requests)
    sizes = np.asarray([s for s, _ in size_mix], dtype=int)
    weights = np.asarray([w for _, w in size_mix], dtype=float)
    assert (sizes >= 1).all() and (weights > 0).all(), size_mix
    assert sizes.max() <= len(image_pool), (sizes.max(), len(image_pool))
    weights = weights / weights.sum()
    rng = np.random.RandomState(seed)
    t, plan = 0.0, []
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        n = int(sizes[rng.choice(len(sizes), p=weights)])
        off = int(rng.randint(0, len(image_pool) - n + 1))
        plan.append(Arrival(t, FrontendRequest(
            rid=rid_base + i, images=image_pool[off:off + n])))
    return plan


def offered_rows_per_s(plan: list) -> float:
    """The plan's offered load in rows/s (total rows over the arrival
    horizon) — what capacity multiples are computed against."""
    if not plan:
        return 0.0
    rows = sum(len(a.req.images) for a in plan)
    horizon = max(a.t for a in plan)
    return rows / horizon if horizon > 0 else float("inf")


def run_open_loop(frontend, plan: list, *, max_wall_s: float | None = None,
                  clock=time.perf_counter) -> dict:
    """Replay ``plan`` against ``frontend`` in wall time and drain.

    Arrivals are submitted the moment their time comes — regardless of
    fleet load, that is what "open loop" means — and classified by the
    typed submit outcome.  The fleet steps continuously while busy and
    sleeps in short slices when idle between arrivals.  Returns the
    admitted/rejected request lists plus wall-clock, goodput, and
    latency aggregates (latencies from the requests' own submit→done
    stamps).  ``max_wall_s`` is the last-resort guard: a fleet that
    cannot drain the admitted work raises TimeoutError."""
    plan = sorted(plan, key=lambda a: a.t)
    admitted, rejected = [], []
    tel = getattr(frontend, "telemetry", None)
    tr = tel.trace if tel is not None else None
    t0 = clock()
    i = 0
    while True:
        now = clock() - t0
        while i < len(plan) and plan[i].t <= now:
            if tr is not None:
                # the arrival instant (the shed instant, if any, comes
                # from submit itself)
                tr.instant("arrival", "loadgen", 0, plan[i].req.rid,
                           rid=plan[i].req.rid,
                           rows=len(plan[i].req.images),
                           planned_t_s=plan[i].t)
            out = frontend.submit(plan[i].req)
            (rejected if isinstance(out, Rejected)
             else admitted).append(plan[i].req)
            i += 1
        busy = frontend.step()
        if i >= len(plan) and not busy:
            break
        now = clock() - t0
        if not busy and i < len(plan) and plan[i].t > now:
            time.sleep(min(plan[i].t - now, 0.005))
        if max_wall_s is not None and now > max_wall_s:
            err = TimeoutError(
                f"open-loop wave exceeded max_wall_s={max_wall_s} with "
                f"{i}/{len(plan)} arrivals submitted")
            err.fleet_stats = frontend.stats()
            raise err
    wall = clock() - t0
    lats = [r.latency_s for r in admitted if r.latency_s is not None]
    rows_admitted = sum(len(r.images) for r in admitted)
    return {
        "offered": len(plan),
        "offered_rows": sum(len(a.req.images) for a in plan),
        "admitted": len(admitted),
        "rejected": len(rejected),
        "shed_fraction": len(rejected) / len(plan) if plan else 0.0,
        "wall_s": wall,
        "goodput_rows_s": rows_admitted / wall if wall > 0 else None,
        "latency_p50_s": (float(np.percentile(lats, 50)) if lats else None),
        "latency_p95_s": (float(np.percentile(lats, 95)) if lats else None),
        "admitted_requests": admitted,
        "rejected_requests": rejected,
    }
