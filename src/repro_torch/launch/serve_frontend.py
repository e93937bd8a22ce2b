"""Replicated-pipeline serving driver — N Fig 7 chains behind one front
door (ports ``repro/launch/serve_frontend.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve_frontend \
      --replicas 2 --stages 2 --microbatch 2 --mode sparse_cfmm \
      --width 0.25 --hw 32
  PYTHONPATH=src python -m repro_torch.launch.serve_frontend --device cpu \
      --width 0.125 --hw 16 --replicas 2 --requests 6 --rows 3

Carves per-replica device groups from the visible cards (with fewer
cards than replicas x stages, the groups wrap: on one card every replica
shares it), compiles the model ONCE, places each replica's stage
subtrees on its own group, and streams a wave of requests through the
shared admission queue with least-loaded routing — reporting aggregate
throughput, per-replica rows/bubble, queue depth, and p50/p95 request
latency.  Runs on the card unless ``--device cpu`` is given; raises when
CUDA is absent otherwise.

Fault drill (--kill-replica R [--kill-step K]): after the healthy wave,
arm a fail-stop on replica R, rerun the same traffic, report the
watchdog/requeue recovery, then restart the replica and show the fleet
rebalanced.  Open loop (--open-loop FACTOR [--slo-rows N]): replay a
Poisson arrival plan at FACTOR x the fleet's measured row capacity, with
an optional p95 admission budget of N measured row-times — reports
goodput, shed fraction, and p50/p95 (DESIGN.md §10).

Telemetry (--trace out.json [--sparsity-groups G]): attach a
``repro_torch.obs.Telemetry`` to the fleet and save the whole serve — request
admission/queue/dispatch/collect lifecycles, per-stage tick spans, idle
and edge markers — as Chrome trace-event JSON, loadable directly at
https://ui.perfetto.dev (DESIGN.md §11).  ``--sparsity-groups`` also
profiles post-ReLU activation sparsity and prints the per-layer summary.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.compiled_linear import SERVE_MODES
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import resnet
from repro_torch.obs import Telemetry
from repro_torch.serving.faults import Fault, FaultInjector
from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
from repro_torch.serving.loadgen import (offered_rows_per_s, poisson_plan,
                                         run_open_loop)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--mode", default="int8", choices=SERVE_MODES)
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--stages", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rows", type=int, default=4,
                    help="images per request")
    ap.add_argument("--watchdog-ticks", type=int, default=8,
                    help="no-progress steps before a replica is failed")
    ap.add_argument("--kill-replica", type=int, default=None, metavar="R",
                    help="fault drill: fail-stop replica R mid-wave, "
                         "recover, restart")
    ap.add_argument("--kill-step", type=int, default=2,
                    help="engine step (after arming) at which the "
                         "fail-stop engages")
    ap.add_argument("--open-loop", type=float, default=None,
                    metavar="FACTOR",
                    help="Poisson open-loop wave at FACTOR x measured "
                         "capacity")
    ap.add_argument("--slo-rows", type=float, default=None, metavar="N",
                    help="p95 admission budget: N x measured per-row "
                         "time (open loop only; default: no shedding)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the serve as Chrome trace-event JSON "
                         "(open in https://ui.perfetto.dev)")
    ap.add_argument("--sparsity-groups", type=int, default=None,
                    metavar="G",
                    help="profile post-ReLU activation sparsity per "
                         "G-channel coarse_in group (adds per-layer "
                         "zero-count outputs to the conv kernels)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    telemetry = None
    if args.trace is not None or args.sparsity_groups is not None:
        telemetry = Telemetry(trace=True if args.trace else None,
                              sparsity_groups=args.sparsity_groups)

    cfg = resnet.ResNetConfig(width_mult=args.width, num_classes=100,
                              in_hw=args.hw)
    params = resnet.init(torch.Generator().manual_seed(0), cfg)
    fe = ResNetFrontend(cfg, params, mode=args.mode,
                        sparsity=args.sparsity, n_replicas=args.replicas,
                        n_stages=args.stages, microbatch=args.microbatch,
                        device=args.device,
                        watchdog_ticks=args.watchdog_ticks,
                        telemetry=telemetry)
    rng = np.random.RandomState(0)

    def wave():
        return [FrontendRequest(rid=i, images=rng.randn(
            args.rows, args.hw, args.hw, 3).astype(np.float32))
            for i in range(args.requests)]

    fe.run(wave())                     # warmup (builds the kernels)
    fe.reset_stats()
    reqs = wave()
    t0 = time.time()
    fe.run(reqs)                       # step() reads every output back
    dt = time.time() - t0
    st = fe.stats()
    n_img = args.requests * args.rows
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "cpu")
    print(f"[frontend] {st['n_replicas']} replica(s) x "
          f"{st['replicas'][0]['n_stages']} stage(s) ({where}), microbatch "
          f"{st['microbatch']}, mode {args.mode}: {n_img} images / "
          f"{args.requests} requests in {dt:.2f}s ({n_img / dt:.1f} im/s "
          "wall)")
    print(f"  latency p50 {st['latency_p50_s'] * 1e3:.1f} ms | p95 "
          f"{st['latency_p95_s'] * 1e3:.1f} ms | max queue depth "
          f"{st['max_queue_depth']}")
    for r, rs in enumerate(st["replicas"]):
        print(f"  replica {r}: {st['rows_dispatched'][r]} rows / "
              f"{st['requests_dispatched'][r]} requests, bubble "
              f"{rs['bubble_fraction']:.2f}, devices {rs['stage_devices']}")

    if args.kill_replica is not None:
        inj = FaultInjector()
        inj.arm(fe.replicas[args.kill_replica],
                Fault("kill", at_step=args.kill_step))
        fe.reset_stats()
        reqs = wave()
        t0 = time.time()
        fe.run(reqs)
        dt = time.time() - t0
        st = fe.stats()
        done = sum(r.done for r in reqs)
        print(f"[faults] killed replica {args.kill_replica} at step "
              f"{args.kill_step}: {done}/{len(reqs)} requests completed "
              f"in {dt:.2f}s | replicas failed {st['replicas_failed']} | "
              f"{st['rows_requeued']} rows requeued over "
              f"{st['requeues']} spans")
        inj.disarm(fe.replicas[args.kill_replica])
        fe.restart_replica(args.kill_replica)
        fe.reset_stats()
        fe.run(wave())
        st = fe.stats()
        print(f"[faults] replica {args.kill_replica} restarted: "
              f"rows/replica {st['rows_dispatched']}, failures "
              f"{st['replicas_failed']}")

    if args.open_loop is not None:
        # warm the 1-row microbatch shape on every replica, then measure
        # the service rate on steady-state completions only
        fe.run([FrontendRequest(rid=-(r + 1),
                                images=rng.randn(1, args.hw, args.hw,
                                                 3).astype(np.float32))
                for r in range(args.replicas)])
        fe.reset_service_rate()
        fe.run(wave())
        st = fe.stats()
        cap = st["est_rows_per_s"]
        if args.slo_rows is not None:
            fe.slo_p95_s = args.slo_rows * st["est_row_time_s"]
        pool = rng.randn(8, args.hw, args.hw, 3).astype(np.float32)
        plan = poisson_plan(rate_rps=args.open_loop * cap / 1.25,
                            n_requests=args.requests, image_pool=pool,
                            size_mix=((1, 3.0), (2, 1.0)), seed=0,
                            rid_base=10_000)
        fe.reset_stats()
        res = run_open_loop(fe, plan)
        print(f"[open-loop] {args.open_loop:.1f}x capacity "
              f"({cap:.1f} rows/s): offered "
              f"{offered_rows_per_s(plan):.1f} rows/s | admitted "
              f"{res['admitted']}/{res['offered']} | shed "
              f"{res['rejected']} ({res['shed_fraction']:.0%}) | goodput "
              f"{res['goodput_rows_s']:.1f} rows/s | p50 "
              f"{res['latency_p50_s'] * 1e3:.1f} ms | p95 "
              f"{res['latency_p95_s'] * 1e3:.1f} ms")

    if telemetry is not None and telemetry.sparsity is not None:
        snap = telemetry.sparsity.snapshot()
        print(f"[sparsity] {snap['microbatches_profiled']} microbatches, "
              f"{len(snap['layers'])} layers, overall post-ReLU zero "
              f"fraction {snap['overall_zero_fraction']:.3f} "
              f"(groups of {snap['groups']})")
        worst = sorted(snap["layers"].items(),
                       key=lambda kv: -kv[1]["zero_fraction"])[:3]
        for name, lay in worst:
            print(f"  {name}: zero {lay['zero_fraction']:.3f}, all-zero "
                  f"{snap['groups']}-lane cells "
                  f"{max(lay['group_allzero_cell_fraction']):.3f} (max "
                  f"group)")
    if args.trace is not None:
        telemetry.trace.save(args.trace)
        n = len(telemetry.trace.spans) + len(telemetry.trace.instants)
        print(f"[trace] {n} events -> {args.trace} "
              f"(validate: python -m repro_torch.obs.trace {args.trace}; "
              f"view: https://ui.perfetto.dev)")
    return fe


if __name__ == "__main__":
    main()
