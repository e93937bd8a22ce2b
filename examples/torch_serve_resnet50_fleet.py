"""The paper's deployment, scaled out, on the PyTorch port: a FLEET of
Fig 7 pipelines behind one admission queue (ports
``examples/serve_resnet50_fleet.py``).

1. Project the single-pipeline Fig 7 numbers with the analytic FPGA
   model, then scale by the replica count — the fleet-law aggregate.
2. Build a ``ResNetFrontend``: ONE compiled param tree, N replicas x S
   stages on device groups carved from the local devices (groups wrap
   round-robin over the visible cards; one card holds every replica).
3. Stream a wave of differently-sized requests through the shared queue
   and verify every request's logits are bit-identical to the
   single-device compiled path at the same microbatch granularity.
4. Report aggregate im/s, per-replica routing, queue depth, and request
   latency p50/p95.

Run:  PYTHONPATH=src python examples/torch_serve_resnet50_fleet.py \\
          [--replicas 2 --stages 2 --width 0.25 --hw 32 --mode int8 \\
           --device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core import partition
from repro_torch.core.compiled_linear import compile_params
from repro_torch.core.fpga_model import FIG7
from repro_torch.launch.mesh import local_devices, resolve_device
from repro_torch.models import resnet
from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
from repro_torch.serving.pipeline import reference_logits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--mode", default="int8",
                    choices=("int8", "cfmm", "sparse_cfmm", "bitserial"))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== Fig 7 projection, scaled to a fleet ===")
    blocks50 = resnet.resnet50_conv_blocks()
    proj = partition.solve_max_throughput(blocks50)
    print(f" one pipeline: {proj.achieved_im_s:.0f} im/s on {proj.n_chips} "
          f"GX280s ({proj.im_s_per_chip:.0f} im/s/chip; paper claims "
          f"{FIG7['im_s_per_chip_gx280']})")
    print(f" {args.replicas} replicas: "
          f"{args.replicas * proj.achieved_im_s:.0f} im/s aggregate on "
          f"{args.replicas * proj.n_chips} chips — replicas share nothing "
          f"but the front door")

    print(f"=== executed fleet (width {args.width}, {args.hw}x{args.hw}, "
          f"mode {args.mode}, {args.replicas} replicas x {args.stages} "
          f"stages) ===")
    cfg = resnet.ResNetConfig(width_mult=args.width, num_classes=100,
                              in_hw=args.hw)
    params = resnet.init(torch.Generator().manual_seed(0), cfg)
    compiled = nn.unbox(compile_params(params, mode=args.mode, sparsity=0.8))
    fe = ResNetFrontend(cfg, compiled, mode=args.mode,
                        n_replicas=args.replicas, n_stages=args.stages,
                        microbatch=args.microbatch, device=dev)
    rng = np.random.RandomState(1)
    sizes = [args.microbatch * (1 + i % 3) + i % 2        # ragged sizes
             for i in range(args.requests)]
    reqs = [FrontendRequest(rid=i, images=rng.randn(
        s, args.hw, args.hw, 3).astype(np.float32))
        for i, s in enumerate(sizes)]
    fe.run(reqs)                               # builds every kernel
    on_dev = nn.to_device(compiled, dev)
    for r in reqs:
        ref = reference_logits(on_dev, cfg, torch.from_numpy(r.images)
                               .to(dev), args.microbatch)
        np.testing.assert_array_equal(r.logits, ref.cpu().numpy())
    print(f" every request bit-identical to the single-device compiled "
          f"path ({args.requests} requests, sizes {sizes})")

    fe.reset_stats()
    wave = [FrontendRequest(rid=i, images=r.images)
            for i, r in enumerate(reqs)]
    t0 = time.time()
    fe.run(wave)
    dt = time.time() - t0
    st = fe.stats()
    n_img = sum(sizes)
    print(f" wave 2 (warm): {n_img} images in {dt * 1e3:.0f} ms "
          f"({n_img / dt:.1f} im/s wall on "
          f"{len(local_devices(dev.type))} local device(s))")
    print(f" latency p50 {st['latency_p50_s'] * 1e3:.1f} ms | p95 "
          f"{st['latency_p95_s'] * 1e3:.1f} ms | max queue depth "
          f"{st['max_queue_depth']}")
    for r in range(st["n_replicas"]):
        rs = st["replicas"][r]
        print(f" replica {r}: {st['rows_dispatched'][r]:3d} rows / "
              f"{st['requests_dispatched'][r]} requests | bubble "
              f"{rs['bubble_fraction']:.2f} | stages on "
              f"{rs['stage_devices']}")
    print(" the fleet divides weights over stages WITHIN a replica and "
          "replicates across replicas;\n quantization domains are "
          "per-row, so microbatch neighbours cannot change anyone's bits")
    print("serve_resnet50_fleet OK")
    return dict(projection=proj.summary(), sizes=sizes, stats=st)


if __name__ == "__main__":
    main()
