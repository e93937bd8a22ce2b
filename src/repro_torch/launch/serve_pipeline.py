"""Pipeline-parallel ResNet serving driver — the executable Fig 7 (ports
``repro/launch/serve_pipeline.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve_pipeline \\
      --stages 2 --microbatch 2 --mode sparse_cfmm --width 1.0 --hw 224

Plans stages (MAC-balanced, or from the Fig 7 chip packing with
--from-partition), places each stage's constant weights on its device
(stages wrap round-robin over the visible cards), and streams
microbatched requests through the rotating schedule.  Runs on the card
unless ``--device cpu`` is given; raises when CUDA is absent otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import partition
from repro_torch.core.compiled_linear import SERVE_MODES
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import resnet
from repro_torch.serving.pipeline import PipelineEngine, PipelineRequest


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--mode", default="int8", choices=SERVE_MODES)
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--from-partition", action="store_true",
                    help="stage map from the Fig 7 chip packing "
                         "(re-balanced to --stages) instead of MACs")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = resnet.ResNetConfig(width_mult=args.width, num_classes=100,
                              in_hw=args.hw)
    params = resnet.init(torch.Generator().manual_seed(0), cfg)
    plan = None
    if args.from_partition:
        blocks = resnet.conv_blocks_for(cfg)
        plan = partition.solve_max_throughput(blocks).stage_plans(
            blocks, args.stages)
    engine = PipelineEngine(cfg, params, mode=args.mode,
                            sparsity=args.sparsity, n_stages=args.stages,
                            plan=plan, microbatch=args.microbatch,
                            device=args.device)
    rng = np.random.RandomState(0)
    reqs = [PipelineRequest(rid=i, images=rng.randn(
        args.images // 2, args.hw, args.hw, 3).astype(np.float32))
            for i in range(2)]
    engine.run(reqs)                       # warmup (builds the kernels)
    for r in reqs:
        engine.submit(r)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.step():
        pass
    dt = time.perf_counter() - t0          # step() reads every output back
    st = engine.stats()
    n_img = sum(len(r.images) for r in reqs)
    where = (torch.cuda.get_device_name(0) if dev.type == "cuda"
             else "cpu")
    print(f"[pipeline] {st['n_stages']} stages on "
          f"{len(set(st['stage_devices']))} device(s) ({where}), "
          f"microbatch {st['microbatch']}, mode {args.mode}: {n_img} "
          f"images in {dt:.3f}s ({n_img / dt:.1f} im/s wall), bubble "
          f"{st['bubble_fraction']:.2f}")
    for s, blocks_ in enumerate(st["stage_blocks"]):
        w = st["stage_weight_bytes"][s]
        print(f"  stage {s}: blocks {blocks_[0]}..{blocks_[-1]} "
              f"({w / 1e3:.0f} kB resident) on {st['stage_devices'][s]}")
    for e, b in enumerate(st["edge_bytes"]):
        print(f"  edge {e}->{e + 1}: {b['int8_bytes']} B int8 / microbatch "
              f"(+{b['meta_bytes']} B scale), planned "
              f"{st['planned_link_bytes'][e] * st['microbatch']} B")
    return engine


if __name__ == "__main__":
    main()
