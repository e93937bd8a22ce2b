"""Fig 7, executed on the PyTorch port: plan multi-chip stages with the
paper's partitioner, then run the partitioned ResNet as a pipeline with
persistent per-stage weights and 8-bit links (ports
``examples/serve_resnet50_pipeline.py``).

1. Partition full ResNet50 with the calibrated FPGA model
   (core/partition.solve_max_throughput) — the paper's Fig 7 projection.
2. Re-balance the chip packing to N executable stages (StagePlans) and
   launch a width-scaled compiled ResNet through the pipeline engine;
   stages wrap round-robin over the visible cards (one card holds all of
   them).
3. Verify the pipelined output is bit-identical to the single-device
   compiled path, then report achieved im/s (wall + pipeline-law) next
   to the Fig 7 projection and the paper's claim.

Run:  PYTHONPATH=src python examples/torch_serve_resnet50_pipeline.py \\
          [--stages 4 --width 0.25 --hw 32 --mode sparse_cfmm --device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core import partition
from repro_torch.core.compiled_linear import compile_params
from repro_torch.core.fpga_model import FIG7
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import resnet
from repro_torch.serving.pipeline import PipelineEngine, reference_logits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--mode", default="int8",
                    choices=("int8", "cfmm", "sparse_cfmm", "bitserial"))
    ap.add_argument("--images", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== Fig 7 projection (full ResNet50, analytic FPGA model) ===")
    blocks50 = resnet.resnet50_conv_blocks()
    proj = partition.solve_max_throughput(blocks50)
    print(f" model: {proj.im_s_per_chip:.0f} im/s/chip on {proj.n_chips} "
          f"GX280s at {proj.achieved_im_s:.0f} im/s total "
          f"(paper claims {FIG7['im_s_per_chip_gx280']} im/s/chip); "
          f"max link {proj.max_link_gbps:.1f} Gbps")
    plans50 = proj.stage_plans(blocks50, args.stages)
    print(f" as {len(plans50)} executable stages: " + "; ".join(
        f"S{p.index}: blocks {p.block_ids[0]}..{p.block_ids[-1]} "
        f"({p.link_gbps(proj.achieved_im_s):.0f} Gbps out)"
        if p.link_bytes else
        f"S{p.index}: blocks {p.block_ids[0]}..{p.block_ids[-1]}"
        for p in plans50))

    print(f"=== executed pipeline (width {args.width}, {args.hw}x{args.hw}, "
          f"mode {args.mode}, {args.stages} stages) ===")
    cfg = resnet.ResNetConfig(width_mult=args.width, num_classes=100,
                              in_hw=args.hw)
    params = resnet.init(torch.Generator().manual_seed(0), cfg)
    compiled = nn.unbox(compile_params(params, mode=args.mode, sparsity=0.8))
    blocks = resnet.conv_blocks_for(cfg)
    plan = partition.partition(blocks, 10_000.0).stage_plans(blocks,
                                                             args.stages)
    engine = PipelineEngine(cfg, compiled, mode=args.mode, plan=plan,
                            microbatch=args.microbatch, device=dev)
    x = np.random.RandomState(1).randn(args.images, args.hw, args.hw,
                                       3).astype(np.float32)
    got = engine.run_batch(x)                  # builds every kernel
    ref = reference_logits(nn.to_device(compiled, dev), cfg,
                           torch.from_numpy(x).to(dev), args.microbatch)
    np.testing.assert_array_equal(got, ref.cpu().numpy())
    print(" pipelined output bit-identical to the single-device compiled "
          "path")
    t0 = time.time()
    engine.run_batch(x)
    wall = time.time() - t0
    st = engine.stats()
    for s in range(st["n_stages"]):
        sb = st["stage_blocks"][s]
        print(f" stage {s} [{st['stage_devices'][s]}]: blocks "
              f"{sb[0]}..{sb[-1]}, {st['stage_weight_bytes'][s] / 1e3:.0f} kB "
              f"constant weights resident")
    for e, b in enumerate(st["edge_bytes"]):
        print(f" edge {e}->{e + 1}: {b['int8_bytes']} B int8/microbatch "
              f"(planned {st['planned_link_bytes'][e] * args.microbatch} B) "
              f"+ {b['meta_bytes']} B scale")
    print(f" achieved: {args.images / wall:.1f} im/s wall on "
          f"{len(set(st['stage_devices']))} device(s), bubble "
          f"{st['bubble_fraction']:.2f} (analytic "
          f"{st['bubble_fraction_analytic']:.2f})")
    print(f" Fig 7 context: the projection above sustains "
          f"{proj.achieved_im_s:.0f} im/s on {proj.n_chips} chips; this "
          f"demo runs the same partitioning discipline end to end on "
          f"local devices.")
    print("serve_resnet50_pipeline OK")
    return dict(projection=proj.summary(), stats=st, logits=got)


if __name__ == "__main__":
    main()
