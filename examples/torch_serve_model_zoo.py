"""Model zoo through one serving stack on the PyTorch port: claim ->
projection -> executed (ports ``examples/serve_model_zoo.py``).

The paper's compiled-CNN recipe (constant int8 parameters burned into
the kernels, per-row quantized activation edges, pipeline partitioning
at those edges) is model-agnostic: anything expressible as the conv DAG
IR (models/graph.py) serves through the same PipelineEngine +
ResNetFrontend unchanged.  This driver proves it on the whole zoo:

  resnet50      — the paper's network (bottleneck residuals)
  mobilenet_v2  — inverted residuals on the depthwise kernel, no-ReLU
                  linear bottlenecks quantized via max|y|
  repvgg_a0     — 3x3 + 1x1 + identity branches folded into ONE 3x3
                  conv per block at compile time (train-time DAG,
                  deploy-time chain)

Per model: the analytic FPGA projection for the full-scale network
(partition.solve_max_throughput — the Fig 7 discipline applied beyond
ResNet), then a width-scaled instance executed through the replicated
fleet frontend with the output gated bit-identical to the single-device
compiled reference.

Run:  PYTHONPATH=src python examples/torch_serve_model_zoo.py \\
          [--width 0.25 --hw 32 --stages 2 --replicas 1 --mode int8 \\
           --device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core import partition
from repro_torch.core.compiled_linear import compile_params
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import mobilenet_v2 as mb
from repro_torch.models import repvgg, resnet
from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
from repro_torch.serving.pipeline import reference_logits


def _zoo(args):
    """name -> (claim line, full-scale cfg, executable cfg + params)."""
    w, hw = args.width, args.hw
    r = resnet.ResNetConfig(width_mult=w, num_classes=100, in_hw=hw)
    m = mb.MobileNetV2Config(width_mult=w, num_classes=100, in_hw=hw)
    v = repvgg.RepVGGConfig(width_mult=w, num_classes=100, in_hw=hw)
    gen = lambda: torch.Generator().manual_seed(0)
    vu = v.init(gen())
    return {
        "resnet50": (
            "the paper's network: bottleneck residuals, shortcut adds in "
            "the Collector epilogue",
            resnet.ResNetConfig(), r, r.init(gen())),
        "mobilenet_v2": (
            "depthwise separable blocks on the tap-MAC kernel; linear "
            "bottlenecks quantize via max|y| (no ReLU needed)",
            mb.MobileNetV2Config(), m, m.init(gen())),
        "repvgg_a0": (
            f"{sum(1 for _ in repvgg.block_specs(v))} three-branch train "
            "blocks re-parameterized into single 3x3 convs at compile "
            "time — the served chain never sees the 1x1/identity branches",
            repvgg.RepVGGConfig(), v, v.fuse(vu)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--mode", default="int8",
                    choices=("int8", "cfmm", "sparse_cfmm"))
    ap.add_argument("--images", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    out = {}
    for name, (claim, full_cfg, cfg, params) in _zoo(args).items():
        print(f"\n=== {name} ===")
        print(f" claim: {claim}")

        blocks = full_cfg.graph().blocks()
        proj = partition.solve_max_throughput(blocks)
        print(f" projection (full scale, {len(blocks)} conv blocks, "
              f"analytic FPGA model): {proj.im_s_per_chip:.0f} im/s/chip "
              f"on {proj.n_chips} chip(s), max link "
              f"{proj.max_link_gbps:.1f} Gbps")

        compiled = nn.unbox(compile_params(params, mode=args.mode,
                                           sparsity=0.8))
        x = np.random.RandomState(1).randn(
            args.images, cfg.in_hw, cfg.in_hw, 3).astype(np.float32)
        ref = reference_logits(nn.to_device(compiled, dev), cfg,
                               torch.from_numpy(x).to(dev),
                               args.microbatch).cpu().numpy()
        fe = ResNetFrontend(cfg, compiled, mode=args.mode,
                            n_replicas=args.replicas,
                            n_stages=args.stages,
                            microbatch=args.microbatch, device=dev)
        warm = FrontendRequest(rid=0, images=x)
        fe.run([warm])                         # builds every kernel
        np.testing.assert_array_equal(warm.logits, ref)
        t0 = time.time()
        req = FrontendRequest(rid=1, images=x)
        fe.run([req])
        wall = time.time() - t0
        np.testing.assert_array_equal(req.logits, ref)
        st = fe.replicas[0].stats()
        n_blocks = sum(len(b) for b in st["stage_blocks"])
        print(f" executed (width {args.width}, {cfg.in_hw}x{cfg.in_hw}, "
              f"mode {args.mode}, {args.replicas} replica(s) x "
              f"{args.stages} stage(s), {n_blocks} conv blocks): "
              f"{args.images / wall:.1f} im/s, output bit-identical to "
              f"the single-device compiled path; inter-stage links "
              f"{st['planned_link_bytes']} B/img")
        out[name] = dict(projection=proj.summary(), n_blocks=n_blocks,
                         planned_link_bytes=st["planned_link_bytes"])

    print("\nserve_model_zoo OK")
    return out


if __name__ == "__main__":
    main()
