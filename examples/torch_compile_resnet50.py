"""The paper, end to end, on the PyTorch port: compile a sparse INT7
ResNet50 and reproduce its tables (ports ``examples/compile_resnet50.py``).

1. Build ResNet50 (the paper's network), quantize + prune per SS II-A.
2. Reproduce Table I (design parameters) exactly from the architecture.
3. Reproduce Table II structure from the calibrated FPGA cost model
   (fold=4 for conv5, 4-instance 127k-ALM conv2 kernels...).
4. Reproduce the Fig 7 multi-chip partitioning and compare with the
   paper's projection and the V100 bound.
5. Run the compiled (sparse INT7) model vs the fp32 baseline on a batch
   and report logit agreement — the "0.22% accuracy delta" proxy that is
   checkable without ImageNet.  On the card every compiled mode runs the
   port's conv kernels and its head the ``cfmm_matmul`` or sparse matmul
   kernel; the fp32 baseline is the dense reference forward.

Run:  PYTHONPATH=src python examples/torch_compile_resnet50.py \\
          [--width 0.25 --hw 64 --device cpu]
"""
import argparse
import json

import torch

from repro_torch import nn
from repro_torch.core import partition
from repro_torch.core.compiled_linear import (SERVE_MODES,
                                              balanced_prune_codes,
                                              compile_params)
from repro_torch.core.fpga_model import table2_model
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import resnet


def presparsify(p):
    """The paper starts from an already 80 %-sparse model: keep each
    column's top 20 % of |w| (a multiple of 8, at least 8)."""
    if isinstance(p, nn.Param) and nn.compilable(p.kind) \
            and p.value.ndim == 2:
        keep = max(8, int(p.value.shape[0] * 0.2) // 8 * 8)
        qt = balanced_prune_codes(p.value.float(), keep)
        return nn.Param(torch.where(qt.values != 0, p.value,
                                    torch.zeros_like(p.value)),
                        p.axes, p.kind)
    return p


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in nn.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=float, default=0.25,
                    help="width multiplier for the runnable demo model")
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== Table I: key design parameters (exact reproduction) ===")
    t1 = resnet.table1()
    print(json.dumps(t1, indent=1))
    assert t1["conv2_x"]["mac_per_param"] == 3136
    assert t1["conv5_x"]["mac_per_param"] == 49
    assert all(row["total_macs_m"] == 218 for row in t1.values())

    print("=== Table II: calibrated cost model vs actuals ===")
    t2 = table2_model()
    for corner in ("conv2", "conv5"):
        m, a = t2[corner]["model"], t2[corner]["actual"]
        print(f" {corner}: fold model={m['fold']} actual={a['folding']} | "
              f"ALM/kernel model={m['alm_per_kernel'] / 1e3:.0f}k "
              f"actual={a['alm_per_kernel'] / 1e3:.0f}k | "
              f"MOPs/ALM model={m['mops_per_alm']:.0f} "
              f"actual={a['mops_per_alm']}")

    print("=== Fig 7: multi-chip partitioning ===")
    f7 = partition.fig7_projection()
    print(json.dumps({k: f7[k] for k in ("at_paper_target", "model_best",
                                         "gx550_scaling")},
                     indent=1, default=lambda o: round(o, 2)))

    print("=== Compiled sparse-INT7 ResNet50 vs fp32 sparse baseline ===")
    # The paper starts from an ALREADY 80%-sparse model (Movidius/AMC);
    # we emulate that by pre-pruning, then measure what compilation adds
    # (INT7 quantization) — the analogue of the paper's 0.22% delta.
    cfg = resnet.ResNetConfig(width_mult=args.width, num_classes=100,
                              in_hw=args.hw)
    params = resnet.init(torch.Generator(device=dev).manual_seed(0), cfg)
    sparse_params = nn.tree_map(presparsify, params,
                                is_leaf=lambda x: isinstance(x, nn.Param))
    x = torch.randn((2, args.hw, args.hw, 3),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    ref = resnet.apply(nn.unbox(sparse_params), x, cfg)
    # every serving mode runs the fused implicit-GEMM conv pipeline; all
    # must land within quantization tolerance of the dense baseline on
    # the same sparse weights
    out_modes = {}
    for mode in SERVE_MODES:
        if mode == "dense":
            continue
        compiled = nn.unbox(compile_params(sparse_params, mode=mode,
                                           sparsity=0.8))
        out = resnet.apply(compiled, x, cfg)
        top1_match = float(torch.mean((out.argmax(-1) == ref.argmax(-1))
                                      .float()))
        rel = float(torch.linalg.norm(out - ref) / torch.linalg.norm(ref))
        nbytes = tree_bytes(compiled)
        print(f" {mode:12s} compilation (INT7) error on the sparse model: "
              f"logits rel err {rel:.4f}; top-1 agreement {top1_match:.0%} "
              f"(paper: 0.22% top-1 delta); compiled tree {nbytes} B")
        assert rel < 0.15, (mode, rel)
        out_modes[mode] = dict(rel_err=rel, top1=top1_match, bytes=nbytes)
    print("compile_resnet50 OK")
    return dict(table1=t1, table2=t2, fig7=f7, modes=out_modes)


if __name__ == "__main__":
    main()
