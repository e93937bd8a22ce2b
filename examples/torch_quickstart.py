"""Quickstart on the PyTorch port: the paper's technique in five minutes
(ports ``examples/quickstart.py``).

1. Quantize a weight matrix to INT7 (per-output-channel, paper SS II-A).
2. Decompose into CFMM form — sign / 32 odd magnitudes / free shifts
   (paper SS II-E.1) and verify the counting argument.
3. Run the three equivalent compiled matmul dataflows and check they are
   bit-exact against each other.
4. Prune to 80% sparsity, bitmap-pack, and show the storage win that
   becomes decode bandwidth.
5. Compile a whole model's parameters and serve one batch (on the card:
   the sparse matmul and flash-attention kernels).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import nn
from repro_torch.core import cfmm
from repro_torch.core.compiled_linear import (balanced_prune_codes,
                                              bitmap_pack, bitmap_unpack,
                                              compile_params)
from repro_torch.core.quantize import quantization_error, quantize_int7
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.serve import build_cfg
from repro_torch.models import lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. INT7 quantization -----------------------------------------------
    w = torch.randn((512, 256), generator=gen, device=dev) * 0.05
    qt = quantize_int7(w, axis=-1)
    print(f"1. INT7 quantization: relative L2 error "
          f"{float(quantization_error(w)):.4%} (paper: 0.22% top-1 loss)")

    # -- 2. CFMM decomposition ----------------------------------------------
    sign, mag_idx, shift = cfmm.decompose(qt.values)
    assert torch.equal(cfmm.reconstruct(sign, mag_idx, shift),
                       qt.values.to(torch.int32))
    n_unique = cfmm.unique_product_count(qt.values)
    print(f"2. CFMM: {n_unique} unique odd product magnitudes (paper: <= "
          f"{cfmm.N_UNIQUE_PRODUCTS}); decompose/reconstruct exact")

    # -- 3. Three equivalent compiled dataflows -----------------------------
    x_q = torch.randint(-127, 127, (8, 512), generator=gen, device=dev,
                        dtype=torch.int8)
    y_table = cfmm.cfmm_matmul_exact(x_q, cfmm.pack(qt.values, qt.scale))
    y_mxu = cfmm.cfmm_matmul_int8(x_q, qt.values)
    y_bits = cfmm.bitserial_matmul(x_q, qt.values)
    assert torch.equal(y_table, y_mxu) and torch.equal(y_mxu, y_bits)
    print("3. product-table == decode+int8 GEMM == bit-serial dataflows: "
          "bit-exact")

    # -- 4. 80% sparsity, bitmap packing ------------------------------------
    keep = int(512 * 0.2)
    codes = balanced_prune_codes(w, keep).values
    bitmap, values = bitmap_pack(codes, keep)
    assert torch.equal(bitmap_unpack(bitmap, values), codes)
    dense_bf16 = 512 * 256 * 2
    packed = bitmap.numel() + values.numel()
    print(f"4. 80% sparse bitmap pack: {packed} B vs {dense_bf16} B bf16 "
          f"({dense_bf16 / packed:.1f}x less weight traffic at decode)")

    # -- 5. Compile + serve a tiny model ------------------------------------
    cfg = build_cfg("smollm_360m", "tiny")
    params = lm.init(gen, cfg)
    served = compile_params(params, mode="sparse_cfmm", sparsity=0.8)
    toks = torch.randint(1, cfg.vocab, (2, 16), generator=gen, device=dev)
    cache = nn.unbox(lm.cache_init(cfg, 2, 32, device=dev))
    logits, cache = lm.forward_prefill(nn.unbox(served), {"tokens": toks},
                                       cfg, cache)
    finite = bool(torch.isfinite(logits.float()).all())
    assert finite
    print(f"5. compiled sparse-INT7 model served a prompt: logits "
          f"{tuple(logits.shape)}, finite={finite}")
    print("quickstart OK")
    return dict(unique_products=n_unique, packed_bytes=packed,
                dense_bf16_bytes=dense_bf16, bitmap_shape=tuple(bitmap.shape),
                values_shape=tuple(values.shape),
                logits_shape=tuple(logits.shape))


if __name__ == "__main__":
    main()
