"""Batched LM serving on the PyTorch port: all four compiled-weight modes
side by side (ports ``examples/serve_lm.py``).

Serves the same request batch with dense bf16, INT7 (int8 storage), CFMM
and 80%-sparse bitmap-packed weights, and reports agreement + packed
sizes.  On the card the int8 and cfmm modes' linears run the
``cfmm_matmul`` kernel, ``sparse_cfmm``'s the sparse matmul kernel, and
every prefill the flash-attention kernel.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import nn
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.serve import build_cfg
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg("smollm_360m", "tiny")
    params = lm.init(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab, size=12)) for _ in range(4)]

    results, sizes = {}, {}
    for mode in ("dense", "int8", "cfmm", "sparse_cfmm"):
        engine = ServingEngine(cfg, params, mode=mode, batch_slots=2,
                               max_seq=40, device=dev)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        t0 = time.time()
        engine.run(reqs)
        dt = time.time() - t0
        results[mode] = [r.tokens_out for r in reqs]
        sizes[mode] = sum(t.numel() * t.element_size()
                          for t in nn.tree_leaves(engine.params)
                          if isinstance(t, torch.Tensor))
        print(f"mode={mode:12s} params={sizes[mode] / 1e6:6.2f} MB  "
              f"{sum(len(t) for t in results[mode])} tokens in {dt:.1f}s")

    agree = np.mean([results["dense"][i] == results["int8"][i]
                     for i in range(len(prompts))])
    print(f"dense vs int8 greedy-token agreement: {agree:.0%} "
          f"(INT7 ~ FP32, paper: 0.22% accuracy delta)")
    print("serve_lm OK")
    return dict(tokens=results, param_bytes=sizes, agreement=float(agree))


if __name__ == "__main__":
    main()
