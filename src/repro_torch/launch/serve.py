"""LM serving driver: compile-constant weights + continuous batching
(ports ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m \\
      --preset full --mode sparse_cfmm --requests 6 --prompt-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --preset tiny --mode dense --arch gemma3_1b

Initialises seeded random weights (on the device), compiles them in the
chosen serve mode and serves ``--requests`` random prompts through
``ServingEngine``.  Runs on the card unless ``--device cpu`` is given;
raises when CUDA is absent otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS
from repro_torch.launch.mesh import resolve_device
from repro_torch.launch.train import PRESETS, build_cfg
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--mode", default="int8",
                    choices=("dense", "int8", "cfmm", "sparse_cfmm"))
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.arch, args.preset)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.init(gen, cfg)
    engine = ServingEngine(cfg, params, mode=args.mode,
                           sparsity=args.sparsity, batch_slots=args.slots,
                           max_seq=args.prompt_len + args.max_new + 8,
                           device=dev)
    rng = np.random.RandomState(0)
    reqs = [Request(rid=i,
                    prompt=list(rng.randint(1, cfg.vocab,
                                            size=args.prompt_len)),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    engine.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.tokens_out) for r in reqs)
    for r in reqs[:3]:
        print(f"[serve] req {r.rid}: {len(r.tokens_out)} tokens "
              f"-> {r.tokens_out[:8]}...")
    print(f"[serve] {args.arch}/{args.preset} mode={args.mode} on {dev}: "
          f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"incl. any kernel build at first use)")
    return reqs


if __name__ == "__main__":
    main()
