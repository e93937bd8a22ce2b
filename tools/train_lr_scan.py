#!/usr/bin/env python3
"""Learning-rate scan of the port's trainer on one card.

    python3 tools/train_lr_scan.py [--arch smollm_360m] [--steps 12]
        [--lrs 5e-4,1e-3,1.5e-3,2e-3,3e-3]

For each learning rate, ``repro_torch.launch.train.main`` with
``chip_smoke.py``'s training arguments (published widths, seq 512, batch
8, the Markov stream, the trainer's 20-step warmup), as its training
phase runs them (``torch.use_deterministic_algorithms`` on); prints each
step's loss and the mean of the first and of the last three.  This is
how chip_smoke.py's ``TRAIN_LR`` was chosen: the rate at which the loss
falls over the 12 steps.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _cuda, flash_attention  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--steps", type=int, default=cs.TRAIN_STEPS)
    ap.add_argument("--lrs", default="5e-4,1e-3,1.5e-3,2e-3,3e-3")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("train_lr_scan: needs a CUDA card")
    print(f"[card] {cs.gpu_identity()}", flush=True)
    _cuda.build_all([flash_attention.KERNEL, flash_attention.BWD_KERNEL])
    torch.use_deterministic_algorithms(True, warn_only=True)
    for lr in args.lrs.split(","):
        losses = []
        argv_run = cs.train_args(args.arch, args.steps, "--log-every",
                                 str(args.steps))
        argv_run[argv_run.index("--lr") + 1] = lr
        train.main(argv_run, on_step=lambda s, m, dt: losses.append(
            m["loss"]))
        print(f"[lr_scan] lr={lr}: losses {['%.4f' % x for x in losses]}; "
              f"first three {np.mean(losses[:3]):.4f}, last three "
              f"{np.mean(losses[-3:]):.4f}", flush=True)


if __name__ == "__main__":
    main()
