"""End-to-end training driver with fault tolerance (ports
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --preset full --seq 512 --batch 8 --steps 12
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --preset tiny --steps 20

  * checkpoint/restart: atomic saves every --ckpt-every steps; --resume
    restores the latest valid checkpoint (survives --fail-at-step
    crashes, which exit with code 42);
  * deterministic data: stream position == step, so restarts replay
    nothing and skip nothing;
  * straggler watchdog: per-step wall time vs its EMA; steps slower than
    --straggler-factor x EMA are logged;
  * gradient compression: --grad-compress int8;
  * --qat: INT7 fake-quant training of every dense linear but the tied
    head, so the result compiles into the constant-parameter serving
    form.

Takes the JAX driver's flags plus ``--device`` (default ``cuda``; raises
when CUDA is absent unless ``--device cpu``).  The process index and
count are 0 and 1 unless ``torch.distributed`` is initialised.  Weights
are seeded random (``torch.Generator`` seed 0), so they differ from the
JAX driver's.  ``main`` returns the last step's metrics as floats.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import nn
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import MLAConfig, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticDataset
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import lm
from repro_torch.training import optimizer
from repro_torch.training.train_step import make_train_step

PRESETS = {
    # (layers, d_model, heads, kv, head_dim, d_ff, vocab, seq, batch)
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=256, vocab=512),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab=8192),
    "full": {},
}


def build_cfg(arch: str, preset: str):
    cfg = get_config(arch)
    over = dict(PRESETS[preset])
    if preset != "full" and cfg.moe is not None:
        over["moe"] = dataclasses.replace(cfg.moe, n_experts=8,
                                          top_k=min(cfg.moe.top_k, 2),
                                          d_ff_expert=over["d_ff"] // 4)
    if preset != "full" and cfg.ssm is not None:
        if cfg.ssm.kind == "mamba":
            over["ssm"] = dataclasses.replace(cfg.ssm,
                                              d_inner=2 * over["d_model"],
                                              d_state=8, dt_rank=16)
        else:
            over["ssm"] = dataclasses.replace(cfg.ssm, head_dim=32)
    if preset != "full" and cfg.mla is not None:
        over["mla"] = MLAConfig(kv_lora=64, qk_nope=32, qk_rope=16, v_dim=32)
        over["head_dim"] = 48
    if preset != "full" and cfg.encoder_decoder:
        over["n_enc_layers"] = 2
        over["dec_len"] = 32
    return dataclasses.replace(cfg, **over) if over else cfg


def process_index_count() -> tuple:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv=None, on_step=None):
    """Train; returns the last step's metrics.  ``on_step(step, metrics,
    seconds)``, when given, is called after every step with the metrics
    as floats (for callers that keep the whole history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="crash deliberately (fault-tolerance demo)")
    ap.add_argument("--grad-compress", default="none",
                    choices=("none", "int8"))
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--qat", action="store_true",
                    help="INT7 fake-quant QAT (train a compilable model)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the first card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.arch, args.preset)
    opt_cfg = optimizer.OptConfig(lr=args.lr, warmup_steps=20,
                                  total_steps=args.steps)
    data = SyntheticDataset(DataConfig(cfg.vocab, args.seq, args.batch),
                            *process_index_count())

    gen = torch.Generator(device=dev).manual_seed(0)
    params = nn.unbox(lm.init(gen, cfg))
    opt_state = optimizer.init(params)
    start_step = 0
    if (args.resume and args.ckpt_dir
            and ckpt.latest_step(args.ckpt_dir) is not None):
        (params, opt_state), start_step = ckpt.restore(
            args.ckpt_dir, (params, opt_state))
        print(f"[train] resumed from step {start_step}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, qat=args.qat,
                              grad_compress=args.grad_compress)

    ema = None
    metrics = {}
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            print(f"[train] injected failure at step {step}", flush=True)
            sys.exit(42)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if step > 2 and dt > args.straggler_factor * ema:
            print(f"[watchdog] step {step} straggled: {dt:.2f}s vs "
                  f"EMA {ema:.2f}s", flush=True)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss={metrics['loss']:.4f} "
                  f"ce={metrics['ce']:.4f} gnorm={metrics['grad_norm']:.2f} "
                  f"lr={metrics['lr']:.2e} {dt:.2f}s", flush=True)
        if on_step is not None:
            on_step(step, metrics, dt)
        if (args.ckpt_dir and args.ckpt_every > 0
                and (step + 1) % args.ckpt_every == 0):
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state))
            print(f"[ckpt] saved step {step + 1}", flush=True)
    if data.cfg.source == "markov" and metrics:
        print(f"[train] final ce={metrics['ce']:.4f} "
              f"(entropy floor {data.entropy_floor:.4f})", flush=True)
    return metrics


if __name__ == "__main__":
    main()
