"""AdamW + schedules on plain tensor trees (ports
``repro/training/optimizer.py``; no ``torch.optim``).

The optimizer state mirrors the parameter tree leaf for leaf.  Every
step follows the JAX package's arithmetic op for op, in f32: the
learning-rate schedule and the bias corrections are computed on the host
as f32 0-d tensors, the clip scale from the global norm summed over the
leaves in JAX's tree order (dict keys sorted), and the update
``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)`` with the decoupled
decay on leaves of two or more dimensions only.

``apply_updates`` updates ``params`` and the state's ``m``/``v`` IN
PLACE, under ``torch.no_grad()``, and returns them (the JAX package
returns new trees; its trainer donates the old buffers, which comes to
the same memory).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor         # 0-d int32, on the host
    m: dict
    v: dict


def init(params_values) -> OptState:
    zeros = nn.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device),
                        params_values)
    return OptState(torch.zeros((), dtype=torch.int32), zeros,
                    nn.tree_map(torch.clone, zeros))


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """The warmup-then-cosine learning rate at ``step``, an f32 0-d
    tensor on the host."""
    step = torch.as_tensor(step, dtype=torch.int32).cpu()
    warm = torch.clamp_max((step + 1) / cfg.warmup_steps, 1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled to at most ``max_norm`` in global L2, the norm);
    the leaves' f32 sums of squares added in JAX's tree order."""
    leaves = [g for _, g in nn.tree_flatten_with_path(grads)]
    total = 0
    for g in leaves:
        total = total + torch.sum(torch.square(g.float()))
    gn = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    return nn.tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig):
    """AdamW step.  params/grads: raw tensor trees (same structure).
    Returns (params, OptState, {"grad_norm", "lr"}); params, m and v are
    the same tensors, updated in place."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = lr_at(state.step, cfg)
    c1, c2 = 1 - b1 ** step, 1 - b2 ** step       # f32 bias corrections

    def upd(p, g, m, v):
        dev = p.device
        g = g.float()
        m.mul_(b1).add_(g * (1 - b1))             # b1 m + (1 - b1) g
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        mhat = m / c1.to(dev)
        vhat = v / c2.to(dev)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr.to(dev) * delta).to(p.dtype))

    for (_, p), (_, g), (_, m), (_, v) in zip(
            nn.tree_flatten_with_path(params),
            nn.tree_flatten_with_path(grads),
            nn.tree_flatten_with_path(state.m),
            nn.tree_flatten_with_path(state.v), strict=True):
        upd(p, g, m, v)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
