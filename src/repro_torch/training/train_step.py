"""The training and serving step functions (ports
``repro/training/train_step.py``).

``train_step`` is one optimizer step: the loss and its gradient by
autograd through ``lm.forward_train`` (the flash-attention kernel and its
backward kernel on the card, their plain versions on the CPU; each
template layer recomputed in the backward pass under ``cfg.remat``), the
optional gradient compression, then AdamW.  The JAX package jits it; the
port runs it eagerly.
"""
from __future__ import annotations

import functools

import torch

from repro_torch import nn
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.training import optimizer
from repro_torch.training.grad_compression import compress_decompress


def value_and_grad(params, batch, cfg: ArchConfig, qat: bool = False):
    """-> (loss, metrics, grads): the loss of ``lm.forward_train`` +
    ``lm.loss_fn`` and its gradient, a tree like ``params`` (zeros for a
    leaf the loss does not reach)."""
    leaves = nn.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p = nn.tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        logits, aux = lm.forward_train(p, batch, cfg, qat=qat)
        loss, metrics = lm.loss_fn(logits, batch["labels"], aux)
        del logits
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(live, grads))
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, nn.tree_map(lambda _: next(it), params)


def train_step(params, opt_state, batch, *, cfg: ArchConfig,
               opt_cfg: optimizer.OptConfig, qat: bool = False,
               grad_compress: str = "none"):
    """One optimizer step.  params: raw tensor tree, updated in place;
    batch: ``tokens``/``labels`` tensors on the params' device.  Returns
    (params, opt_state, metrics)."""
    loss, metrics, grads = value_and_grad(params, batch, cfg, qat)
    if grad_compress != "none":
        grads = compress_decompress(grads, method=grad_compress)
    new_params, new_opt, opt_metrics = optimizer.apply_updates(
        params, grads, opt_state, opt_cfg)
    metrics = {**metrics, **opt_metrics, "loss": loss}
    return new_params, new_opt, metrics


def make_train_step(cfg: ArchConfig, opt_cfg=None, qat=False,
                    grad_compress="none"):
    opt_cfg = opt_cfg or optimizer.OptConfig()
    return functools.partial(train_step, cfg=cfg, opt_cfg=opt_cfg, qat=qat,
                             grad_compress=grad_compress)


@torch.no_grad()
def prefill_step(params, cache, batch, *, cfg: ArchConfig):
    logits, cache = lm.forward_prefill(params, batch, cfg, cache)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return token, cache


@torch.no_grad()
def serve_step(params, cache, batch, *, cfg: ArchConfig):
    """One decode step: greedy next token + advanced cache."""
    logits, cache = lm.forward_decode(params, batch, cfg, cache)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    return token, cache


def make_serve_step(cfg: ArchConfig, kind="decode"):
    fn = serve_step if kind == "decode" else prefill_step
    return functools.partial(fn, cfg=cfg)
