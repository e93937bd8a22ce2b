"""Gradient compression with error feedback (ports
``repro/training/grad_compression.py``).

int8 symmetric quantization per leaf: an all-reduce of the codes moves
4x fewer bytes than bf16 gradients (8x fewer than f32).
``compress_decompress`` is the quantize-dequantize form the training step
applies; ``compress_with_feedback`` carries each leaf's quantization
residual in a persistent f32 buffer.  Leaves of fewer than two
dimensions pass unchanged.  ``amax / qmax`` is a true division (a device
tensor divisor: CUDA divides by a Python scalar through its
reciprocal), as the JAX package computes it eagerly.
"""
from __future__ import annotations

import torch

from repro_torch import nn


def _q(g: torch.Tensor, bits: int = 8):
    qmax = 2.0 ** (bits - 1) - 1
    amax = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12)
    scale = amax / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(g / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def compress_decompress(grads, method: str = "int8"):
    """QDQ each gradient leaf (int8 symmetric per-tensor)."""
    if method == "none":
        return grads

    def qdq(g):
        if g.ndim < 2:
            return g
        q, s = _q(g.float())
        return (q.float() * s).to(g.dtype)

    return nn.tree_map(qdq, grads)


def init_error_feedback(grads_shape):
    """f32 zeros shaped like each leaf (tensors or anything with
    ``shape``; on the leaf's device where it has one)."""
    return nn.tree_map(
        lambda s: torch.zeros(tuple(s.shape), dtype=torch.float32,
                              device=getattr(s, "device", "cpu")),
        grads_shape)


def compress_with_feedback(grads, errors):
    """Error-feedback compression: g' = Q(g + e); e' = (g + e) - g'."""
    def one(g, e):
        if g.ndim < 2:
            return g, e
        tot = g.float() + e
        q, s = _q(tot)
        deq = q.float() * s
        return deq.to(g.dtype), tot - deq

    comp, errs = zip(*(one(g, e) for g, e in zip(
        nn.tree_leaves(grads), nn.tree_leaves(errors), strict=True)))
    it_c, it_e = iter(comp), iter(errs)
    return (nn.tree_map(lambda _: next(it_c), grads),
            nn.tree_map(lambda _: next(it_e), grads))
