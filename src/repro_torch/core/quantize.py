"""INT7 per-output-channel weight / INT8 activation quantization, and the
straight-through INT7 fake-quant that QAT trains through (ports
``repro/core/quantize.py``).

Weights: symmetric per-output-channel INT7 (|q| <= 63, the range of the
paper's six ternary residual terms), stored in int8.  Activations: INT8,
"saturated and rounded to 8 bits" in the Collector (paper SS II-D.4),
with one tensor-wide scale or one scale per leading-axis row.

Rounding matches the JAX package as it runs eagerly (``compile_params``):
``amax / qmax`` is a true division, on the card too (PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, so ``qmax``
rides a device tensor).  ``torch.round`` rounds half to even, like
``jnp.round``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT7_MAX = 63          # 2**6 - 1: six ternary residual terms
INT8_ACT_MAX = 127     # activations saturate/round to 8 bits


@dataclasses.dataclass
class QTensor:
    """Quantized tensor: int8 codes + f32 scale broadcastable over them."""

    values: torch.Tensor   # int8
    scale: torch.Tensor    # f32
    axis: int = -1

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.values.to(dtype) * self.scale.to(dtype)


def _channel_scale(w: torch.Tensor, axis: int, qmax: int) -> torch.Tensor:
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
    amax = torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True)
    return torch.clamp_min(amax, 1e-12) / torch.full_like(amax, qmax)


def quantize_int7(w: torch.Tensor, axis: int = -1) -> QTensor:
    """Symmetric per-output-channel INT7 weight quantization."""
    scale = _channel_scale(w, axis, INT7_MAX)
    q = torch.clamp(torch.round(w / scale), -INT7_MAX, INT7_MAX)
    return QTensor(q.to(torch.int8), scale.to(torch.float32), axis)


def quantize_act_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                      per_row: bool = False) -> QTensor:
    """INT8 activation quantization (dynamic if no scale given).

    ``per_row=False``: one tensor-wide scale.  ``per_row=True``: one scale
    per leading-axis row, reduced over every other axis with keepdim so
    ``scale`` broadcasts against ``values``.
    """
    if scale is None:
        if per_row:
            amax = torch.amax(torch.abs(x), dim=tuple(range(1, x.ndim)),
                              keepdim=True)
        else:
            amax = torch.amax(torch.abs(x))
        amax = torch.clamp_min(amax, 1e-12)
        scale = amax / torch.full_like(amax, INT8_ACT_MAX)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -INT8_ACT_MAX, INT8_ACT_MAX)
    return QTensor(q.to(torch.int8), scale, 0 if per_row else -1)


class _SteRound(torch.autograd.Function):
    """``round`` (half to even, as ``jnp.round``) with the identity as its
    gradient: the straight-through estimator of ``_ste_round``."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant_int7(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """QAT fake-quant: INT7 forward numerics, straight-through gradient.
    ``clip(round(w / scale), -63, 63) * scale`` with the per-channel scale
    of ``quantize_int7`` (a true division, as the JAX package's); the
    gradient passes the round as the identity, and flows through the
    scale and the clip as JAX's autodiff takes them."""
    scale = _channel_scale(w, axis, INT7_MAX)
    lim = torch.tensor(float(INT7_MAX), dtype=w.dtype, device=w.device)
    # jnp.clip is maximum then minimum, whose gradients split a tie in
    # half: torch.maximum/minimum do the same, torch.clamp does not
    q = torch.minimum(torch.maximum(_SteRound.apply(w / scale), -lim), lim)
    return q * scale


def ternary_residual_decompose(q: torch.Tensor, terms: int = 6) -> torch.Tensor:
    """Decompose INT7 codes into ``terms`` ternary power-of-two residuals.

    Returns t with shape q.shape + (terms,) and t_i in {-1, 0, +1} such that
    sum_i t_i * 2^i == q exactly.  This is the TRN form the paper's source
    model used ("6 residual terms (equivalent to INT7)").
    """
    sign = torch.sign(q).to(torch.int32)
    mag = torch.abs(q).to(torch.int32)
    bits = [(mag >> i) & 1 for i in range(terms)]
    return torch.stack([b * sign for b in bits], dim=-1).to(torch.int8)


def ternary_residual_reconstruct(t: torch.Tensor) -> torch.Tensor:
    weights = torch.tensor([1 << i for i in range(t.shape[-1])],
                           dtype=torch.int32, device=t.device)
    return torch.sum(t.to(torch.int32) * weights, dim=-1, dtype=torch.int32)


def quantization_error(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Relative L2 error of INT7 round-trip (paper: 0.22% accuracy loss)."""
    qt = quantize_int7(w, axis)
    err = torch.linalg.norm(w - qt.dequantize())
    return err / torch.clamp_min(torch.linalg.norm(w), 1e-12)
