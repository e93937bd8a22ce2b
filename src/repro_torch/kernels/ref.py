"""Plain PyTorch versions of the ported kernels (ports the oracles of
``repro/kernels/ref.py``).

These are what a kernel wrapper runs for a CPU tensor, and what the CUDA
kernels are held against on the card.  Integer paths are exact: int8
products are summed in float64, which holds every int32 accumulator these
shapes can reach (|acc| <= 127 * 127 * K, far below 2**53) without
rounding, on the CPU and on the card alike.

The Collector's ``acc * scale + bias`` is rounded ONCE to f32
(``fma_f32``): the JAX package's jitted lowering contracts it into one
fused multiply-add, and the CUDA kernels use ``fmaf``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.bitmap import expand_bitmap_tile


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 operands, rounded once to f32.

    The product of two f32 values is exact in f64; the f64 sum is then
    rounded to f32.  That second rounding is the correct single rounding
    unless the f64 sum lands exactly halfway between two f32 neighbours
    while the f64 addition itself rounded (TwoSum error ``e != 0``): the
    true sum then lies on ``e``'s side of the midpoint, and the tie is
    broken that way.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & ((r.double() + nb.double()) * 0.5 == s)
    fix = tie & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(fix, nb, r)


def int8_matmul_ref(x_q: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> int32 (exact)."""
    return (x_q.double() @ codes.double()).to(torch.int32)


def cfmm_matmul_ref(x_q: torch.Tensor, codes: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> f32: the exact int32 product times
    the per-column ``scale``, rounded once."""
    return int8_matmul_ref(x_q, codes).float() * scale


def sparse_matvec_ref(x_q: torch.Tensor, bitmap: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8 @ bitmap-packed codes -> int32 (M, N) (exact)."""
    base = torch.zeros((1, bitmap.shape[1]), dtype=torch.int32,
                       device=bitmap.device)
    dense, _ = expand_bitmap_tile(bitmap, values, base, values.shape[0])
    return int8_matmul_ref(x_q, dense)


# ---------------------------------------------------------------------------
# Block-sparse constant-weight matmul
# ---------------------------------------------------------------------------

def block_sparse_matmul_plain(x: torch.Tensor, w_blocks: torch.Tensor,
                              meta: torch.Tensor, offsets: torch.Tensor,
                              block_kn, n_blocks_n: int) -> torch.Tensor:
    """The block-sparse kernel's function on its own operands, on any
    device: per output block column, the f32 sum of ``x``'s k-block times
    each active weight block, in ascending k, cast once to ``x.dtype``.
    Block columns without an active block are exact zeros.

    x (M, K); w_blocks (n_active, bk, bn) in plan order (column-major:
    the blocks of column nb are ``offsets[nb]:offsets[nb + 1]``, ascending
    k); meta (4, n_active) int32 from ``plan_blocks`` (row 0: k-block);
    offsets (n_blocks_n + 1,) int32.  Reads no index on the host, so it
    runs inside a CUDA graph."""
    M, K = x.shape
    bk, bn = block_kn
    n_active = w_blocks.shape[0]
    acc = torch.zeros((n_blocks_n, M, bn), dtype=torch.float32,
                      device=x.device)
    if n_active:
        xs = x.reshape(M, K // bk, bk)[:, meta[0].long()].float()
        prods = torch.einsum("mib,ibn->imn", xs, w_blocks.float())
        start, end = offsets[:-1].long(), offsets[1:].long()
        for j in range(K // bk):      # the j-th active block of each column
            idx = start + j
            term = prods[idx.clamp_max(n_active - 1)]
            acc = acc + torch.where((idx < end)[:, None, None], term, 0.0)
    return acc.permute(1, 0, 2).reshape(M, n_blocks_n * bn).to(x.dtype)


def block_sparse_matmul_ref(x: torch.Tensor, w_blocks: torch.Tensor,
                            block_kn, mask) -> torch.Tensor:
    """x (M, K) @ block-sparse W -> (M, N): the JAX package's oracle.

    w_blocks: (n_active, bk, bn) dense storage of active blocks;
    mask: (K//bk, N//bn) bool numpy, ROW-major ordering of active blocks.
    ``plan_blocks`` and ``ops.block_sparse_matmul`` order blocks
    column-major, so the kernel's operands must not be fed to this.
    """
    bk, bn = block_kn
    Kb, Nb = mask.shape
    w = torch.zeros((Kb * bk, Nb * bn), dtype=w_blocks.dtype,
                    device=w_blocks.device)
    idx = 0
    for kb in range(Kb):
        for nb in range(Nb):
            if mask[kb, nb]:
                w[kb * bk:(kb + 1) * bk, nb * bn:(nb + 1) * bn] = w_blocks[idx]
                idx += 1
    if idx != w_blocks.shape[0]:
        raise ValueError(f"mask has {idx} active blocks, w_blocks "
                         f"{w_blocks.shape[0]}")
    if x.dtype == torch.int8:
        return int8_matmul_ref(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# Convolution
# ---------------------------------------------------------------------------

def to_spatial_major(codes: torch.Tensor, k: int, c_in: int) -> torch.Tensor:
    """Channel-major patch codes (c_in*k*k, n) -> spatial-major tap order
    (k*k*c_in, n), row = tap*c_in + c — the layout the conv kernels
    consume; ``compile_params`` runs it once per dense conv leaf."""
    n = codes.shape[-1]
    return codes.reshape(c_in, k, k, n).permute(1, 2, 0, 3).reshape(
        k * k * c_in, n)


def from_spatial_major(codes_sp: torch.Tensor, k: int,
                       c_in: int) -> torch.Tensor:
    """Inverse of ``to_spatial_major``."""
    n = codes_sp.shape[-1]
    return codes_sp.reshape(k, k, c_in, n).permute(2, 0, 1, 3).reshape(
        k * k * c_in, n)


def same_pads(size: int, k: int, stride: int):
    """SAME-padding (lo, hi) and output size along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2, out


def pad_same_nhwc(x: torch.Tensor, k: int, stride: int, value=0):
    """Pad (N,H,W,C) for SAME conv -> (padded, h_out, w_out).

    Zero padding is exact for symmetric int8 codes (zero point is 0); the
    max-pool pads with ``value=-inf``."""
    _, H, W, _ = x.shape
    lo_h, hi_h, h_out = same_pads(H, k, stride)
    lo_w, hi_w, w_out = same_pads(W, k, stride)
    if lo_h or hi_h or lo_w or hi_w:
        x = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h), value=value)
    return x, h_out, w_out


def _shift_slice(xp: torch.Tensor, dy: int, dx: int, h_out: int,
                 w_out: int, stride: int) -> torch.Tensor:
    """The (dy, dx) tap of the receptive field, strided to output
    positions."""
    return xp[:, dy:dy + (h_out - 1) * stride + 1:stride,
              dx:dx + (w_out - 1) * stride + 1:stride, :]


def _conv_taps_spatial(xp: torch.Tensor, w_sp: torch.Tensor, k: int,
                       stride: int, h_out: int, w_out: int) -> torch.Tensor:
    """Tap-loop int8 conv on a padded image with spatial-major weights.

    xp: (N, Hp, Wp, C) int8; w_sp: (k, k, C, n_out) int8 -> int32 NHWC.
    """
    N, C, n_out = xp.shape[0], xp.shape[3], w_sp.shape[-1]
    acc = torch.zeros((N * h_out * w_out, n_out), dtype=torch.float64,
                      device=xp.device)
    for dy in range(k):
        for dx in range(k):
            sl = _shift_slice(xp, dy, dx, h_out, w_out, stride)
            acc += sl.reshape(-1, C).double() @ w_sp[dy, dx].double()
    return acc.to(torch.int32).reshape(N, h_out, w_out, n_out)


def conv2d_int8_ref(x_q: torch.Tensor, w_sp: torch.Tensor, k: int,
                    stride: int) -> torch.Tensor:
    """int8 NHWC SAME conv -> int32 (exact): shift-slice matmuls.

    w_sp: (k*k*c_in, c_out) int8 in the compiled spatial-major tap order
    (row = tap*c_in + c)."""
    C, n_out = x_q.shape[3], w_sp.shape[1]
    xp, h_out, w_out = pad_same_nhwc(x_q, k, stride)
    return _conv_taps_spatial(xp, w_sp.reshape(k, k, C, n_out), k, stride,
                              h_out, w_out)


def conv2d_sparse_int8_ref(x_q: torch.Tensor, bitmap: torch.Tensor,
                           values: torch.Tensor, k: int,
                           stride: int) -> torch.Tensor:
    """Bitmap-native int8 conv -> int32 (exact).  bitmap/values: the
    packed spatial-major conv layout, K padded to %8 with zero-masked
    tail rows."""
    C = x_q.shape[3]
    n_out = bitmap.shape[1]
    base = torch.zeros((1, n_out), dtype=torch.int32, device=bitmap.device)
    dense, _ = expand_bitmap_tile(bitmap, values, base, values.shape[0])
    w_sp = dense[:C * k * k].reshape(k, k, C, n_out)
    xp, h_out, w_out = pad_same_nhwc(x_q, k, stride)
    return _conv_taps_spatial(xp, w_sp, k, stride, h_out, w_out)


def conv2d_collector_ref(x_q, w_sp, k, stride, eff_scale, eff_bias,
                         shortcut=None, relu: bool = True) -> torch.Tensor:
    """Fused conv + Collector: dequant/BN scale, bias, shortcut, ReLU.

    eff_scale and eff_bias broadcast against the NHWC accumulator —
    ``(c_out,)`` for a per-tensor domain, ``(N, 1, 1, c_out)`` per row;
    ``shortcut`` as in ``_collector``."""
    acc = conv2d_int8_ref(x_q, w_sp, k, stride)
    return _collector(acc, eff_scale, eff_bias, shortcut, relu)


def conv2d_sparse_collector_ref(x_q, bitmap, values, k, stride, eff_scale,
                                eff_bias, shortcut=None,
                                relu: bool = True) -> torch.Tensor:
    """Fused bitmap-native conv + Collector (packed weights in)."""
    acc = conv2d_sparse_int8_ref(x_q, bitmap, values, k, stride)
    return _collector(acc, eff_scale, eff_bias, shortcut, relu)


def _dw_taps(xp: torch.Tensor, w_tap: torch.Tensor, k: int, stride: int,
             h_out: int, w_out: int) -> torch.Tensor:
    """Tap-loop depthwise int8 conv on a padded image -> int32 NHWC.

    xp: (N, Hp, Wp, C) int8; w_tap: (k*k, C) int8 tap-major — each tap
    adds an elementwise (per-channel) product, in int32 (exact: at most
    k*k*127*127 in magnitude)."""
    C = w_tap.shape[-1]
    acc = torch.zeros((xp.shape[0], h_out, w_out, C), dtype=torch.int32,
                      device=xp.device)
    for dy in range(k):
        for dx in range(k):
            sl = _shift_slice(xp, dy, dx, h_out, w_out, stride)
            acc += sl.to(torch.int32) * w_tap[dy * k + dx].to(torch.int32)
    return acc


def conv2d_dw_int8_ref(x_q: torch.Tensor, w_tap: torch.Tensor, k: int,
                       stride: int) -> torch.Tensor:
    """Depthwise int8 NHWC SAME conv -> int32 (exact)."""
    assert x_q.shape[-1] == w_tap.shape[-1], (x_q.shape, w_tap.shape)
    xp, h_out, w_out = pad_same_nhwc(x_q, k, stride)
    return _dw_taps(xp, w_tap, k, stride, h_out, w_out)


def conv2d_dw_collector_ref(x_q, w_tap, k, stride, eff_scale, eff_bias,
                            shortcut=None, relu: bool = True) -> torch.Tensor:
    """Fused depthwise conv + Collector: the dense conv's epilogue
    (``_collector``), so the two conv families round alike."""
    acc = conv2d_dw_int8_ref(x_q, w_tap, k, stride)
    return _collector(acc, eff_scale, eff_bias, shortcut, relu)


def _collector(acc: torch.Tensor, eff_scale: torch.Tensor,
               eff_bias: torch.Tensor, shortcut, relu: bool) -> torch.Tensor:
    """``shortcut`` is an f32 map (added), or an int8 ``(q, scale[row])``
    pair — the identity block's dequantized input — fused as
    ``fma(q, scale, y)``, the rounding of XLA's fused lowering of
    ``y + q * scale``."""
    y = fma_f32(acc.float(), eff_scale, eff_bias)
    if isinstance(shortcut, (tuple, list)):
        q, s = shortcut
        y = fma_f32(q.float(), s.float().reshape(-1, 1, 1, 1), y)
    elif shortcut is not None:
        y = y + shortcut.float()
    return torch.clamp_min(y, 0.0) if relu else y


def zero_counts_ref(y: torch.Tensor, group_size: int) -> dict:
    """Exact activation zero counts of a conv output (the sparsity-
    profiling oracle; reads ``y``, changes nothing).

    y (N, H, W, C) f32 post-Collector output; channels split into
    C/group_size ``coarse_in`` groups (group i = channels
    [i*g, (i+1)*g)).  Returns the profiler's dict (the JAX package's
    ``obs/sparsity.AUX_KEYS``), all f32: per-image zero counts, per-group
    zero counts, per-group all-zero (image, pixel) cell counts, and the
    elements-per-image and cell totals the fractions divide by."""
    N, H, W, C = y.shape
    if C % group_size:
        raise ValueError(f"{C} channels do not split into groups of "
                         f"{group_size}")
    zm = y == 0.0
    z5 = zm.reshape(N, H, W, C // group_size, group_size)
    f32 = dict(dtype=torch.float32, device=y.device)
    return {
        "row_zeros": zm.sum(dim=(1, 2, 3)).float(),
        "group_zeros": z5.sum(dim=(0, 1, 2, 4)).float(),
        "group_allzero": z5.all(dim=4).sum(dim=(0, 1, 2)).float(),
        "elems_per_row": torch.full((), H * W * C, **f32),
        "cells": torch.full((), N * H * W, **f32),
    }


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None) -> torch.Tensor:
    """Naive softmax attention oracle for the flash paths.

    q, k, v: (B, H, T, D) (k/v may have fewer heads: GQA is the caller's).
    Queries sit at the end of the key sequence (offset Tk - Tq).
    """
    T, S = q.shape[-2], k.shape[-2]
    scores = torch.einsum("bhtd,bhsd->bhts", q, k) / (q.shape[-1] ** 0.5)
    pos_q = torch.arange(T, device=q.device)[:, None] + (S - T)
    pos_k = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos_k <= pos_q
    if window is not None:
        mask &= pos_k > pos_q - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v)
