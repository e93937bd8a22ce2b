"""Dense implicit-GEMM int8 SAME conv + fused Collector — CUDA kernel
wrapper (ports ``repro/kernels/conv_implicit.py``), and the plan that
both conv kernels launch by.

Replaces ``conv2d_implicit_pallas`` (repro/kernels/conv_implicit.py:144,
with ``conv_tap_macs`` :44 and ``collector_epilogue`` :73).  The kernel is
``csrc/conv_implicit.cu`` over the template in ``csrc/conv_mma.cuh``: the
conv as one GEMM of every output pixel of every image (M) by the output
channels (N) over K = k*k*C, in 64 x 64 tiles that may cross images; the
implicit im2col tile of the unpadded NHWC input and the weight rows come
into a ring of shared-memory stages by ``cp.async`` (the SAME padding is
its zero fill) several K chunks ahead of the MACs, which run on the int8
tensor cores (``mma.sync.m16n8k32``) into int32; then the Collector
``y = fmaf(float(acc), eff_scale[image], eff_bias)`` (+ shortcut) (ReLU)
with a per-image ``max|y|`` for the int8 requantization pass.  Where the
output tiles alone would not fill the card, ``plan`` splits K over the
grid: a tile's splits form one thread-block cluster, which adds their
int32 partial sums (exact in any order) in distributed shared memory
and runs the Collector.  Unlike the TPU kernel it writes ``y`` in plain
NHWC (no strip blocking).

With ``profile_g`` (the coarse_in group size of the sparsity profiler)
the call also returns the dict of ``ref.zero_counts_ref`` — the TPU
kernel's ``profile_g`` output (conv_implicit.py:85-138 of the JAX
package): counted in the kernel's epilogue, under a compile-time flag,
where g is a power of two dividing the 64-channel tile and n_out
(``counts_in_kernel``); otherwise recounted by ``ref.zero_counts_ref``
on ``y``, as the JAX package's ``ops.conv2d`` does when its channel
tiles misalign the groups (``profile_fast`` false).  ``y`` is the same
either way.

What bounds it on an H100: the larger of its int8 operations over the
1,979 TOP/s tensor-core peak and its bytes (int8 input and weights, f32
output and shortcut, each moved once) over 3.35 TB/s — bytes at every
served shape; ``chip_smoke.py`` computes both per main-path shape and
PERF.md keeps the kernel's times beside them.

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import (I, P, CudaKernel, PLAIN_DEVICES,
                                       check_cuda, ptr)

KERNEL = CudaKernel("conv_implicit", "conv_implicit_launch",
                    (P,) * 12 + (I,) * 18 + (P,))
SMS = 132            # streaming multiprocessors of an H100 SXM
BLOCK_M = 64         # output pixels per tile (rows may span images)
BLOCK_N = 64         # output channels per tile
K_CHUNK = 64         # K rows per ring stage (the ring's depth is the
                     # kernel's own)
MAX_SPLITS = 16      # a tile's splits form one thread-block cluster
MIN_CHUNKS = 3       # fewest chunks per split for a second wave (sparse)


class ConvPlan(NamedTuple):
    """How one conv launches.  ``vec``: bytes per input copy (16, 4 or
    1; C is a multiple); ``bvec``: bytes per weight or bitmap copy along
    the output channels (n_out is a multiple); the grid is ``m_tiles`` x
    ``n_tiles`` x ``splits``, split ``s`` walking K chunks
    ``[s * chunks_per, (s + 1) * chunks_per)``."""
    vec: int
    bvec: int
    m_tiles: int
    n_tiles: int
    splits: int
    chunks_per: int


def _align(n: int) -> int:
    return 16 if n % 16 == 0 else (4 if n % 4 == 0 else 1)


def plan(N: int, h_out: int, w_out: int, C: int, k: int, n_out: int,
         sparse: bool = False) -> ConvPlan:
    """The launch of one conv from its shape: 64 x 64 output tiles over
    the N * h_out * w_out pixels of the batch; K = k*k*C (sparse: padded
    to the bitmap's multiple of 8) in chunks of 64 rows, split over the
    grid where the tiles alone fill less than a wave of the SMs: dense,
    as many splits as one block per SM needs; sparse, whose chunks each
    wait on their code gathers, as many as two blocks per SM need while
    each split keeps ``MIN_CHUNKS`` chunks, else one block per SM.  The
    chunks are spread evenly over at most ``MAX_SPLITS`` splits (one
    cluster); no split is empty."""
    m_tiles = -(-N * h_out * w_out // BLOCK_M)
    n_tiles = -(-n_out // BLOCK_N)
    k_rows = -(-k * k * C // 8) * 8 if sparse else k * k * C
    n_chunks = -(-k_rows // K_CHUNK)
    tiles = m_tiles * n_tiles
    for waves in ((2, 1) if sparse else (1,)):
        want = min(MAX_SPLITS, -(-waves * SMS // tiles))
        per = max(1, n_chunks // want)
        if per >= MIN_CHUNKS:
            break
    splits = min(MAX_SPLITS, -(-n_chunks // per))
    per = -(-n_chunks // splits)                # even: the same splits
    return ConvPlan(_align(C), _align(n_out), m_tiles, n_tiles,
                    -(-n_chunks // per), per)


def counts_in_kernel(n_out: int, g: int) -> bool:
    """Whether the conv kernels count ``profile_g`` zeros in their
    epilogue: g a power of two that divides the 64-channel tile (so a
    group never spans two tiles) and n_out (so no group is ragged)."""
    return 1 <= g <= BLOCK_N and g & (g - 1) == 0 and n_out % g == 0


def zero_count_dict(zg: torch.Tensor, za: torch.Tensor, h_out: int,
                    w_out: int, C: int) -> dict:
    """A kernel's per-(image, group) counts ``zg``, ``za`` (N, C/g) as
    ``ref.zero_counts_ref``'s dict (shared by the conv kernels and the
    depthwise kernel)."""
    N = zg.shape[0]
    f32 = dict(dtype=torch.float32, device=zg.device)
    return {"row_zeros": zg.sum(1).float(),
            "group_zeros": zg.sum(0).float(),
            "group_allzero": za.sum(0).float(),
            "elems_per_row": torch.full((), h_out * w_out * C, **f32),
            "cells": torch.full((), N * h_out * w_out, **f32)}


def conv_geometry(x_q: torch.Tensor, k: int, stride: int) -> tuple:
    """(pad_top, pad_left, h_out, w_out) of a SAME conv on NHWC ``x_q``."""
    _, H, W, _ = x_q.shape
    lo_h, _, h_out = ref.same_pads(H, k, stride)
    lo_w, _, w_out = ref.same_pads(W, k, stride)
    return lo_h, lo_w, h_out, w_out


def plain_collector(acc, eff_scale, eff_bias, shortcut, relu, return_acc,
                    profile_g=None):
    """The plain Collector shared by the conv wrappers: ``(y, amax)``
    with per-image ``amax = max|y|`` (``+ (acc,)`` on request, then
    ``ref.zero_counts_ref``'s dict with ``profile_g``)."""
    N, n_out = eff_scale.shape
    y = ref._collector(acc, eff_scale.reshape(N, 1, 1, n_out), eff_bias,
                       shortcut, relu)
    amax = torch.amax(torch.abs(y), dim=(1, 2, 3))
    out = (y, amax, acc) if return_acc else (y, amax)
    if profile_g is not None:
        out = out + (ref.zero_counts_ref(y, profile_g),)
    return out


def conv_outputs(x_q, eff_scale, eff_bias, shortcut, k, stride, n_out,
                 return_acc):
    """Check a conv launch's activation-side arguments and allocate its
    outputs.  Returns (pointers of the shortcut operands (f32 map, int8
    codes, their per-image scale), geometry ints for the C entry point,
    y, amax, acc or None)."""
    N, H, W, C = x_q.shape
    pad_top, pad_left, h_out, w_out = conv_geometry(x_q, k, stride)
    out_shape = (N, h_out, w_out, n_out)
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("eff_scale", eff_scale, torch.float32, (N, n_out))
    check_cuda("eff_bias", eff_bias, torch.float32, (n_out,))
    sc = (None, None, None)
    if isinstance(shortcut, (tuple, list)):
        q, s = shortcut
        check_cuda("shortcut codes", q, torch.int8, out_shape)
        check_cuda("shortcut scale", s, torch.float32, (N,))
        sc = (None, q, s)
    elif shortcut is not None:
        check_cuda("shortcut", shortcut, torch.float32, out_shape)
        sc = (shortcut, None, None)
    dev = x_q.device
    y = torch.empty(out_shape, dtype=torch.float32, device=dev)
    amax = torch.zeros((N,), dtype=torch.float32, device=dev)
    acc = (torch.empty(out_shape, dtype=torch.int32, device=dev)
           if return_acc else None)
    geom = (N, H, W, C, n_out, k, stride, pad_top, pad_left, h_out, w_out)
    return tuple(ptr(t) for t in sc), geom, y, amax, acc


def conv_launch(kernel: CudaKernel, x_q, weights: tuple, eff_scale,
                eff_bias, shortcut, *, k: int, stride: int, n_out: int,
                relu: bool, return_acc: bool, cplan: ConvPlan,
                sparse_ints: tuple = (), profile_g: int | None = None):
    """Launch a conv kernel of ``csrc/conv_mma.cuh`` by ``cplan``:
    ``weights`` are the weight-side tensors in the C entry point's order
    (dense ``(w_sp,)``, sparse ``(bitmap, values)``; the first one is
    read ``cplan.bvec`` bytes at a time), ``sparse_ints`` the sparse
    entry point's ``(Kb8, keep_k)``.  A tensor that does not start on the
    copy width is copied first.  With ``profile_g`` the zero counts come
    from the epilogue where ``counts_in_kernel``, else from
    ``ref.zero_counts_ref`` on ``y``."""
    if x_q.data_ptr() % cplan.vec:
        x_q = x_q.clone()
    if weights[0].data_ptr() % cplan.bvec:
        weights = (weights[0].clone(),) + tuple(weights[1:])
    sc, geom, y, amax, acc = conv_outputs(x_q, eff_scale, eff_bias,
                                          shortcut, k, stride, n_out,
                                          return_acc)
    # the epilogue's 8-channel vector loads and stores
    sc_t = shortcut if isinstance(shortcut, (tuple, list)) else (shortcut,)
    vec_epi = n_out % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (eff_scale, eff_bias, *sc_t)
        if t is not None)
    in_kernel = profile_g is not None and counts_in_kernel(n_out, profile_g)
    zg = za = None
    if in_kernel:               # one zeroing launch for both counts
        zg, za = torch.zeros((2, x_q.shape[0], n_out // profile_g),
                             dtype=torch.int32, device=x_q.device)
    kernel.launch(ptr(x_q), *map(ptr, weights), ptr(eff_scale),
                  ptr(eff_bias), *sc, ptr(y), ptr(amax), ptr(acc), ptr(zg),
                  ptr(za), *geom, *sparse_ints, int(relu), cplan.vec,
                  cplan.bvec, int(vec_epi), cplan.splits, cplan.chunks_per,
                  profile_g if in_kernel else 0)
    out = (y, amax, acc) if return_acc else (y, amax)
    if profile_g is not None:
        *_, h_out, w_out = geom
        out = out + (zero_count_dict(zg, za, h_out, w_out, n_out)
                     if in_kernel else ref.zero_counts_ref(y, profile_g),)
    return out


def conv2d_implicit_plain(x_q, w_sp, eff_scale, eff_bias, shortcut=None, *,
                          k: int, stride: int, relu: bool = True,
                          return_acc: bool = False,
                          profile_g: int | None = None):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_int8_ref(x_q, w_sp, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc, profile_g)


def conv2d_implicit(x_q: torch.Tensor, w_sp: torch.Tensor,
                    eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                    shortcut: torch.Tensor | None = None, *, k: int,
                    stride: int, relu: bool = True,
                    return_acc: bool = False, profile_g: int | None = None):
    """Fused implicit-GEMM SAME conv + Collector.

    x_q:       (N, H, W, C) int8 NHWC, unpadded
    w_sp:      (k*k*C, n_out) int8, spatial-major taps (row = tap*C + c)
    eff_scale: (N, n_out) f32, one dequant * BN row per image
    eff_bias:  (n_out,) f32
    shortcut:  optional (N, h_out, w_out, n_out) f32 map, or an int8
               ``(codes, scale (N,))`` pair added as ``fmaf(q, scale, y)``
    profile_g: optional coarse_in group size (n_out a multiple): also
               return the zero counts of ``y``, ``ref.zero_counts_ref``'s
               dict — from the kernel's epilogue where
               ``counts_in_kernel``, else recounted on ``y``
    Returns (y (N, h_out, w_out, n_out) f32, amax (N,) f32 per-image
    max|y|), then the int32 accumulators with ``return_acc``, then the
    dict with ``profile_g``.
    """
    if x_q.device.type in PLAIN_DEVICES:
        return conv2d_implicit_plain(x_q, w_sp, eff_scale, eff_bias,
                                     shortcut, k=k, stride=stride,
                                     relu=relu, return_acc=return_acc,
                                     profile_g=profile_g)
    N, _, _, C = x_q.shape
    n_out = w_sp.shape[1]
    check_cuda("w_sp", w_sp, torch.int8, (k * k * C, n_out))
    _, _, h_out, w_out = conv_geometry(x_q, k, stride)
    return conv_launch(KERNEL, x_q, (w_sp,), eff_scale, eff_bias, shortcut,
                       k=k, stride=stride, n_out=n_out, relu=relu,
                       return_acc=return_acc,
                       cplan=plan(N, h_out, w_out, C, k, n_out),
                       profile_g=profile_g)
