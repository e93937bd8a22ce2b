"""Depthwise int8 SAME conv + fused Collector — CUDA kernel wrapper and
its plan (ports ``repro/kernels/conv_depthwise.py``).

Replaces ``conv2d_dw_pallas`` (repro/kernels/conv_depthwise.py:80, with
``dw_tap_macs`` :36 and its ``profile_g`` zero counts :58-74, 137-143).
The kernel is ``csrc/conv_depthwise.cu``: a block owns one image, a band
of output rows and a slice of channels (``plan``); it stages the halo'd
input band into shared memory by ``cp.async`` with the SAME padding as
zeros, does the elementwise int8 tap-MACs over the tap-major ``(k*k, C)``
weights into int32 from there, then runs the Collector of
``csrc/conv_common.cuh`` — the dense conv kernels' own arithmetic, so
``y`` rounds exactly as theirs does — and stores ``y`` as 16-byte
vectors.  The per-image ``max|y|`` is one ``atomicMax`` per block into
an ``amax`` the wrapper zeroes.  Unlike the TPU kernel it reads the
unpadded NHWC input, masks the ragged channel edge itself and writes
``y`` in plain NHWC.

What bounds it on an H100: bytes.  It does 2*k*k operations per output
element and moves about 4 bytes of f32 output (plus its int8 input), far
below the 1,979 TOP/s int8 peak's ratio; ``chip_smoke.py`` computes both
bounds at MobileNetV2's shapes and PERF.md keeps the times beside them.

With ``profile_g`` (the coarse_in group size of the sparsity profiler)
the call also returns the dict of ``ref.zero_counts_ref``: counted in the
kernel's epilogue, under a compile-time flag, where the plan's channel
slice is a multiple of g; otherwise recounted by ``ref.zero_counts_ref``
on ``y`` — as the JAX package's ``ops.conv2d_dw`` does when its channel
tiles misalign the groups (``profile_fast`` false).  ``y`` is the same
either way.

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr
from repro_torch.kernels.conv_implicit import (conv_outputs, plain_collector,
                                               zero_count_dict)

KERNEL = CudaKernel("conv_depthwise", "conv_depthwise_launch",
                    (P,) * 12 + (I,) * 18 + (P,))
SMS = 132              # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256      # threads per block (the kernel's launch bound)
MAX_SMEM = 48 * 1024   # dynamic shared memory a block takes without opt-in
MAX_JOBS = 2048        # (pixel, 4 channels) jobs per block: 8 per thread
WIDE_SLICE = 32        # two waves are not bought with slices narrower


class DwPlan(NamedTuple):
    """How one depthwise conv launches.  The grid is N x ``n_bands`` x
    ``n_slices`` blocks; a block computes ``rows`` output rows (fewer in
    the last band) by ``cb`` channels (fewer past C in the last slice)
    with ``threads`` threads, staging its input band in ``smem`` bytes of
    shared memory at ``cw`` words per column, by copies of ``vec`` bytes
    (16, 4 or 1)."""
    cb: int
    rows: int
    cw: int
    vec: int
    threads: int
    n_slices: int
    n_bands: int
    smem: int


def copy_width(C: int) -> int:
    """Bytes per input copy that C allows (a pointer may allow fewer)."""
    return 16 if C % 16 == 0 else (4 if C % 4 == 0 else 1)


def column_words(n_cg: int, stride: int, vec: int) -> int:
    """Words per staged column: the ``n_cg`` channel words plus the pad
    that spreads a warp's reads (``32 / n_cg`` consecutive pixels,
    ``stride`` columns apart) over the most banks, then the fewest words;
    a multiple of 4 where 16-byte copies write it."""
    best = None
    for cw in range(n_cg, n_cg + 16):
        if vec == 16 and cw % 4:
            continue
        banks = Counter((p * stride * cw + c) % 32
                        for p in range(max(1, 32 // n_cg))
                        for c in range(n_cg))
        worst = max(banks.values())
        if best is None or worst < best[0]:
            best = (worst, cw)
    return best[1]


def smem_bytes(rows: int, w_out: int, k: int, stride: int, cw: int,
               cb: int) -> int:
    """Shared memory of a band: its input rows by the padded width by cw
    words, and the slice's k*k weight words."""
    wp = (w_out - 1) * stride + k
    return (((rows - 1) * stride + k) * wp * cw + k * k * (cb // 4)) * 4


def _slices(C: int, vec: int) -> list:
    """Channel slices to try, widest first: powers of two from 64 down,
    whole multiples of the copy width, from the widest that divides C
    (C below 4, or with no power-of-two divisor of 4 or more, starts at
    the power of two that holds it)."""
    low = max(vec, 4)
    cands = [cb for cb in (64, 32, 16, 8, 4) if cb >= low]
    div = [cb for cb in cands if C % cb == 0]
    if div:
        return [cb for cb in cands if cb <= div[0]]
    top = min(64, max(4, 1 << (C - 1).bit_length()))
    return [cb for cb in cands if cb <= top]


def plan(N: int, H: int, W: int, C: int, k: int, stride: int) -> DwPlan:
    """The launch of one depthwise conv from its shape, within
    ``MAX_SMEM`` and ``MAX_JOBS`` per block: from the widest channel
    slice down to ``WIDE_SLICE`` channels (or the widest, if narrower),
    the most output rows per band whose grid fills two waves of the SMs;
    where none does, from the widest slice down to the narrowest, the
    most rows that fill one wave; where none does, the narrowest slice
    at one row per band (the most blocks).  Threads: one per job up to
    128, 256 above 512 jobs (measured on an H100: short blocks lose less
    to their shared chain of latencies, long ones want the threads)."""
    _, _, h_out = ref.same_pads(H, k, stride)
    _, _, w_out = ref.same_pads(W, k, stride)
    vec = copy_width(C)
    slices = _slices(C, vec)

    def make(cb, rows):
        n_cg = cb // 4
        cw = column_words(n_cg, stride, vec)
        jobs = rows * w_out * n_cg
        threads = MAX_THREADS if jobs > 512 else min(128, -(-jobs // 32) * 32)
        return DwPlan(cb, rows, cw, vec, threads, -(-C // cb),
                      -(-h_out // rows),
                      smem_bytes(rows, w_out, k, stride, cw, cb))

    wide = [cb for cb in slices if cb >= min(WIDE_SLICE, slices[0])]
    for waves, cands in ((2, wide), (1, slices)):
        for cb in cands:
            for rows in range(h_out, 0, -1):
                p = make(cb, rows)
                if (p.smem <= MAX_SMEM and rows * w_out * cb // 4 <= MAX_JOBS
                        and N * p.n_bands * p.n_slices >= waves * SMS):
                    return p
    p = make(slices[-1], 1)
    if p.smem > MAX_SMEM:
        raise ValueError(f"depthwise conv: a {W}-wide row of {p.cb} "
                         f"channels needs {p.smem} bytes of shared memory")
    return p


def conv2d_dw_plain(x_q, w_tap, eff_scale, eff_bias, shortcut=None, *,
                    k: int, stride: int, relu: bool = True,
                    return_acc: bool = False, profile_g: int | None = None):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_dw_int8_ref(x_q, w_tap, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc, profile_g)


def dw_launch(x_q, w_tap, eff_scale, eff_bias, shortcut, *, k: int,
              stride: int, relu: bool, return_acc: bool,
              profile_g: int | None, dplan: DwPlan):
    """Launch the kernel by ``dplan`` (the wrapper's is ``plan``'s)."""
    C = x_q.shape[3]
    check_cuda("w_tap", w_tap, torch.int8, (k * k, C))
    sc, geom, y, amax, acc = conv_outputs(x_q, eff_scale, eff_bias,
                                          shortcut, k, stride, C,
                                          return_acc)
    N, H, W, _, _, _, _, pad_top, pad_left, h_out, w_out = geom
    vec = dplan.vec
    while x_q.data_ptr() % vec:              # a view off the copy width
        vec = 4 if vec == 16 else 1
    # 16-byte f32 Collector operands, 4-byte int8 shortcut words
    if isinstance(shortcut, (tuple, list)):
        f32_ops, q = (eff_scale, eff_bias), shortcut[0]
    else:
        f32_ops, q = (eff_scale, eff_bias, shortcut), None
    vec_epi = (C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in f32_ops
                                  if t is not None)
               and (q is None or q.data_ptr() % 4 == 0))
    in_kernel = (profile_g is not None and C % profile_g == 0
                 and dplan.cb % profile_g == 0)
    zg = za = None
    if in_kernel:               # one zeroing launch for both counts
        zg, za = torch.zeros((2, N, C // profile_g), dtype=torch.int32,
                             device=x_q.device)
    KERNEL.launch(ptr(x_q), ptr(w_tap), ptr(eff_scale), ptr(eff_bias), *sc,
                  ptr(y), ptr(amax), ptr(acc), ptr(zg), ptr(za), N, H, W, C,
                  k, stride, pad_top, pad_left, h_out, w_out, int(relu),
                  profile_g if in_kernel else 0, dplan.cb, dplan.rows,
                  dplan.cw, vec, int(vec_epi), dplan.threads)
    out = (y, amax, acc) if return_acc else (y, amax)
    if profile_g is not None:
        out = out + (zero_count_dict(zg, za, h_out, w_out, C) if in_kernel
                     else ref.zero_counts_ref(y, profile_g),)
    return out


def conv2d_dw(x_q: torch.Tensor, w_tap: torch.Tensor,
              eff_scale: torch.Tensor, eff_bias: torch.Tensor,
              shortcut=None, *, k: int, stride: int, relu: bool = True,
              return_acc: bool = False, profile_g: int | None = None):
    """Fused depthwise SAME conv + Collector.

    x_q:       (N, H, W, C) int8 NHWC, unpadded
    w_tap:     (k*k, C) int8, tap-major (row = dy*k + dx)
    eff_scale: (N, C) f32, one dequant * BN row per image
    eff_bias:  (C,) f32
    shortcut:  optional (N, h_out, w_out, C) f32 map, or an int8
               ``(codes, scale (N,))`` pair added as ``fmaf(q, scale, y)``
    profile_g: optional coarse_in group size (C a multiple): also return
               the zero counts of ``y``, ``ref.zero_counts_ref``'s dict —
               from the kernel's epilogue where ``plan``'s channel slice
               is a multiple of it, else recounted on ``y``
    Returns (y (N, h_out, w_out, C) f32, amax (N,) f32 per-image max|y|),
    then the int32 accumulators with ``return_acc``, then the dict with
    ``profile_g``.
    """
    if x_q.device.type == "cpu":
        return conv2d_dw_plain(x_q, w_tap, eff_scale, eff_bias, shortcut,
                               k=k, stride=stride, relu=relu,
                               return_acc=return_acc, profile_g=profile_g)
    N, H, W, C = x_q.shape
    return dw_launch(x_q, w_tap, eff_scale, eff_bias, shortcut, k=k,
                     stride=stride, relu=relu, return_acc=return_acc,
                     profile_g=profile_g,
                     dplan=plan(N, H, W, C, k, stride))
