"""Bitmap-packed implicit-GEMM int8 SAME conv + fused Collector — CUDA
kernel wrapper (ports ``repro/kernels/conv_sparse.py``).

Replaces ``conv2d_sparse_pallas`` (repro/kernels/conv_sparse.py:90, with
``expand_bitmap_tile`` from repro/kernels/bitmap.py:21).  The kernel is
``csrc/conv_sparse.cu``: the template of ``csrc/conv_mma.cuh`` — the
dense kernel's ring, tensor-core MACs (``mma.sync.m16n8k32``) and
Collector — with the weight tile expanded in shared memory from
``(bitmap, values)`` one 64-row K chunk at a time (a 3x3 conv at C = 512
has K = 4608, too deep to expand whole).  The chunk's bitmap bytes come
into the ring by ``cp.async`` with the input tile; one thread per
(column, 32 K rows) finds where its codes start in the column's packed
values — the column's running nonzero count, carried from chunk to
chunk as the TPU kernel carries it, plus a popcount — and gathers them
into a K-major tile, the next chunk's gathers in flight while the
current chunk's MACs run.  Where ``conv_implicit.plan`` splits K over
the grid, each split starts from a popcount of the bitmap rows before
it.  On the same (expanded) codes the two kernels agree to the bit.
Device memory only ever holds the packed bytes, which stay byte-equal to
the JAX package's.

What bounds it on an H100: the larger of the operations that the nonzero
weights need over the 1,979 TOP/s int8 peak and the bytes (int8 input,
packed weights, f32 output and shortcut) over 3.35 TB/s — bytes at every
served shape.  The tensor cores multiply the expanded zeros too.

``profile_g`` returns the zero counts of ``y`` as ``conv_implicit``
does (the same epilogue; the TPU kernel's output at conv_sparse.py:49-84
of the JAX package).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda
from repro_torch.kernels.conv_implicit import (conv_geometry, conv_launch,
                                               plain_collector, plan)

KERNEL = CudaKernel("conv_sparse", "conv_sparse_launch",
                    (P,) * 13 + (I,) * 20 + (P,))


def conv2d_sparse_plain(x_q, bitmap, values, eff_scale, eff_bias,
                        shortcut=None, *, k: int, stride: int,
                        relu: bool = True, return_acc: bool = False,
                        profile_g: int | None = None):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_sparse_int8_ref(x_q, bitmap, values, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc, profile_g)


def conv2d_sparse(x_q: torch.Tensor, bitmap: torch.Tensor,
                  values: torch.Tensor, eff_scale: torch.Tensor,
                  eff_bias: torch.Tensor,
                  shortcut: torch.Tensor | None = None, *, k: int,
                  stride: int, relu: bool = True, return_acc: bool = False,
                  profile_g: int | None = None):
    """Fused bitmap-native SAME conv + Collector.

    bitmap: (K_pad/8, n_out) uint8, spatial-major taps, K_pad = k*k*C
            rounded up to a multiple of 8 (zero-masked tail rows)
    values: (keep_k, n_out) int8 nonzero codes, ascending-row order
    Other arguments and the return as ``conv_implicit.conv2d_implicit``.
    """
    if x_q.device.type == "cpu":
        return conv2d_sparse_plain(x_q, bitmap, values, eff_scale, eff_bias,
                                   shortcut, k=k, stride=stride, relu=relu,
                                   return_acc=return_acc,
                                   profile_g=profile_g)
    N, _, _, C = x_q.shape
    kb8, n_out = bitmap.shape
    keep_k = values.shape[0]
    if kb8 * 8 != -(-k * k * C // 8) * 8:
        raise ValueError(f"bitmap rows {kb8} do not match k={k}, C={C}")
    check_cuda("bitmap", bitmap, torch.uint8)
    check_cuda("values", values, torch.int8, (keep_k, n_out))
    if max(values.numel(), bitmap.numel() * 8) >= 2 ** 31:
        raise ValueError("the kernel indexes values with 32-bit offsets: "
                         "K_pad * n_out must stay under 2**31")
    _, _, h_out, w_out = conv_geometry(x_q, k, stride)
    return conv_launch(KERNEL, x_q, (bitmap, values), eff_scale, eff_bias,
                       shortcut, k=k, stride=stride, n_out=n_out, relu=relu,
                       return_acc=return_acc,
                       cplan=plan(N, h_out, w_out, C, k, n_out, sparse=True),
                       sparse_ints=(kb8, keep_k), profile_g=profile_g)
