"""Bitmap-packed implicit-GEMM int8 SAME conv + fused Collector — CUDA
kernel wrapper (ports ``repro/kernels/conv_sparse.py``).

Replaces ``conv2d_sparse_pallas`` (repro/kernels/conv_sparse.py:90, with
``expand_bitmap_tile`` from repro/kernels/bitmap.py:21).  The kernel is
``csrc/conv_sparse.cu``: the template of ``csrc/conv_common.cuh`` with the
weight tile expanded in shared memory from ``(bitmap, values)`` one 32-row
K chunk at a time — a 3x3 conv at C = 512 has K = 4608, too deep to
expand whole — carrying each column's running nonzero count from chunk to
chunk by popcounting its bitmap bytes.  The MAC loop and the Collector
are the dense kernel's own code, so on the same (expanded) codes the two
agree to the bit.  Device memory only ever holds the packed bytes, which
stay byte-equal to the JAX package's.

What bounds it on an H100: the larger of the operations that the nonzero
weights need over the 1,979 TOP/s int8 peak and the bytes (int8 input,
packed weights, f32 output and shortcut) over 3.35 TB/s.  The kernel
multiplies the expanded zeros too (dense ``__dp4a`` MACs), so it runs
well above that bound (times in PERF.md).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr
from repro_torch.kernels.conv_implicit import conv_outputs, plain_collector

KERNEL = CudaKernel("conv_sparse", "conv_sparse_launch",
                    (P,) * 11 + (I,) * 14 + (P,))


def conv2d_sparse_plain(x_q, bitmap, values, eff_scale, eff_bias,
                        shortcut=None, *, k: int, stride: int,
                        relu: bool = True, return_acc: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_sparse_int8_ref(x_q, bitmap, values, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc)


def conv2d_sparse(x_q: torch.Tensor, bitmap: torch.Tensor,
                  values: torch.Tensor, eff_scale: torch.Tensor,
                  eff_bias: torch.Tensor,
                  shortcut: torch.Tensor | None = None, *, k: int,
                  stride: int, relu: bool = True, return_acc: bool = False):
    """Fused bitmap-native SAME conv + Collector.

    bitmap: (K_pad/8, n_out) uint8, spatial-major taps, K_pad = k*k*C
            rounded up to a multiple of 8 (zero-masked tail rows)
    values: (keep_k, n_out) int8 nonzero codes, ascending-row order
    Other arguments and the return as ``conv_implicit.conv2d_implicit``.
    """
    if x_q.device.type == "cpu":
        return conv2d_sparse_plain(x_q, bitmap, values, eff_scale, eff_bias,
                                   shortcut, k=k, stride=stride, relu=relu,
                                   return_acc=return_acc)
    kb8, n_out = bitmap.shape
    keep_k = values.shape[0]
    if kb8 * 8 != -(-k * k * x_q.shape[3] // 8) * 8:
        raise ValueError(f"bitmap rows {kb8} do not match k={k}, "
                         f"C={x_q.shape[3]}")
    check_cuda("bitmap", bitmap, torch.uint8)
    check_cuda("values", values, torch.int8, (keep_k, n_out))
    sc, geom, y, amax, acc = conv_outputs(x_q, eff_scale, eff_bias,
                                          shortcut, k, stride, n_out,
                                          return_acc)
    KERNEL.launch(ptr(x_q), ptr(bitmap), ptr(values), ptr(eff_scale),
                  ptr(eff_bias), *sc, ptr(y), ptr(amax), ptr(acc), *geom,
                  kb8, keep_k, int(relu))
    return (y, amax, acc) if return_acc else (y, amax)
