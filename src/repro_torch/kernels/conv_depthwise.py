"""Depthwise int8 SAME conv + fused Collector — CUDA kernel wrapper
(ports ``repro/kernels/conv_depthwise.py``).

Replaces ``conv2d_dw_pallas`` (repro/kernels/conv_depthwise.py:80, with
``dw_tap_macs`` :36).  The kernel is ``csrc/conv_depthwise.cu``: one
thread per (output pixel, four channels), an elementwise int8 tap-MAC
over the tap-major ``(k*k, C)`` weights into int32, then the Collector of
``csrc/conv_common.cuh`` — the dense conv kernels' own epilogue code, so
``y`` rounds exactly as theirs does — with a per-image ``max|y|``.  Unlike
the TPU kernel it has no row strips and no channel padding: it reads the
unpadded NHWC input (SAME padding by bounds checks), masks the ragged
channel edge itself and writes ``y`` in plain NHWC.

What bounds it on an H100: bytes.  It does 2*k*k operations per output
element and moves about 4 bytes of f32 output (plus its int8 input), far
below the 1,979 TOP/s int8 peak's ratio; ``chip_smoke.py`` computes both
bounds at MobileNetV2's shapes.  This first kernel reads each input word
once per tap through the caches and does its MACs on the CUDA cores
(times in PERF.md).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr
from repro_torch.kernels.conv_implicit import conv_outputs, plain_collector

KERNEL = CudaKernel("conv_depthwise", "conv_depthwise_launch",
                    (P,) * 10 + (I,) * 11 + (P,))


def conv2d_dw_plain(x_q, w_tap, eff_scale, eff_bias, shortcut=None, *,
                    k: int, stride: int, relu: bool = True,
                    return_acc: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_dw_int8_ref(x_q, w_tap, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc)


def conv2d_dw(x_q: torch.Tensor, w_tap: torch.Tensor,
              eff_scale: torch.Tensor, eff_bias: torch.Tensor,
              shortcut=None, *, k: int, stride: int, relu: bool = True,
              return_acc: bool = False):
    """Fused depthwise SAME conv + Collector.

    x_q:       (N, H, W, C) int8 NHWC, unpadded
    w_tap:     (k*k, C) int8, tap-major (row = dy*k + dx)
    eff_scale: (N, C) f32, one dequant * BN row per image
    eff_bias:  (C,) f32
    shortcut:  optional (N, h_out, w_out, C) f32 map, or an int8
               ``(codes, scale (N,))`` pair added as ``fmaf(q, scale, y)``
    Returns (y (N, h_out, w_out, C) f32, amax (N,) f32 per-image max|y|),
    plus the int32 accumulators with ``return_acc``.
    """
    if x_q.device.type == "cpu":
        return conv2d_dw_plain(x_q, w_tap, eff_scale, eff_bias, shortcut,
                               k=k, stride=stride, relu=relu,
                               return_acc=return_acc)
    C = x_q.shape[3]
    check_cuda("w_tap", w_tap, torch.int8, (k * k, C))
    if C % 4 == 0 and x_q.data_ptr() % 4:
        raise ValueError("x_q: the kernel reads 4-byte words; the tensor "
                         "must start 4-byte aligned")
    sc, geom, y, amax, acc = conv_outputs(x_q, eff_scale, eff_bias,
                                          shortcut, k, stride, C,
                                          return_acc)
    N, H, W, _, _, _, _, pad_top, pad_left, h_out, w_out = geom
    KERNEL.launch(ptr(x_q), ptr(w_tap), ptr(eff_scale), ptr(eff_bias), *sc,
                  ptr(y), ptr(amax), ptr(acc), N, H, W, C, k, stride,
                  pad_top, pad_left, h_out, w_out, int(relu))
    return (y, amax, acc) if return_acc else (y, amax)
