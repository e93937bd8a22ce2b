"""Dense implicit-GEMM int8 SAME conv + fused Collector — CUDA kernel
wrapper (ports ``repro/kernels/conv_implicit.py``).

Replaces ``conv2d_implicit_pallas`` (repro/kernels/conv_implicit.py:144,
with ``conv_tap_macs`` :44 and ``collector_epilogue`` :73).  The kernel is
``csrc/conv_implicit.cu`` over the template in ``csrc/conv_common.cuh``:
int8 taps gathered from the unpadded NHWC input (SAME padding by bounds
checks), int32 ``__dp4a`` accumulation, and the Collector
``y = fmaf(float(acc), eff_scale[image], eff_bias)`` (+ shortcut) (ReLU)
with a per-image ``max|y|`` for the int8 requantization pass.  Unlike the
TPU kernel it writes ``y`` in plain NHWC (no strip blocking) and sizes its
own tiles to shared memory.

What bounds it on an H100: the larger of its int8 operations over the
1,979 TOP/s tensor-core peak and its bytes (int8 input and weights, f32
output and shortcut, each moved once) over 3.35 TB/s; ``chip_smoke.py``
computes both per main-path shape.  This first kernel runs ``__dp4a`` on
the CUDA cores, not the tensor cores, so it sits well above that bound
(times in PERF.md); ``mma``/``wgmma`` tiles are later work.

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("conv_implicit", "conv_implicit_launch",
                    (P,) * 10 + (I,) * 12 + (P,))


def conv_geometry(x_q: torch.Tensor, k: int, stride: int) -> tuple:
    """(pad_top, pad_left, h_out, w_out) of a SAME conv on NHWC ``x_q``."""
    _, H, W, _ = x_q.shape
    lo_h, _, h_out = ref.same_pads(H, k, stride)
    lo_w, _, w_out = ref.same_pads(W, k, stride)
    return lo_h, lo_w, h_out, w_out


def plain_collector(acc, eff_scale, eff_bias, shortcut, relu, return_acc):
    """The plain Collector shared by both conv wrappers: ``(y, amax)``
    with per-image ``amax = max|y|`` (``+ (acc,)`` on request)."""
    N, n_out = eff_scale.shape
    y = ref._collector(acc, eff_scale.reshape(N, 1, 1, n_out), eff_bias,
                       shortcut, relu)
    amax = torch.amax(torch.abs(y), dim=(1, 2, 3))
    return (y, amax, acc) if return_acc else (y, amax)


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
    if C % 4 == 0 and x_q.data_ptr() % 4:
        raise ValueError("x_q: the kernel reads 4-byte words; the tensor "
                         "must start 4-byte aligned")
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


def conv2d_implicit_plain(x_q, w_sp, eff_scale, eff_bias, shortcut=None, *,
                          k: int, stride: int, relu: bool = True,
                          return_acc: bool = False):
    """Plain PyTorch version of the kernel, on any device."""
    acc = ref.conv2d_int8_ref(x_q, w_sp, k, stride)
    return plain_collector(acc, eff_scale, eff_bias, shortcut, relu,
                           return_acc)


def conv2d_implicit(x_q: torch.Tensor, w_sp: torch.Tensor,
                    eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                    shortcut: torch.Tensor | None = None, *, k: int,
                    stride: int, relu: bool = True,
                    return_acc: bool = False):
    """Fused implicit-GEMM SAME conv + Collector.

    x_q:       (N, H, W, C) int8 NHWC, unpadded
    w_sp:      (k*k*C, n_out) int8, spatial-major taps (row = tap*C + c)
    eff_scale: (N, n_out) f32, one dequant * BN row per image
    eff_bias:  (n_out,) f32
    shortcut:  optional (N, h_out, w_out, n_out) f32 map, or an int8
               ``(codes, scale (N,))`` pair added as ``fmaf(q, scale, y)``
    Returns (y (N, h_out, w_out, n_out) f32, amax (N,) f32 per-image
    max|y|), plus the int32 accumulators with ``return_acc``.
    """
    if x_q.device.type == "cpu":
        return conv2d_implicit_plain(x_q, w_sp, eff_scale, eff_bias,
                                     shortcut, k=k, stride=stride,
                                     relu=relu, return_acc=return_acc)
    n_out = w_sp.shape[1]
    check_cuda("w_sp", w_sp, torch.int8, (k * k * x_q.shape[3], n_out))
    sc, geom, y, amax, acc = conv_outputs(x_q, eff_scale, eff_bias,
                                          shortcut, k, stride, n_out,
                                          return_acc)
    KERNEL.launch(ptr(x_q), ptr(w_sp), ptr(eff_scale), ptr(eff_bias), *sc,
                  ptr(y), ptr(amax), ptr(acc), *geom, int(relu))
    return (y, amax, acc) if return_acc else (y, amax)
