"""Bitmap-packed sparse matmul — CUDA kernel wrapper (ports
``repro/kernels/sparse_matvec.py``).

Replaces ``sparse_matvec_pallas`` (repro/kernels/sparse_matvec.py:55).
On the main path it is the ResNet head in ``sparse_cfmm``
(core/compiled_linear.py ``apply_linear``): M = microbatch rows, K = 2048,
N = 1000.  The kernel (``csrc/sparse_matvec.cu``) gives each block 32
columns and splits K over 8 warps; popcounts of the bitmap give each
segment its start in the packed values, so the running nonzero count of
the TPU kernel becomes a prefix over segments, and only nonzero weights
cost a MAC.  It returns the exact int32 product; the caller applies any
scale (``ops.sparse_cfmm_matmul``), as the JAX package's main path does.

What bounds it on an H100: bytes — the packed weights (K/8 + keep_k
bytes per column) over 3.35 TB/s; its M x nnz MACs are negligible against
the 1,979 TOP/s int8 peak.  At N = 1000 the kernel runs 32 blocks on 132
SMs and each thread walks its segment's set bits one dependent load at a
time, so it sits far above that bound (PERF.md).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("sparse_matvec", "sparse_matvec_launch",
                    (P,) * 4 + (I,) * 4 + (P,))


def sparse_matvec(x_q: torch.Tensor, bitmap: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """x_q (M, K) int8 @ bitmap-packed (K, N) -> int32 (M, N), exact.

    bitmap (K/8, N) uint8, values (keep_k, N) int8; K % 8 == 0 (the
    caller pads x with zero columns to the bitmap's rows).
    """
    if x_q.device.type == "cpu":
        return ref.sparse_matvec_ref(x_q, bitmap, values)
    M, K = x_q.shape
    kb8, N = bitmap.shape
    keep_k = values.shape[0]
    if kb8 * 8 != K:
        raise ValueError(f"x_q has K={K}, bitmap covers {kb8 * 8} rows")
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("bitmap", bitmap, torch.uint8)
    check_cuda("values", values, torch.int8, (keep_k, N))
    out = torch.empty((M, N), dtype=torch.int32, device=x_q.device)
    KERNEL.launch(ptr(x_q), ptr(bitmap), ptr(values), ptr(out), M, K, N,
                  keep_k)
    return out
