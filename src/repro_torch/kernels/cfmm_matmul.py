"""int8 GEMM of the ``cfmm`` serve mode — CUDA kernel wrapper (ports
``repro/kernels/cfmm_matmul.py``).

Replaces ``cfmm_matmul_pallas`` (repro/kernels/cfmm_matmul.py:44).  On
the CNN path it is the classifier head in ``cfmm``
(core/compiled_linear.py ``apply_linear``): M = microbatch rows, K = 2048
(ResNet50) or 1280 (MobileNetV2), N = 1000.  The kernel
(``csrc/cfmm_matmul.cu``) gives each block 128 columns and 8 rows and
splits K over 8 warps; each lane reads four weight rows of its four
columns as words, transposes them with ``__byte_perm`` and issues
``__dp4a``.  It returns the **exact** int32 product; with a scale it
returns ``float(acc) * scale`` rounded once, as ``ref.cfmm_matmul_ref``
does.  (The TPU path with ``scale=None`` multiplies by ones in f32 and
casts back, which loses bits once |acc| >= 2**24; the port follows the
exact jnp oracle instead.)

What bounds it on an H100: at M = 2, bytes — the (K, N) weight codes,
read once, over 3.35 TB/s; its 2*M*K*N operations are negligible
against the 1,979 TOP/s int8 peak.  With 8 blocks at N = 1000 it fills
only 8 of the 132 SMs, so it sits well above that bound (PERF.md).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("cfmm_matmul", "cfmm_matmul_launch",
                    (P,) * 5 + (I,) * 3 + (P,))


def cfmm_matmul_plain(x_q: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    if scale is None:
        return ref.int8_matmul_ref(x_q, codes)
    return ref.cfmm_matmul_ref(x_q, codes, scale.reshape(1, -1))


def cfmm_matmul(x_q: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """x_q (M, K) int8 @ codes (K, N) int8 -> int32 (M, N), exact; or,
    with a per-column ``scale`` (N,) / (1, N), f32 ``acc * scale``."""
    if x_q.device.type == "cpu":
        return cfmm_matmul_plain(x_q, codes, scale)
    M, K = x_q.shape
    N = codes.shape[1]
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("codes", codes, torch.int8, (K, N))
    dev = x_q.device
    if scale is None:
        out = torch.empty((M, N), dtype=torch.int32, device=dev)
        KERNEL.launch(ptr(x_q), ptr(codes), ptr(None), ptr(out), ptr(None),
                      M, K, N)
        return out
    s = scale.reshape(-1)
    check_cuda("scale", s, torch.float32, (N,))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    KERNEL.launch(ptr(x_q), ptr(codes), ptr(s), ptr(None), ptr(out), M, K, N)
    return out
