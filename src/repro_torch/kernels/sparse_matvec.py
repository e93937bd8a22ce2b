"""Bitmap-packed sparse matmul — CUDA kernel wrapper (ports
``repro/kernels/sparse_matvec.py``).

Replaces ``sparse_matvec_pallas`` (repro/kernels/sparse_matvec.py:55).
On the main path it is the ResNet head in ``sparse_cfmm``
(core/compiled_linear.py ``apply_linear``: M = microbatch rows, K =
2048, N = 1000) and every SmolLM linear in ``sparse_cfmm`` (M = the
prefill bucket or the decode slots, K and N = 960, 320, 2560).  It
returns the exact int32 product; the caller applies any scale
(``ops.sparse_cfmm_matmul``), as the JAX package's main path does.

The kernel (``csrc/sparse_matvec.cu``) runs on the int8 tensor cores:
a block walks K in chunks of 128 rows, expands each chunk of its 64
columns from the bitmap in shared memory (a running per-column nonzero
count, as the TPU kernel carries, plus popcounts within the chunk) into
a K-contiguous tile that ``mma.sync.m16n8k32`` reads as its B operand,
and sums in int32, which is exact in any order.

What bounds it on an H100: at prefill widths the int32 output write
(4 M N bytes over 3.35 TB/s); at the head and in decode (M <= 4) the
packed weight bytes.  ``plan`` is the rule that picks the variant
(``rows`` for M >= 17, 256 rows per block; ``split`` for M <= 16, one
m16 tile) and splits K over the grid where the column tiles alone
would fill at most half of the 132 SMs (the splits add into a zeroed
output with atomics).

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("sparse_matvec", "sparse_matvec_launch",
                    (P,) * 4 + (I,) * 7 + (P,))
VARIANTS = {"rows": 0, "split": 1}
SMS = 132            # streaming multiprocessors of an H100 SXM
BLOCK_N = 64         # output columns per block
ROWS_M = 256         # rows per block of the rows variant
SPLIT_MAX_M = 16     # the split variant's one m16 tile
K_CHUNK = 128        # K rows a block expands at a time


def plan(M: int, K: int, N: int) -> tuple:
    """(variant, splits, chunks_per) for one call: ``split`` for
    M <= 16, else ``rows``; K's chunks split over ``splits`` ranges of
    ``chunks_per`` chunks when the grid's tiles would fill at most half
    of the SMs, so that about two blocks land on every SM."""
    variant = "split" if M <= SPLIT_MAX_M else "rows"
    m_tiles = 1 if variant == "split" else -(-M // ROWS_M)
    tiles = m_tiles * -(-N // BLOCK_N)
    n_chunks = -(-K // K_CHUNK)
    splits = 1
    if 2 * tiles <= SMS:
        splits = min(n_chunks, -(-2 * SMS // tiles))
    chunks_per = -(-n_chunks // splits)
    return variant, -(-n_chunks // chunks_per), chunks_per


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
    if keep_k < 1:
        raise ValueError("values: needs at least one row")
    check_cuda("x_q", x_q, torch.int8)
    check_cuda("bitmap", bitmap, torch.uint8)
    check_cuda("values", values, torch.int8, (keep_k, N))
    if x_q.data_ptr() % 8:               # the kernel copies x in 8 bytes
        x_q = x_q.clone()
    variant, splits, chunks_per = plan(M, K, N)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((M, N), dtype=torch.int32, device=x_q.device)
    KERNEL.launch(ptr(x_q), ptr(bitmap), ptr(values), ptr(out), M, K, N,
                  keep_k, VARIANTS[variant], splits, chunks_per)
    return out
