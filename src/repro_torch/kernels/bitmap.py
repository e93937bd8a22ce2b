"""Bitmap expand tile — plain PyTorch version (ports ``repro/kernels/bitmap.py``).

Format (core.compiled_linear.bitmap_pack):
  bitmap (K/8, N) uint8 — little-endian validity bits down the K axis
  values (keep_k, N) int8 — nonzero codes in ascending-row order per column

``expand_bitmap_tile`` turns one slab of packed bytes into dense int8
codes, carrying a running per-column nonzero count so callers can stream
the K axis in chunks.  The CUDA kernels (csrc/conv_common.cuh,
csrc/sparse_matvec.cu) do the same expansion in shared memory, counting
with ``__popc`` over bitmap bytes.
"""
from __future__ import annotations

import torch


def expand_bitmap_tile(bm8: torch.Tensor, values: torch.Tensor,
                       base: torch.Tensor, keep_k: int):
    """Expand one bitmap slab to dense codes.

    bm8:    (rows8, n) uint8 — a K-chunk of the bitmap (rows8*8 K rows)
    values: (keep_k, n) int8 — the full packed-values buffer
    base:   (1, n) int32 — nonzeros consumed per column by earlier chunks
    Returns (w_chunk (rows8*8, n) int8, new_base (1, n) int32).
    """
    rows8, n = bm8.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=bm8.device)
    bits = (bm8[:, None, :] >> shifts[None, :, None]) & 1
    mask = bits.reshape(rows8 * 8, n).to(torch.int32)
    pos = base + torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    pos = torch.clamp(pos, 0, keep_k - 1).to(torch.int64)
    gathered = torch.gather(values, 0, pos)
    w_chunk = torch.where(mask > 0, gathered, torch.zeros_like(gathered))
    return w_chunk, base + mask.sum(dim=0, keepdim=True, dtype=torch.int32)
