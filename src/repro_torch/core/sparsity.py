"""Parameter sparsity utilities (ports ``repro/core/sparsity.py``).

The paper's ResNet50 is 80 % unstructured-sparse, and "MACs associated
with constant zeros are simply dropped" (paper SS II-A).  Element
sparsity is of little use to a dense matrix unit, so constant sparsity
is turned into forms the hardware can use:

* magnitude pruning to a target sparsity (the model-side substrate);
* bitmap-packed storage (values of nonzeros + 1 bit per element);
* row clustering -> block-level sparsity that a tiled kernel skips
  (weights are constants, so the block mask is compile-time metadata:
  ``ops.block_sparse_matmul``).

``magnitude_prune`` and ``sparsity_stats`` work on tensors on any
device; the compile-time helpers (``bitmap_pack``, ``block_mask``,
``cluster_rows``) run on a host numpy copy, as in the JAX package, and
give the same arrays, bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 widened, exactly, to f32) or of
    an array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero the smallest-|w| fraction globally (unstructured).

    The threshold is the k-th smallest |w|, and only values strictly
    above it stay, so ties at the threshold fall as in the JAX package."""
    if sparsity <= 0.0:
        return w
    flat = torch.abs(w).reshape(-1)
    k = int(round(flat.numel() * sparsity))
    if k <= 0:
        return w
    thresh = torch.sort(flat).values[k - 1]
    return torch.where(torch.abs(w) > thresh, w, torch.zeros_like(w))


def sparsity_stats(q) -> dict:
    nz = int(torch.count_nonzero(torch.as_tensor(q)))
    total = int(np.prod(tuple(q.shape)))
    return {"total": total, "nonzero": nz,
            "sparsity": 1.0 - nz / max(total, 1)}


@dataclasses.dataclass
class BitmapPacked:
    """Bitmap-compressed constant weights (decode-bandwidth format).

    ``bitmap`` packs one validity bit per element (uint8, K/8 per column
    group); ``values`` holds int8 codes of nonzeros, padded to a fixed
    budget so shapes are static.  Storage for s-sparse INT7:
    (1-s)*8 + 1 bits/param  (~2.6 bits at 80% vs 16 for bf16 -> ~6.2x).
    """

    bitmap: np.ndarray        # (K // 8, N) uint8
    values: np.ndarray        # (budget, N) int8, column-major packed nonzeros
    nnz_per_col: np.ndarray   # (N,) int32
    shape: tuple[int, int]

    @property
    def packed_bytes(self) -> int:
        return self.bitmap.size + self.values.size + 4 * self.nnz_per_col.size

    @property
    def dense_bf16_bytes(self) -> int:
        return 2 * int(np.prod(self.shape))


def bitmap_pack(q_codes, budget_slack: float = 1.0) -> BitmapPacked:
    """Pack int8 codes (K, N) column-wise.  budget = max col nnz * slack."""
    q = _host(q_codes)
    K, N = q.shape
    if K % 8 != 0:
        raise ValueError("K must be a multiple of 8 for bitmap packing")
    mask = (q != 0)
    nnz_per_col = mask.sum(axis=0).astype(np.int32)
    budget = int(np.ceil(nnz_per_col.max() * budget_slack)) if N else 0
    bits = mask.astype(np.uint8).reshape(K // 8, 8, N)
    weights = (1 << np.arange(8, dtype=np.uint8)).reshape(1, 8, 1)
    bitmap = (bits * weights).sum(axis=1).astype(np.uint8)
    values = np.zeros((budget, N), np.int8)
    for n in range(N):
        col = q[mask[:, n], n]
        values[: col.size, n] = col
    return BitmapPacked(bitmap, values, nnz_per_col, (K, N))


def bitmap_unpack(p: BitmapPacked) -> np.ndarray:
    K, N = p.shape
    bits = np.unpackbits(p.bitmap[:, None, :], axis=1, bitorder="little")
    mask = bits.reshape(K, N).astype(bool)
    q = np.zeros((K, N), np.int8)
    for n in range(N):
        q[mask[:, n], n] = p.values[: p.nnz_per_col[n], n]
    return q


def block_mask(q_codes, block: tuple[int, int]) -> np.ndarray:
    """(K/bk, N/bn) bool mask: True where a weight block has any nonzero.

    Weights are constants, so this mask is compile-time metadata: the
    block-sparse matmul launches work for its True blocks only.
    """
    q = _host(q_codes)
    K, N = q.shape
    bk, bn = block
    if K % bk or N % bn:
        raise ValueError(f"block {block} does not tile {q.shape}")
    blocks = q.reshape(K // bk, bk, N // bn, bn)
    return (blocks != 0).any(axis=(1, 3))


def block_sparsity(q_codes, block: tuple[int, int]) -> float:
    m = block_mask(q_codes, block)
    return 1.0 - float(m.mean())


def cluster_rows(q_codes, block_k: int, iters: int = 8) -> np.ndarray:
    """Greedy row permutation concentrating nonzeros into row blocks.

    Orders rows by column-support similarity so that rows sharing support
    land in the same block of ``block_k``, raising the block sparsity a
    kernel specialised to the constant mask can skip.  Returns the
    permutation: the same one the JAX package returns, step for step.
    """
    q = _host(q_codes)
    K = q.shape[0]
    support = (q != 0)
    # Sort rows by (nnz, first-nonzero-column), then try swapping the
    # boundary rows of neighbouring blocks to shrink their joint support.
    order = np.lexsort((support.argmax(axis=1), support.sum(axis=1)))
    sup = support[order]
    perm = list(range(K))
    for _ in range(iters):
        improved = False
        for i in range(0, K - block_k, block_k):
            a = sup[perm[i: i + block_k]].any(axis=0)
            j_block = i + block_k
            b = sup[perm[j_block: j_block + block_k]].any(axis=0)
            base = a.sum() + b.sum()
            ii, jj = i + block_k - 1, j_block
            if jj < len(perm):
                perm[ii], perm[jj] = perm[jj], perm[ii]
                a2 = sup[perm[i: i + block_k]].any(axis=0)
                b2 = sup[perm[j_block: j_block + block_k]].any(axis=0)
                if a2.sum() + b2.sum() < base:
                    improved = True
                else:
                    perm[ii], perm[jj] = perm[jj], perm[ii]
        if not improved:
            break
    return order[np.asarray(perm)]


def effective_ops(q_codes, macs_dense: int) -> dict:
    """Paper's "effective TOPs" accounting: ops are counted dense (sparsity
    is a benefit, so effective ops = dense MACs * 2) while the hardware only
    executes the nonzero fraction."""
    stats = sparsity_stats(q_codes)
    executed = macs_dense * (1.0 - stats["sparsity"])
    return {
        "effective_ops": 2 * macs_dense,
        "executed_macs": executed,
        "speedup_vs_dense": macs_dense / max(executed, 1.0),
        **stats,
    }
