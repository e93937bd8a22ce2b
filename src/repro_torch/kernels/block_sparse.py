"""Block-sparse constant-weight matmul — CUDA kernel wrapper (ports
``repro/kernels/block_sparse.py``).

Replaces ``block_sparse_matmul_pallas`` (repro/kernels/block_sparse.py:64),
with ``plan_blocks`` copied as it is.  "MACs associated with constant
zeros are simply dropped" (paper SS II-A) at the granularity of whole
``(bk, bn)`` weight blocks: the weights are constants, so the block mask
is compile-time metadata and only the active blocks are stored, read and
multiplied.  In the JAX package only ``ops.block_sparse_matmul`` calls
it, on weights that ``core.sparsity`` prunes and clusters; no served path
does, and the port keeps it so.

``pack_blocks`` turns the constant weights into the kernel's operands
once: the active blocks in plan order (column-major: every k-block of
output block column nb adjacent, ascending k), the plan, and per-column
offsets into it (a CSC of blocks).  The TPU kernel's first/last flags
become those offsets' bounds.  The kernel (``csrc/block_sparse.cu``)
gives each thread block a 64 x 64 output tile of one block column; it
walks only that column's active k-blocks, 32 k-rows a step, through a
``cp.async`` ring of shared-memory stages, sums each block's product in
a fresh f32 accumulator and adds it to the column's sum, as the TPU
kernel does.  bf16 runs on the tensor cores (``mma.sync.m16n8k16``,
``ldmatrix`` for x, ``ldmatrix.trans`` for the row-major blocks); f32
stays on FMAs, since TF32 would change the function.  ``plan`` splits a
column's active blocks over a thread-block cluster where the tiles alone
do not fill the card (small M); the splits' f32 partials are added in
ascending order in distributed shared memory, so every call gives the
same bits.  Ragged M and blocks that are no multiple of the tile are
zero-filled in shared memory, never padded in memory; the output is
written once, in ``x``'s type, and block columns with no active block
get zeros.

What bounds it on an H100: in f32, operations (2 M bk bn flops per
active block at 67 TFLOP/s on the CUDA cores); in bf16, with the tensor
cores' 989 TFLOP/s, bytes (x, the active blocks and the output once
each, at 3.35 TB/s) at ResNet50's 1x1 shapes and operations at
SmolLM-360M's 1024-token gate/up.

For a CPU tensor the wrapper runs the plain version
(``ref.block_sparse_matmul_plain``); for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.sparsity import block_mask
from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("block_sparse", "block_sparse_launch",
                    (P,) * 5 + (I,) * 8 + (P,))
DTYPES = (torch.float32, torch.bfloat16)
SMS = 132            # streaming multiprocessors of an H100 SXM
TILE_M = 64          # output rows per tile
TILE_N = 64          # output columns per tile (within one block column)
MAX_SPLITS = 16      # a tile's splits form one thread-block cluster


class BlockSparsePlan(NamedTuple):
    """How one call launches: ``variant`` "mma" (bf16, tensor cores) or
    "fma" (f32, CUDA cores); the grid is ``n_tiles`` (64 columns of one
    block column each) x ``m_tiles`` x ``splits``, split ``z`` of a
    column with c active blocks taking blocks ``[c z / splits, c (z + 1)
    / splits)`` of it."""
    variant: str
    m_tiles: int
    n_tiles: int
    splits: int


def plan(M: int, block_kn, n_blocks_n: int, n_active: int,
         dtype) -> BlockSparsePlan:
    """The launch of one call: 64 x 64 tiles; where they fill at most
    half of the 132 SMs, each column's active blocks split over as many
    splits as one block per SM needs, at most ``MAX_SPLITS`` and at most
    the mean active blocks per column (so that most splits get one)."""
    _, bn = block_kn
    m_tiles = -(-M // TILE_M)
    n_tiles = n_blocks_n * -(-bn // TILE_N)
    tiles = m_tiles * n_tiles
    splits = 1
    if 2 * tiles <= SMS:
        splits = max(1, min(MAX_SPLITS, n_active // n_blocks_n,
                            -(-SMS // tiles)))
    return BlockSparsePlan("mma" if dtype == torch.bfloat16 else "fma",
                           m_tiles, n_tiles, splits)


def copy_width(elt: int, lengths, addresses) -> int:
    """Bytes per copy of x and weight rows: 16 or 4 where every row length
    (in elements) and every address allow it, else the element size."""
    for v in (16, 4):
        if all(n * elt % v == 0 for n in lengths) \
                and all(a % v == 0 for a in addresses):
            return v
    return elt


def plan_blocks(mask: np.ndarray) -> np.ndarray:
    """mask (Kb, Nb) bool -> meta (4, n_active) int32, column-major order."""
    ks, ns, firsts, lasts = [], [], [], []
    for nb in range(mask.shape[1]):
        active = np.nonzero(mask[:, nb])[0]
        for pos, kb in enumerate(active):
            ks.append(kb)
            ns.append(nb)
            firsts.append(1 if pos == 0 else 0)
            lasts.append(1 if pos == len(active) - 1 else 0)
    if not ks:  # degenerate: fully sparse
        return np.zeros((4, 0), np.int32)
    return np.stack([ks, ns, firsts, lasts]).astype(np.int32)


@dataclasses.dataclass
class BlockSparseWeights:
    """Constant weights as the kernel's operands, built once.

    w_blocks (n_active, bk, bn) in plan order; meta (4, n_active) int32
    (``plan_blocks``); offsets (n_blocks_n + 1,) int32, the blocks of
    column nb being ``offsets[nb]:offsets[nb + 1]``; mask (Kb, Nb) bool
    on the host."""

    w_blocks: torch.Tensor
    meta: torch.Tensor
    offsets: torch.Tensor
    mask: np.ndarray
    block_kn: tuple

    @property
    def n_blocks_n(self) -> int:
        return self.mask.shape[1]

    @property
    def n_active(self) -> int:
        return self.w_blocks.shape[0]


def pack_blocks(w, block_kn, dtype, device) -> BlockSparseWeights:
    """Find w's nonzero (bk, bn) blocks on a host copy, cut them out in
    plan order, cast them to ``dtype`` (weights round there, as the JAX
    op casts them to x's type) and put them, the plan and the offsets on
    ``device``."""
    bk, bn = block_kn
    wh = w.detach().cpu() if isinstance(w, torch.Tensor) else \
        torch.from_numpy(np.asarray(w))
    mask = block_mask(wh, (bk, bn))
    meta = plan_blocks(mask)
    if meta.shape[1]:
        blocks = torch.stack([wh[kb * bk:(kb + 1) * bk, nb * bn:(nb + 1) * bn]
                              for kb, nb in zip(meta[0], meta[1])])
    else:
        blocks = torch.zeros((0, bk, bn))
    offsets = np.concatenate([[0], np.cumsum(mask.sum(axis=0))])
    return BlockSparseWeights(
        w_blocks=blocks.to(dtype).to(device).contiguous(),
        meta=torch.from_numpy(meta).to(device).contiguous(),
        offsets=torch.from_numpy(offsets.astype(np.int32)).to(device),
        mask=mask, block_kn=(bk, bn))


def block_sparse_matmul(x: torch.Tensor, w_blocks: torch.Tensor,
                        meta: torch.Tensor, offsets: torch.Tensor,
                        block_kn, n_blocks_n: int) -> torch.Tensor:
    """x (M, K) @ the active blocks -> (M, n_blocks_n * bn) in x's type.

    x f32 or bf16; w_blocks (n_active, bk, bn) of x's type, meta and
    offsets as ``pack_blocks`` makes them.  The sum is f32 and rounds
    once."""
    if x.device.type == "cpu":
        return ref.block_sparse_matmul_plain(x, w_blocks, meta, offsets,
                                             block_kn, n_blocks_n)
    M, K = x.shape
    bk, bn = block_kn
    n_active = w_blocks.shape[0]
    if x.dtype not in DTYPES:
        raise ValueError(f"block_sparse_matmul: f32 or bf16, got {x.dtype}")
    if bk < 1 or bn < 1 or K % bk:
        raise ValueError(f"block_sparse_matmul: block {block_kn} does not "
                         f"tile K={K}")
    check_cuda("x", x, x.dtype)
    check_cuda("w_blocks", w_blocks, x.dtype, (n_active, bk, bn))
    check_cuda("meta", meta, torch.int32, (4, n_active))
    check_cuda("offsets", offsets, torch.int32, (n_blocks_n + 1,))
    p = plan(M, block_kn, n_blocks_n, n_active, x.dtype)
    return block_sparse_launch(x, w_blocks, meta, offsets, block_kn,
                               n_blocks_n, p.splits)


def block_sparse_launch(x, w_blocks, meta, offsets, block_kn,
                        n_blocks_n: int, splits: int) -> torch.Tensor:
    """Launch the kernel with ``splits`` on checked operands; the tests
    give splits other than ``plan``'s here."""
    M, K = x.shape
    bk, bn = block_kn
    out = torch.empty((M, n_blocks_n * bn), dtype=x.dtype, device=x.device)
    if M == 0 or out.numel() == 0:
        return out
    vec = copy_width(x.element_size(), (K, bk, bn),
                     (x.data_ptr(), w_blocks.data_ptr()))
    KERNEL.launch(ptr(x), ptr(w_blocks), ptr(meta), ptr(offsets), ptr(out),
                  M, K, bk, bn, n_blocks_n, int(x.dtype == torch.bfloat16),
                  splits, vec)
    return out
