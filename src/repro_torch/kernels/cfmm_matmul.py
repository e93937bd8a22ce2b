"""int8 GEMM of the ``int8`` and ``cfmm`` serve modes — CUDA kernel
wrapper (ports ``repro/kernels/cfmm_matmul.py``).

Replaces ``cfmm_matmul_pallas`` (repro/kernels/cfmm_matmul.py:44).  It is
the product of every compiled linear in ``int8`` and ``cfmm``
(core/compiled_linear.py ``apply_linear``; both modes store the same INT7
codes): every SmolLM-360M linear (M = the prefill bucket or the decode
slots; K, N in {960, 320, 2560}) and the CNN heads (M = microbatch rows,
K = 2048 or 1280, N = 1000).  It returns the **exact** int32 product;
with a scale it returns ``float(acc) * scale`` rounded once, as
``ref.cfmm_matmul_ref`` does.  (The TPU path with ``scale=None``
multiplies by ones in f32 and casts back, which loses bits once
|acc| >= 2**24; the port follows the exact jnp oracle instead.)

The kernel (``csrc/cfmm_matmul.cu``) runs on the int8 tensor cores
(``mma.sync.m16n8k32``): x and the row-major codes come through a
``cp.async`` ring of K chunks, and the B fragments are built from the
codes as they are stored, by 4 x 4 byte transposes.  ``plan`` picks the
variant (``rows``, 64 x 64 tiles, for M >= 17; ``split``, one m16 tile
of 64 columns, for M <= 16) and splits K over a thread-block cluster
where the tiles alone do not fill the card; the splits add their int32
partials in distributed shared memory before the scale.

What bounds it on an H100: at prefill widths the int32 output write; in
decode and at the heads the codes, read once, over 3.35 TB/s; its
2*M*K*N int8 operations (1,979 TOP/s) nowhere.

For a CPU tensor the wrapper runs the plain version (kernels/ref.py);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._cuda import I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("cfmm_matmul", "cfmm_matmul_launch",
                    (P,) * 5 + (I,) * 8 + (P,))
VARIANTS = {"rows": 0, "split": 1}
SMS = 132            # streaming multiprocessors of an H100 SXM
BLOCK_N = 64         # output columns per tile
SPLIT_MAX_M = 16     # the split variant's one m16 tile
TILE = {"rows": (64, 64), "split": (16, 128)}    # (rows per tile, K rows
                                                 # per chunk)
WAVES = {"rows": 1, "split": 2}   # waves of blocks over the SMs a split
                                  # aims for
MAX_SPLITS = 16      # a tile's splits form one thread-block cluster


class CfmmPlan(NamedTuple):
    """How one call launches: the grid is ``n_tiles`` (64 columns each)
    x ``m_tiles`` x ``splits``, split ``s`` walking K chunks
    ``[s * chunks_per, (s + 1) * chunks_per)``."""
    variant: str
    m_tiles: int
    n_tiles: int
    splits: int
    chunks_per: int


def plan(M: int, K: int, N: int) -> CfmmPlan:
    """The launch of one (M, K) @ (K, N) product: ``split`` for M <= 16
    (the decode slots, the CNN heads), else ``rows``.  Where the tiles
    fill less than ``WAVES`` waves of the 132 SMs (``rows``: one block
    per SM; ``split``: two, since the call is the codes' bytes and every
    block in flight adds to the reads in flight), K's chunks are spread
    evenly over at most ``MAX_SPLITS`` splits, as many as those waves
    need; no split is empty."""
    variant = "split" if M <= SPLIT_MAX_M else "rows"
    tm, bk = TILE[variant]
    m_tiles, n_tiles = -(-M // tm), -(-N // BLOCK_N)
    tiles = m_tiles * n_tiles
    n_chunks = -(-K // bk)
    target = WAVES[variant] * SMS
    splits = 1
    if tiles < target:
        want = min(MAX_SPLITS, -(-target // tiles))
        per = max(1, n_chunks // want)
        splits = min(MAX_SPLITS, -(-n_chunks // per))
    per = -(-n_chunks // splits)                # even: the same splits
    return CfmmPlan(variant, m_tiles, n_tiles, -(-n_chunks // per), per)


def copy_width(n: int, address: int) -> int:
    """Bytes per cp.async copy of rows of ``n`` bytes starting at
    ``address``: 16, 8 or 4 where both are multiples, else 1 (byte
    loads)."""
    return next((v for v in (16, 8, 4) if n % v == 0 and address % v == 0),
                1)


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
    s = None
    if scale is not None:
        s = scale.reshape(-1)
        check_cuda("scale", s, torch.float32, (N,))
    return cfmm_launch(x_q, codes, s, plan(M, K, N))


def cfmm_launch(x_q, codes, scale, p: CfmmPlan) -> torch.Tensor:
    """Launch the kernel under plan ``p`` on checked operands (``scale``
    (N,) or None); the tests give plans other than ``plan``'s here."""
    M, K = x_q.shape
    N = codes.shape[1]
    dtype = torch.int32 if scale is None else torch.float32
    out = torch.empty((M, N), dtype=dtype, device=x_q.device)
    if out.numel() == 0:
        return out
    KERNEL.launch(ptr(x_q), ptr(codes), ptr(scale),
                  ptr(out if scale is None else None),
                  ptr(None if scale is None else out), M, K, N,
                  VARIANTS[p.variant], p.splits, p.chunks_per,
                  copy_width(K, x_q.data_ptr()),
                  copy_width(N, codes.data_ptr()))
    return out
