"""The rules by which the port's CUDA wrappers pick a kernel variant and
its grid, on the CPU: ``flash_attention.variant`` (tensor-core ``mma``
or CUDA-core ``fma``) and ``sparse_matvec.plan`` (``rows`` or ``split``
and the split of K over the grid).  The kernels themselves run only on
the card (tests/test_torch_kernels_cuda.py); here the split-K
decomposition the sparse kernel uses — each split's start in the packed
values found by a popcount of the bitmap bytes before it, chunks of 128
rows expanded with the running nonzero count, partial products added —
is replayed with the plain expansion and held to
``ref.sparse_matvec_ref`` bit for bit.
"""
import pytest
import torch

from repro_torch.core.compiled_linear import _compile_leaf_2d, bitmap_pack
from repro_torch.kernels import flash_attention, ref, sparse_matvec
from repro_torch.kernels.bitmap import expand_bitmap_tile


@pytest.mark.parametrize("dtype,D,Dv,want", [
    (torch.bfloat16, 64, 64, "mma"),       # SmolLM-360M prefill
    (torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, 32, 16, "mma"),
    (torch.bfloat16, 128, 128, "mma"),
    (torch.bfloat16, 128, 64, "mma"),
    (torch.bfloat16, 192, 128, "fma"),     # MLA-like: D past 128
    (torch.bfloat16, 256, 256, "fma"),     # Gemma3-like
    (torch.bfloat16, 24, 40, "fma"),       # not multiples of 16
    (torch.bfloat16, 64, 72, "fma"),
    (torch.bfloat16, 48, 48, "fma"),       # no instance for 48
    (torch.float32, 64, 64, "fma"),        # f32 stays off TF32
    (torch.float32, 16, 16, "fma"),
])
def test_flash_variant_rule(dtype, D, Dv, want):
    assert flash_attention.variant(dtype, D, Dv) == want


# (M, K, N) -> (variant, splits, chunks_per) at the served shapes: the
# ResNet50 / MobileNetV2 heads, SmolLM-360M's linears at a 1024 and a 64
# token prefill and at 4 decode slots
SERVED_PLANS = [
    ((2, 2048, 1000), ("split", 16, 1)),
    ((2, 1280, 1000), ("split", 10, 1)),
    ((1024, 960, 960), ("rows", 4, 2)),
    ((1024, 960, 320), ("rows", 8, 1)),
    ((1024, 960, 2560), ("rows", 1, 8)),
    ((1024, 2560, 960), ("rows", 5, 4)),
    ((64, 960, 2560), ("rows", 4, 2)),
    ((4, 960, 2560), ("split", 4, 2)),
    ((4, 960, 960), ("split", 8, 1)),
    ((4, 2560, 960), ("split", 10, 2)),
]


@pytest.mark.parametrize("shape,want", SERVED_PLANS)
def test_sparse_matvec_plan_at_served_shapes(shape, want):
    assert sparse_matvec.plan(*shape) == want


@pytest.mark.parametrize("M", [1, 2, 4, 15, 16, 17, 64, 1000, 1024])
@pytest.mark.parametrize("K,N", [(960, 1000), (1288, 33), (8, 1),
                                 (2048, 1000), (2560, 960)])
def test_sparse_matvec_plan_covers_k_and_fills_the_card(M, K, N):
    """Every chunk belongs to exactly one split; no split is empty; the
    variant follows M; a split happens only where the tiles would fill
    at most half of the SMs, and then about two blocks per SM."""
    variant, splits, per = sparse_matvec.plan(M, K, N)
    n_chunks = -(-K // sparse_matvec.K_CHUNK)
    assert variant == ("split" if M <= 16 else "rows")
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < n_chunks <= splits * per
    m_tiles = 1 if M <= 16 else -(-M // sparse_matvec.ROWS_M)
    tiles = m_tiles * -(-N // sparse_matvec.BLOCK_N)
    if 2 * tiles > sparse_matvec.SMS:
        assert splits == 1
    else:
        assert splits == n_chunks or tiles * splits >= sparse_matvec.SMS


def _split_k_replay(x, bitmap, values, splits, per):
    """The kernel's decomposition with the plain expansion: per split, its
    start in each column's values from a popcount of the bitmap bytes
    before it; per 128-row chunk, the expansion carrying the count; the
    splits' int32 partial products added."""
    K = x.shape[1]
    keep_k = values.shape[0]
    kc8 = sparse_matvec.K_CHUNK // 8
    n_chunks = -(-K // sparse_matvec.K_CHUNK)
    bits = torch.stack([(bitmap >> j) & 1 for j in range(8)]).sum(0)
    out = torch.zeros((x.shape[0], bitmap.shape[1]), dtype=torch.int32)
    for s in range(splits):
        c_lo, c_hi = s * per, min((s + 1) * per, n_chunks)
        base = bits[:c_lo * kc8].sum(0, keepdim=True, dtype=torch.int32)
        for c in range(c_lo, c_hi):
            rows8 = slice(c * kc8, min((c + 1) * kc8, bitmap.shape[0]))
            w, base = expand_bitmap_tile(bitmap[rows8], values, base, keep_k)
            xk = x[:, rows8.start * 8:rows8.stop * 8]
            out += ref.int8_matmul_ref(xk, w)
    return out


@pytest.mark.parametrize("M,K,N", [(2, 2048, 40), (4, 1288, 33),
                                   (64, 960, 70), (17, 8, 5)])
def test_split_k_decomposition_matches_plain(M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    packed = _compile_leaf_2d(torch.randn((K, N), generator=g),
                              "sparse_cfmm", 0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    bm, vals = packed["bitmap"], packed["values"]
    want = ref.sparse_matvec_ref(x, bm, vals)
    _, splits, per = sparse_matvec.plan(M, K, N)
    n_chunks = -(-K // sparse_matvec.K_CHUNK)
    for s, p in {(splits, per), (1, n_chunks), (n_chunks, 1)}:
        assert torch.equal(_split_k_replay(x, bm, vals, s, p), want)


def test_split_k_decomposition_keeps_the_keep_k_clamp():
    """Columns with more nonzeros than keep_k: every split starts from
    the column's full count and clamps to the last value, as one pass
    does."""
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(-63, 64, (512, 20), generator=g, dtype=torch.int8)
    bm, vals = bitmap_pack(codes, 40)
    x = torch.randint(-127, 128, (3, 512), generator=g, dtype=torch.int8)
    want = ref.sparse_matvec_ref(x, bm, vals)
    for s, p in [(4, 1), (2, 2), (1, 4)]:
        assert torch.equal(_split_k_replay(x, bm, vals, s, p), want)
