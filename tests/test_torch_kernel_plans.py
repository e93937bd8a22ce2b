"""The rules by which the port's CUDA wrappers pick a kernel variant and
its grid, on the CPU: ``flash_attention.variant`` (tensor-core ``mma``
or CUDA-core ``fma``), ``sparse_matvec.plan`` (``rows`` or ``split``
and the split of K over the grid), ``conv_implicit.plan`` (the copy
widths, tiles and split of K of both conv kernels), ``cfmm_matmul.plan``
(``rows`` or ``split`` and the split of K over a cluster) and
``block_sparse.plan`` (``mma`` or ``fma`` and the split of a column's
active blocks).  The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py); here the split-K decompositions the
kernels use — each split's start in the packed values found by a
popcount of the bitmap bytes before it, chunks expanded with the running
nonzero count, partial products added — are replayed with the plain
expansion and held to ``ref.sparse_matvec_ref``, ``ref.conv2d_int8_ref``
and ``ref.conv2d_sparse_int8_ref`` bit for bit; so are the cfmm splits'
int32 partials (to ``ref.int8_matmul_ref``, the scale applied once to
the sum), the conv epilogue's per-image ``amax`` over output tiles that
cross images, and the block-sparse splits' f32 partials added in their
fixed order (to ``ref.block_sparse_matmul_plain`` within the kernel
tests' tolerance, the same bits on every replay).  Last, the ``int8``
mode's linear goes through ``ops.cfmm_matmul`` and still equals the JAX
package's ``apply_linear``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiled_linear as jcl
from repro_torch import nn
from repro_torch.core import compiled_linear as tcl
from repro_torch.core.compiled_linear import _compile_leaf_2d, bitmap_pack
from repro_torch.kernels import (block_sparse, cfmm_matmul, conv_depthwise,
                                 conv_implicit, flash_attention, ops, ref,
                                 sparse_matvec)
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


# ---------------------------------------------------------------------------
# conv_implicit.plan: the launch of both conv kernels (csrc/conv_mma.cuh)
# ---------------------------------------------------------------------------

def _served_convs(model):
    """(N, h_out, w_out, C, k, n_out) of every conv of a served model at
    224 px and microbatch 2, from its graph."""
    if model == "resnet50":
        from repro_torch.configs.resnet50_compiled import CONFIG
    elif model == "mobilenet_v2":
        from repro_torch.configs.mobilenet_v2_compiled import CONFIG
    else:
        from repro_torch.configs.repvgg_a0_compiled import CONFIG
    g = CONFIG.graph()
    info = g.shapes()
    assert g.in_hw == 224
    return sorted({(2, info[n.name].hw, info[n.name].hw, n.c_in, n.k,
                    n.c_out) for n in g.nodes if n.op == "conv"})


def _n_chunks(C, k, sparse):
    rows = k * k * C
    rows = -(-rows // 8) * 8 if sparse else rows
    return -(-rows // conv_implicit.K_CHUNK)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("model", ["resnet50", "mobilenet_v2", "repvgg_a0"])
def test_conv_plan_at_served_shapes(model, sparse):
    """At every served conv shape the plan covers K exactly (no empty
    split; at most one cluster of splits), fills at least one wave of
    the SMs or has one chunk per split, copies as wide as C and n_out
    allow, and tiles M and N."""
    shapes = _served_convs(model)
    assert len(shapes) >= 7
    for N, h, w, C, k, n_out in shapes:
        p = conv_implicit.plan(N, h, w, C, k, n_out, sparse=sparse)
        n_chunks = _n_chunks(C, k, sparse)
        assert 1 <= p.splits <= conv_implicit.MAX_SPLITS
        assert p.chunks_per >= 1
        assert (p.splits - 1) * p.chunks_per < n_chunks
        # even: the fewest chunks per split that this many splits allow
        assert p.chunks_per == -(-n_chunks // p.splits)
        assert n_chunks <= p.splits * p.chunks_per
        tiles = p.m_tiles * p.n_tiles
        assert tiles * p.splits >= conv_implicit.SMS or p.chunks_per == 1
        assert (p.m_tiles - 1) * 64 < N * h * w <= p.m_tiles * 64
        assert (p.n_tiles - 1) * 64 < n_out <= p.n_tiles * 64
        assert C % p.vec == 0 and n_out % p.bvec == 0
        assert p.vec == (16 if C % 16 == 0 else 4 if C % 4 == 0 else 1)
        assert p.bvec == (16 if n_out % 16 == 0 else
                          4 if n_out % 4 == 0 else 1)


# (N, h_out, w_out, C, k, n_out), sparse -> (vec, bvec, m_tiles, n_tiles,
# splits, chunks_per) at chip_smoke.py's conv shapes: dense splits
# for one wave, sparse for two where each split keeps 3 chunks
CONV_PLANS = [
    ((2, 112, 112, 3, 7, 64), False, (1, 16, 392, 1, 1, 3)),   # stem
    ((2, 56, 56, 64, 3, 64), False, (16, 16, 98, 1, 3, 3)),    # conv2_x_2/b
    ((2, 56, 56, 64, 3, 64), True, (16, 16, 98, 1, 3, 3)),
    ((2, 28, 28, 256, 1, 128), False, (16, 16, 25, 2, 4, 1)),  # conv3_x_1/a
    ((2, 14, 14, 256, 3, 256), False, (16, 16, 7, 4, 6, 6)),   # conv4_x_2/b
    ((2, 14, 14, 256, 3, 256), True, (16, 16, 7, 4, 12, 3)),
    ((2, 7, 7, 512, 1, 2048), False, (16, 16, 2, 32, 4, 2)),   # conv5_x_1/c
    ((2, 7, 7, 512, 1, 2048), True, (16, 16, 2, 32, 4, 2)),
    ((2, 112, 112, 3, 3, 32), False, (1, 16, 392, 1, 1, 1)),   # mbv2 stem
    ((2, 14, 14, 576, 1, 96), False, (16, 16, 7, 2, 9, 1)),    # block14/pj
    ((2, 7, 7, 192, 3, 1280), False, (16, 16, 2, 20, 5, 6)),   # repvgg 5_1
    ((2, 7, 7, 512, 3, 512), False, (16, 16, 2, 8, 9, 8)),     # conv5_x_2/b
    ((2, 7, 7, 512, 3, 512), True, (16, 16, 2, 8, 15, 5)),
    ((2, 14, 14, 1024, 1, 256), False, (16, 16, 7, 4, 6, 3)),  # conv4_x_2/a
    ((2, 56, 56, 24, 1, 144), False, (4, 16, 98, 3, 1, 1)),    # mbv2 C = 24
]


@pytest.mark.parametrize("shape,sparse,want", CONV_PLANS)
def test_conv_plan_at_chip_smoke_shapes(shape, sparse, want):
    assert tuple(conv_implicit.plan(*shape, sparse=sparse)) == want


def _im2col(x, k, stride):
    """(N*h*w, k*k*C) int8 im2col of the SAME-padded NHWC input,
    spatial-major (row = tap*C + c): the kernel's A operand."""
    xp, h_out, w_out = ref.pad_same_nhwc(x, k, stride)
    cols = [xp[:, dy:dy + (h_out - 1) * stride + 1:stride,
               dx:dx + (w_out - 1) * stride + 1:stride, :]
            for dy in range(k) for dx in range(k)]
    return torch.cat(cols, dim=-1).reshape(-1, k * k * x.shape[3])


SWAR_ROWS = 8192        # bitmap rows per pass of the 16-byte prefix path


def _swar_counts(rows8):
    """Per-column nonzero bits of bitmap rows (R, 16 q) as the kernel's
    16-byte prefix path counts them: per-byte popcounts of each word
    (SWAR), added in 16-bit lanes (bytes 0 and 2, 1 and 3) of uint32
    words by each of the 4 warps (row r to warp r % 32 // 8) over a pass
    of ``SWAR_ROWS`` rows, each pass's lanes then added into int32."""
    R, n = rows8.shape
    w = rows8.numpy().astype(np.uint32).reshape(R, n // 4, 4)
    w = w[..., 0] | w[..., 1] << 8 | w[..., 2] << 16 | w[..., 3] << 24
    x = w - ((w >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    warp = np.arange(R) % 32 // 8
    total = np.zeros((n // 4, 4), dtype=np.int64)
    for r0 in range(0, R, SWAR_ROWS):
        for wp in range(4):
            xs = x[r0:r0 + SWAR_ROWS][warp[r0:r0 + SWAR_ROWS] == wp]
            ev = (xs & 0x00FF00FF).sum(0, dtype=np.uint64) & 0xFFFFFFFF
            od = ((xs >> 8) & 0x00FF00FF).sum(0, dtype=np.uint64) & 0xFFFFFFFF
            total += np.stack([ev & 0xFFFF, od & 0xFFFF, ev >> 16, od >> 16],
                              -1).astype(np.int64)
    return torch.from_numpy(total.reshape(1, -1).astype(np.int32))


def _conv_split_k_replay(x, k, stride, cplan, w_sp=None, bitmap=None,
                         values=None):
    """The conv kernels' decomposition with the plain expansion: the
    im2col rows, K in chunks of 64 split into ``cplan.splits`` ranges of
    ``cplan.chunks_per``; sparse, each split's start counts from a
    popcount of the bitmap rows before it (the 16-byte path's SWAR count
    where n_out % 16 == 0), each chunk expanded with the running count;
    the splits' int32 partials added.  Returns NHWC int32."""
    N, H, W, C = x.shape
    a = _im2col(x, k, stride).double()
    K = a.shape[1]
    kc = conv_implicit.K_CHUNK
    sparse = bitmap is not None
    n_out = bitmap.shape[1] if sparse else w_sp.shape[1]
    n_chunks = _n_chunks(C, k, sparse)
    a = torch.nn.functional.pad(a, (0, n_chunks * kc - K))
    out = torch.zeros((a.shape[0], n_out), dtype=torch.int64)
    for s in range(cplan.splits):
        c_lo = s * cplan.chunks_per
        c_hi = min(c_lo + cplan.chunks_per, n_chunks)
        assert c_lo < c_hi
        if sparse:
            before = bitmap[:c_lo * kc // 8]
            if n_out % 16 == 0:
                base = _swar_counts(before)
            else:
                bits = sum(((before.int() >> j) & 1) for j in range(8))
                base = bits.sum(0, keepdim=True, dtype=torch.int32)
        part = torch.zeros_like(out)
        for c in range(c_lo, c_hi):
            if sparse:
                w, base = expand_bitmap_tile(
                    bitmap[c * kc // 8:(c + 1) * kc // 8], values, base,
                    values.shape[0])
            else:
                w = w_sp[c * kc:(c + 1) * kc]
            part += (a[:, c * kc:c * kc + w.shape[0]] @ w.double()).long()
        out += part
    _, _, h_out, w_out = conv_implicit.conv_geometry(x, k, stride)
    return out.to(torch.int32).reshape(N, h_out, w_out, n_out)


def _conv_case(N, hw, C, n_out, k, stride, seed=0, keep_k=None):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (N, hw, hw, C), generator=g,
                      dtype=torch.int8)
    w = torch.randn((C * k * k, n_out), generator=g)
    dense = _compile_leaf_2d(w, "int8", 0.8, conv_k=k)["values"]
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8, conv_k=k)
    bm, vals = packed["bitmap"], packed["values"]
    if keep_k is not None:               # more nonzeros than keep_k
        codes = ref.to_spatial_major(torch.randint(
            -63, 64, (C * k * k, n_out), generator=g, dtype=torch.int8),
            k, C)
        codes = torch.nn.functional.pad(codes, (0, 0, 0, (-len(codes)) % 8))
        bm, vals = bitmap_pack(codes, keep_k)
    return x, dense, bm, vals


# (N, input hw, C, n_out, k, stride): the C = 3 byte gather, C = 8
# (4-byte copies, n_out % 16 != 0), C % 16 == 0 with N = 3, N = 1 and a
# ragged n_out (byte loads of B), a K deep enough for 72 chunks
REPLAY_SHAPES = [(2, 17, 3, 16, 7, 2), (2, 9, 8, 72, 3, 1),
                 (3, 8, 32, 64, 3, 2), (1, 7, 16, 130, 1, 1),
                 (3, 9, 48, 40, 3, 1), (2, 3, 512, 24, 3, 1)]


def _plans(x, k, stride, n_out, sparse):
    """The shape's plan, no split, one chunk per split, and three
    splits."""
    N, _, _, C = x.shape
    _, _, h, w = conv_implicit.conv_geometry(x, k, stride)
    p = conv_implicit.plan(N, h, w, C, k, n_out, sparse=sparse)
    n = _n_chunks(C, k, sparse)
    per3 = -(-n // 3)
    return {p, p._replace(splits=1, chunks_per=n),
            p._replace(splits=n, chunks_per=1),
            p._replace(splits=-(-n // per3), chunks_per=per3)}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("N,hw,C,n_out,k,stride", REPLAY_SHAPES)
def test_conv_split_k_replay_matches_plain(N, hw, C, n_out, k, stride,
                                          sparse):
    x, dense, bm, vals = _conv_case(N, hw, C, n_out, k, stride,
                                    seed=N + hw + C + n_out)
    if sparse:
        want = ref.conv2d_sparse_int8_ref(x, bm, vals, k, stride)
        kw = dict(bitmap=bm, values=vals)
    else:
        want = ref.conv2d_int8_ref(x, dense, k, stride)
        kw = dict(w_sp=dense)
    for p in _plans(x, k, stride, n_out, sparse):
        got = _conv_split_k_replay(x, k, stride, p, **kw)
        assert torch.equal(got, want), p


@pytest.mark.parametrize("n_out", [20, 64])
def test_conv_split_k_replay_keeps_the_keep_k_clamp(n_out):
    """Columns with more nonzeros than keep_k: every split starts from
    the column's full count (byte and 16-byte prefix paths) and clamps
    to the last value, as one pass does."""
    x, _, bm, vals = _conv_case(2, 5, 64, n_out, 3, 1, seed=5, keep_k=40)
    assert int(sum(((bm.int() >> j) & 1) for j in range(8)).sum(0).max()) > 40
    want = ref.conv2d_sparse_int8_ref(x, bm, vals, 3, 1)
    for p in _plans(x, 3, 1, n_out, True):
        got = _conv_split_k_replay(x, 3, 1, p, bitmap=bm, values=vals)
        assert torch.equal(got, want), p


def test_swar_prefix_counts_hold_to_the_lane_limit():
    """The 16-bit lanes of the 16-byte prefix path hold 8 bits a byte
    over any number of bitmap rows: a warp's lane sums at most 2048 rows
    of a pass (16384), where one lane over 40000 full rows would wrap
    (80000 a warp)."""
    g = torch.Generator().manual_seed(0)
    rand = torch.randint(0, 256, (40000, 32), generator=g, dtype=torch.uint8)
    full = torch.full((40000, 32), 255, dtype=torch.uint8)
    for rows in (rand, full, full[:SWAR_ROWS], rand[:3]):
        want = sum(((rows.int() >> j) & 1) for j in range(8)).sum(0)
        assert torch.equal(_swar_counts(rows)[0], want.int())


def _tile_collector(acc, eff_scale, eff_bias, shortcut, relu, block_m):
    """The kernel's epilogue by output tiles of ``block_m`` rows over all
    N*h*w pixels: each row's image picks its eff_scale (and int8
    shortcut scale); per tile, each row's max|y|, then a max over each
    image's run of rows, folded into that image's amax."""
    N, h, w, n_out = acc.shape
    M, m_img = N * h * w, h * w
    flat = acc.reshape(M, n_out)
    img = torch.arange(M) // m_img
    y = ref.fma_f32(flat.float(), eff_scale[img], eff_bias)
    if isinstance(shortcut, tuple):
        q, s = shortcut
        y = ref.fma_f32(q.reshape(M, n_out).float(), s[img][:, None], y)
    elif shortcut is not None:
        y = y + shortcut.reshape(M, n_out)
    if relu:
        y = torch.clamp_min(y, 0.0)
    amax = torch.zeros(N)
    for m0 in range(0, M, block_m):
        rows = torch.arange(m0, min(m0 + block_m, M))
        row_max = y[rows].abs().amax(1)
        for i in img[rows].unique():
            amax[i] = torch.maximum(amax[i], row_max[img[rows] == i].max())
    return y.reshape(N, h, w, n_out), amax


@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("N,hw", [(3, 7), (2, 9), (1, 5), (5, 3)])
def test_conv_tiles_across_images_keep_per_image_amax(N, hw, sc_kind, relu):
    """Tiles of 64 rows that cross image boundaries (7x7 = 49 rows per
    image; 3x3 = 9, so one tile holds five images): ``y`` and the
    per-image ``amax`` equal the plain Collector's, bit for bit."""
    g = torch.Generator().manual_seed(N * hw)
    n_out = 24
    acc = torch.randint(-20000, 20000, (N, hw, hw, n_out), generator=g,
                        dtype=torch.int32)
    eff = 1e-3 * torch.rand((N, n_out), generator=g)
    bias = 0.1 * torch.randn((n_out,), generator=g)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, hw, hw, n_out), generator=g)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, hw, hw, n_out), generator=g,
                            dtype=torch.int8), torch.rand((N,), generator=g))
    y_p, amax_p = conv_implicit.plain_collector(acc, eff, bias, sc, relu,
                                                False)
    y, amax = _tile_collector(acc, eff, bias, sc, relu,
                              conv_implicit.BLOCK_M)
    assert torch.equal(y, y_p)
    assert torch.equal(amax, amax_p)


def _zero_count_replay(y, g, leaders=1):
    """The conv epilogue's ``profile_g`` zero counts (csrc/conv_mma.cuh,
    PROFILE) replayed by block, warp, lane and row: 64 x 64 tiles over
    all N*h*w rows; under split K the ``leaders`` blocks each count the
    row groups (m16 tile, half) that are theirs; a thread holds 8
    consecutive channels of a row, groups of g <= 8 counted inside it,
    g = 16 and 32 over 2 and 4 lanes of a quad (the all-zero test), g =
    64 from the row's zeros summed over both column warps; each row
    counts into its image's shared slot (past 4 images straight into
    zg / za), then the slots add to zg / za.  (A tile in one image sums
    in registers first: the same sums into slot 0.)"""
    N, h, w, n_out = y.shape
    M, m_img, G = N * h * w, h * w, n_out // g
    Y = y.reshape(M, n_out).numpy()
    zg = np.zeros((N, G), np.int64)
    za = np.zeros((N, G), np.int64)
    SLOTS, BM, BN = 4, 64, 64
    for m0 in range(0, M, BM):
        img_lo = m0 // m_img
        img_hi = (min(m0 + BM, M) - 1) // m_img
        for n0 in range(0, n_out, BN):
            for rank in range(leaders):
                zg_s = np.zeros((SLOTS, BN), np.int64)
                za_s = np.zeros((SLOTS, BN), np.int64)
                zrow = np.zeros(BM, np.int64)

                def add(img, grp, zc, ac):
                    if img - img_lo < SLOTS:
                        zg_s[img - img_lo, grp] += zc
                        za_s[img - img_lo, grp] += ac
                    else:
                        zg[img, n0 // g + grp] += zc
                        za[img, n0 // g + grp] += ac
                for wm, wn, mt, hf, g4 in itertools.product(
                        range(2), range(2), range(2), range(2), range(8)):
                    r = 32 * wm + 16 * mt + 8 * hf + g4
                    m = m0 + r
                    if (2 * mt + hf) % leaders != rank or m >= M:
                        continue
                    img = m // m_img
                    zms = [[n0 + 32 * wn + 8 * c4 + e < n_out
                            and Y[m, n0 + 32 * wn + 8 * c4 + e] == 0.0
                            for e in range(8)] for c4 in range(4)]
                    for c4, zm in enumerate(zms):
                        base = 32 * wn + 8 * c4
                        if g <= 8:
                            for u in range(8 // g):
                                bits = zm[u * g:(u + 1) * g]
                                add(img, (base + u * g) // g, sum(bits),
                                    int(all(bits)))
                            continue
                        span = min(g // 8, 4)        # lanes of the group
                        quad = zms[c4 - c4 % span:c4 - c4 % span + span]
                        whole = all(all(z) for z in quad)
                        if g == BN and c4 == 0:
                            zrow[r] += sum(sum(z) for z in zms)
                        add(img, base // g, sum(zm),
                            int(whole and g < BN and base % g == 0))
                if g == BN:
                    for r in np.nonzero(zrow == BN)[0]:
                        add((m0 + r) // m_img, 0, 0, 1)
                for sl in range(min(SLOTS, img_hi - img_lo + 1)):
                    for j in range(BN // g):
                        if n0 // g + j < G:
                            zg[img_lo + sl, n0 // g + j] += zg_s[sl, j]
                            za[img_lo + sl, n0 // g + j] += za_s[sl, j]
    return torch.from_numpy(zg), torch.from_numpy(za)


REPLAY_ZC_SHAPES = [
    (3, 7, 128, 1),       # 49 rows an image: tiles cross images
    (40, 2, 64, 1),       # 4 rows an image: past the 4 shared slots
    (2, 9, 96, 3),        # split K's leaders, groups past n_out
    (1, 12, 192, 4),      # one image per tile, four leaders
]


@pytest.mark.parametrize("g,N,hw,n_out,leaders", [
    (g, *shape) for shape in REPLAY_ZC_SHAPES
    for g in (1, 2, 4, 8, 16, 32, 64) if shape[2] % g == 0])
def test_zero_count_replay_matches_plain(g, N, hw, n_out, leaders):
    """The epilogue's partition of the zero counts over blocks, leaders,
    lanes, groups and image slots adds up to ``ref.zero_counts_ref``'s
    dict exactly, every key."""
    gen = torch.Generator().manual_seed(N + g + n_out)
    y = torch.clamp_min(torch.randn((N, hw, hw, n_out), generator=gen), 0)
    n = torch.arange(n_out)
    y[..., ((n // 64) % 2 == 1) | ((n // 8) % 3 == 0)] = 0.0
    y[:, 0] = 0.0                      # whole zero rows: every g has cells
    zc = conv_implicit.zero_count_dict(*_zero_count_replay(y, g, leaders),
                                       hw, hw, n_out)
    want = ref.zero_counts_ref(y, g)
    for key in want:
        assert torch.equal(zc[key], want[key]), key
    assert float(want["group_allzero"].sum()) > 0


@pytest.mark.parametrize("model", ["resnet50", "mobilenet_v2", "repvgg_a0"])
def test_zero_counts_in_the_epilogue_at_served_shapes(model):
    """At every served conv the profiler's groups of 8 (the fleet's)
    are counted in the conv kernels' epilogue: n_out is a multiple of 8;
    groups wider than the tile, not powers of two, or ragged are
    recounted on y."""
    for *_, n_out in _served_convs(model):
        assert conv_implicit.counts_in_kernel(n_out, 8), n_out
    assert not conv_implicit.counts_in_kernel(256, 128)
    assert not conv_implicit.counts_in_kernel(96, 48)
    assert not conv_implicit.counts_in_kernel(60, 8)
    assert [g for g in range(1, 65)
            if conv_implicit.counts_in_kernel(192, g)] == [1, 2, 4, 8, 16,
                                                           32, 64]


# ---------------------------------------------------------------------------
# conv_depthwise.plan: the depthwise kernel's tiles
# ---------------------------------------------------------------------------

# chip_smoke.py's DW_SHAPES (C, input hw, stride), k = 3, N = 2 -> (cb,
# rows, cw, vec, threads, n_slices, n_bands, smem): two waves of the SMs
# in slices of 32 or more where the shape allows, else one (32@112/s1,
# 192@28/s2, 576@14/s2); 144 channels take slices of 16, their widest
DW_PLANS = [
    ((32, 112, 1), (32, 1, 8, 16, 256, 1, 112, 11232)),
    ((96, 112, 2), (32, 1, 12, 16, 128, 3, 56, 16560)),
    ((144, 56, 1), (16, 3, 4, 16, 256, 9, 19, 4784)),
    ((144, 56, 2), (16, 1, 4, 16, 128, 9, 28, 2880)),
    ((192, 28, 1), (32, 1, 8, 16, 128, 6, 28, 3168)),
    ((192, 28, 2), (32, 1, 12, 16, 128, 6, 14, 4464)),
    ((384, 14, 1), (32, 1, 8, 16, 128, 12, 14, 1824)),
    ((576, 14, 1), (32, 1, 8, 16, 128, 18, 14, 1824)),
    ((576, 14, 2), (32, 2, 12, 16, 128, 18, 4, 3888)),
    ((960, 7, 1), (32, 1, 8, 16, 64, 30, 7, 1152)),
]


@pytest.mark.parametrize("shape,want", DW_PLANS)
def test_dw_plan_at_chip_smoke_shapes(shape, want):
    C, hw, stride = shape
    assert tuple(conv_depthwise.plan(2, hw, hw, C, 3, stride)) == want


def _served_dwconvs():
    """(N, H, W, C, k, stride) of every depthwise conv of MobileNetV2 at
    224 px and microbatch 2, from its graph."""
    from repro_torch.configs.mobilenet_v2_compiled import CONFIG
    g = CONFIG.graph()
    info = g.shapes()
    assert g.in_hw == 224
    return sorted({(2, info[n.inputs[0]].hw, info[n.inputs[0]].hw, n.c_in,
                    n.k, n.stride) for n in g.nodes if n.op == "dwconv"})


# the shapes of the depthwise tests (here and on the card), other batch
# sizes, widths and k
DW_TEST_SHAPES = [
    (2, 9, 9, 8, 3, 1), (2, 9, 9, 24, 3, 2), (2, 9, 9, 40, 3, 1),
    (1, 9, 7, 16, 3, 2), (3, 7, 11, 960, 3, 2), (3, 13, 9, 3, 3, 1),
    (1, 5, 15, 13, 5, 2), (2, 11, 11, 16, 5, 1), (3, 9, 9, 24, 5, 2),
    (3, 10, 10, 13, 3, 1), (2, 8, 8, 40, 3, 2), (1, 224, 224, 32, 3, 1),
    (8, 112, 112, 96, 3, 2), (32, 56, 56, 144, 3, 1), (1, 7, 7, 960, 7, 1),
    (1, 1, 1, 4, 3, 1), (64, 14, 14, 576, 3, 1), (2, 6, 6, 12, 3, 1),
]


def _check_dw_plan(N, H, W, C, k, s):
    """The bands and slices cover every output once; a power-of-two slice
    the copy width divides; 16-byte copies land 16-byte aligned; shared
    memory fits and is what the kernel computes; threads a whole number
    of warps and of channel groups; the grid fills two waves of the SMs
    unless no slice of ``WIDE_SLICE`` or more (or the widest) can at one
    row per band, and one wave unless even the narrowest slice cannot."""
    p = conv_depthwise.plan(N, H, W, C, k, s)
    _, _, h = ref.same_pads(H, k, s)
    _, _, w = ref.same_pads(W, k, s)
    assert (p.n_bands - 1) * p.rows < h <= p.n_bands * p.rows
    assert (p.n_slices - 1) * p.cb < C <= p.n_slices * p.cb
    assert p.cb in (4, 8, 16, 32, 64) and p.cb % p.vec == 0
    assert p.vec == conv_depthwise.copy_width(C)
    assert p.cw >= p.cb // 4
    if p.vec == 16:                     # column starts and chunks aligned
        assert (p.cw * 4) % 16 == 0 and p.cb % 16 == 0
    assert p.smem == conv_depthwise.smem_bytes(p.rows, w, k, s, p.cw, p.cb)
    assert p.smem <= conv_depthwise.MAX_SMEM
    assert p.threads % 32 == 0 and p.threads % (p.cb // 4) == 0
    jobs = p.rows * w * p.cb // 4
    assert p.threads == (256 if jobs > 512 else min(128, -(-jobs // 32) * 32))
    grid = N * p.n_bands * p.n_slices
    slices = conv_depthwise._slices(C, p.vec)
    wide = min(cb for cb in slices
               if cb >= min(conv_depthwise.WIDE_SLICE, slices[0]))
    sms = conv_depthwise.SMS
    if grid < 2 * sms:
        assert N * h * -(-C // wide) < 2 * sms
    if grid < sms:
        assert N * h * -(-C // slices[-1]) < sms
        assert (p.cb, p.rows) == (slices[-1], 1)
    return grid


@pytest.mark.parametrize("shape", DW_TEST_SHAPES + [
    (2, hw, hw, C, 3, s) for (C, hw, s), _ in DW_PLANS])
def test_dw_plan_covers_fits_and_fills_the_card(shape):
    _check_dw_plan(*shape)


def test_dw_plan_at_served_shapes():
    """MobileNetV2's 17 depthwise convs (10 shapes), each a wave or more
    of blocks."""
    shapes = _served_dwconvs()
    assert len(shapes) == 10
    for shape in shapes:
        assert _check_dw_plan(*shape) >= conv_depthwise.SMS


@pytest.mark.parametrize("vec", [16, 4, 1])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("n_cg", [1, 2, 4, 8, 16])
def test_dw_column_words_spread_the_banks(n_cg, stride, vec):
    """A warp's reads of consecutive pixels hit distinct banks at stride
    1 and at most two ways at stride 2, with 16-byte copies' columns a
    multiple of 16 bytes."""
    if vec == 16 and n_cg < 4:
        return                       # 16-byte copies need slices of 16
    cw = conv_depthwise.column_words(n_cg, stride, vec)
    assert n_cg <= cw < n_cg + 16 and (vec != 16 or cw % 4 == 0)
    banks = [(p * stride * cw + c) % 32 for p in range(32 // n_cg)
             for c in range(n_cg)]
    worst = max(banks.count(b) for b in banks)
    assert worst == 1 if stride == 1 else worst <= 2
    if stride == 2 and n_cg >= 8:
        assert worst == 1


def _dw_tile_replay(x, w_tap, eff, bias, sc, k, stride, relu, p, g):
    """The depthwise kernel's decomposition by plan ``p``, with plain
    arithmetic: per block (image, band, slice), the halo'd band of the
    zero-padded input (channels zero past C), its int32 tap-MACs, the
    Collector, the block's max|y| over its valid outputs and its zero
    counts per group of ``g``; then their reduction: the per-image max
    of the partials (the kernel's atomicMax per block), the counts
    summed."""
    N, H, W, C = x.shape
    xp, h, w = ref.pad_same_nhwc(x, k, stride)
    wp = (w - 1) * stride + k
    c_pad = p.n_slices * p.cb
    xp = torch.nn.functional.pad(xp, (0, c_pad - C)).int()
    w_pad = torch.nn.functional.pad(w_tap, (0, c_pad - C)).int()
    acc = torch.zeros((N, h, w, C), dtype=torch.int32)
    y = torch.zeros((N, h, w, C))
    part = torch.zeros((N, p.n_bands * p.n_slices))
    zg = torch.zeros((N, C // g), dtype=torch.int32)
    za = torch.zeros_like(zg)
    for img in range(N):
        for band in range(p.n_bands):
            r0 = band * p.rows
            R = min(p.rows, h - r0)
            for sl in range(p.n_slices):
                c0, cv = sl * p.cb, min(p.cb, C - sl * p.cb)
                tile = xp[img, r0 * stride:r0 * stride + (R - 1) * stride
                          + k, :wp, c0:c0 + p.cb]
                a = torch.zeros((R, w, p.cb), dtype=torch.int32)
                for dy in range(k):
                    for dx in range(k):
                        a += (tile[dy:dy + (R - 1) * stride + 1:stride,
                                   dx:dx + (w - 1) * stride + 1:stride]
                              * w_pad[dy * k + dx, c0:c0 + p.cb])
                a = a[None, :, :, :cv]
                at = (img, slice(r0, r0 + R), slice(None),
                      slice(c0, c0 + cv))
                if isinstance(sc, tuple):
                    sc_t = (sc[0][at][None], sc[1][img:img + 1])
                else:
                    sc_t = None if sc is None else sc[at][None]
                y_t = ref._collector(a, eff[img, c0:c0 + cv], bias[c0:c0 + cv],
                                     sc_t, relu)[0]
                acc[at], y[at] = a[0], y_t
                part[img, band * p.n_slices + sl] = y_t.abs().max()
                z = (y_t == 0).reshape(R, w, cv // g, g)
                grp = slice(c0 // g, c0 // g + cv // g)
                zg[img, grp] += z.sum(dim=(0, 1, 3)).int()
                za[img, grp] += z.all(dim=3).sum(dim=(0, 1)).int()
    return acc, y, part.amax(dim=1), zg, za


@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
@pytest.mark.parametrize("N,H,W,C,k,stride,rows,cb", [
    (2, 9, 7, 13, 3, 1, None, None),   # ragged C, odd W
    (3, 7, 9, 3, 3, 2, None, None),    # C = 3
    (1, 11, 11, 24, 5, 2, 2, 16),      # k = 5, ragged slice of 16
    (2, 14, 14, 40, 3, 1, 3, 8),       # ragged last band
    (2, 8, 13, 16, 3, 2, None, None),
    (2, 12, 12, 64, 3, 1, 5, 32),
])
def test_dw_tile_replay_matches_plain(N, H, W, C, k, stride, rows, cb,
                                      sc_kind):
    """The kernel's tiles, replayed: int32 accumulators, y, the per-image
    amax from the per-block partials and the zero counts from the
    per-block counts equal the plain version bit for bit."""
    g = torch.Generator().manual_seed(N * H * W + C)
    x = torch.randint(-127, 128, (N, H, W, C), generator=g, dtype=torch.int8)
    w_tap = torch.randint(-63, 64, (k * k, C), generator=g, dtype=torch.int8)
    eff = 1e-3 * torch.rand((N, C), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g) - 0.05
    _, _, h = ref.same_pads(H, k, stride)
    _, _, w = ref.same_pads(W, k, stride)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, h, w, C), generator=g)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, h, w, C), generator=g,
                            dtype=torch.int8), torch.rand((N,), generator=g))
    p = conv_depthwise.plan(N, H, W, C, k, stride)
    if rows is not None:
        p = p._replace(rows=rows, n_bands=-(-h // rows), cb=cb,
                       n_slices=-(-C // cb))
    gs = 1 if C % 2 else (4 if p.cb % 4 == 0 and C % 4 == 0 else 2)
    acc, y, amax, zg, za = _dw_tile_replay(x, w_tap, eff, bias, sc, k,
                                           stride, True, p, gs)
    y_p, amax_p, acc_p, zc_p = conv_depthwise.conv2d_dw_plain(
        x, w_tap, eff, bias, sc, k=k, stride=stride, relu=True,
        return_acc=True, profile_g=gs)
    assert torch.equal(acc, acc_p) and torch.equal(y, y_p)
    assert torch.equal(amax, amax_p)
    zc = conv_depthwise.zero_count_dict(zg, za, h, w, C)
    assert zc.keys() == zc_p.keys()
    for key in zc:
        assert torch.equal(zc[key], zc_p[key]), key
    assert float(zc["group_allzero"].sum()) > 0


# ---------------------------------------------------------------------------
# cfmm_matmul.plan: the int8 GEMM of the int8 and cfmm modes
# ---------------------------------------------------------------------------

# (M, K, N) -> (variant, m_tiles, n_tiles, splits, chunks_per) at
# chip_smoke.py's shapes (the CNN heads; SmolLM-360M's linears at 4
# decode slots and 64- and 1024-token prefills) and the cuda tests'
# ragged ones
CFMM_PLANS = [
    ((2, 2048, 1000), ("split", 1, 16, 16, 1)),
    ((2, 1280, 1000), ("split", 1, 16, 10, 1)),
    ((128, 2048, 1000), ("rows", 2, 16, 6, 6)),
    ((4, 960, 2560), ("split", 1, 40, 8, 1)),
    ((4, 2560, 960), ("split", 1, 15, 10, 2)),
    ((4, 960, 960), ("split", 1, 15, 8, 1)),
    ((4, 960, 320), ("split", 1, 5, 8, 1)),
    ((64, 960, 2560), ("rows", 1, 40, 5, 3)),
    ((1024, 960, 960), ("rows", 16, 15, 1, 15)),
    ((1024, 960, 320), ("rows", 16, 5, 3, 5)),
    ((1024, 960, 2560), ("rows", 16, 40, 1, 15)),
    ((1024, 2560, 960), ("rows", 16, 15, 1, 40)),
    ((3, 7, 5), ("split", 1, 1, 1, 1)),
    ((9, 130, 33), ("split", 1, 1, 2, 1)),
    ((1, 64, 10), ("split", 1, 1, 1, 1)),
    ((17, 512, 256), ("rows", 1, 4, 8, 1)),
]


@pytest.mark.parametrize("shape,want", CFMM_PLANS)
def test_cfmm_plan_at_chip_smoke_shapes(shape, want):
    assert tuple(cfmm_matmul.plan(*shape)) == want


@pytest.mark.parametrize("M", [1, 2, 4, 16, 17, 64, 128, 1000, 1024])
@pytest.mark.parametrize("K,N", [(960, 2560), (2560, 960), (960, 320),
                                 (2048, 1000), (7, 5), (130, 33)])
def test_cfmm_plan_covers_k_and_fills_the_card(M, K, N):
    """Every chunk belongs to exactly one split, spread evenly; no split
    is empty; the variant follows M; the tiles cover M and N; a split
    happens only where the tiles fill less than the variant's waves, and
    then fills them unless each split is down to one chunk or the
    cluster is full."""
    p = cfmm_matmul.plan(M, K, N)
    tm, bk = cfmm_matmul.TILE[p.variant]
    n_chunks = -(-K // bk)
    assert p.variant == ("split" if M <= 16 else "rows")
    assert 1 <= p.splits <= cfmm_matmul.MAX_SPLITS and p.chunks_per >= 1
    assert (p.splits - 1) * p.chunks_per < n_chunks <= p.splits * p.chunks_per
    assert p.chunks_per == -(-n_chunks // p.splits)
    assert (p.m_tiles - 1) * tm < M <= p.m_tiles * tm
    assert (p.n_tiles - 1) * 64 < N <= p.n_tiles * 64
    tiles = p.m_tiles * p.n_tiles
    target = cfmm_matmul.WAVES[p.variant] * cfmm_matmul.SMS
    if tiles >= target:
        assert p.splits == 1
    else:
        assert (tiles * p.splits >= target or p.chunks_per == 1
                or n_chunks > cfmm_matmul.MAX_SPLITS)


def _cfmm_split_replay(x, codes, p, order):
    """The kernel's decomposition of K: split s walks chunks [s *
    chunks_per, (s + 1) * chunks_per); in the split variant warp w takes
    the k32 step w of every chunk.  Each part's int32 product, summed in
    ``order``."""
    tm, bk = cfmm_matmul.TILE[p.variant]
    K = x.shape[1]
    n_chunks = -(-K // bk)
    parts = []
    for s in range(p.splits):
        chunks = range(s * p.chunks_per, min((s + 1) * p.chunks_per,
                                             n_chunks))
        steps = range(4) if p.variant == "split" else [None]
        for w in steps:
            rows = [k for c in chunks for k in range(c * bk, min((c + 1) * bk, K))
                    if w is None or (k - c * bk) // 32 == w]
            idx = torch.tensor(rows, dtype=torch.long)
            parts.append(ref.int8_matmul_ref(x[:, idx], codes[idx]))
    acc = torch.zeros_like(parts[0])
    for i in order(len(parts)):
        acc += parts[i]
    return acc


@pytest.mark.parametrize("M,K,N,N_run", [
    (4, 960, 2560, 24), (4, 2560, 960, 24), (2, 2048, 1000, 40),
    (64, 960, 2560, 24), (1024, 960, 320, 8), (9, 130, 33, 33),
    (3, 7, 5, 5)])
def test_cfmm_split_k_replay_matches_plain(M, K, N, N_run):
    """Each split's int32 partials (and each warp's in the split variant),
    added in any order, equal the plain product; the scale, applied once
    to that sum, gives ``cfmm_matmul_plain``'s scaled output.  The plan
    is the served shape's; the product runs at N_run columns."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    codes = torch.randint(-63, 64, (K, N_run), generator=g, dtype=torch.int8)
    scale = 0.01 + torch.rand((N_run,), generator=g)
    p = cfmm_matmul.plan(M, K, N)
    want = ref.int8_matmul_ref(x, codes)
    for order in (lambda n: range(n), lambda n: reversed(range(n)),
                  lambda n: torch.randperm(n, generator=g).tolist()):
        acc = _cfmm_split_replay(x, codes, p, order)
        assert torch.equal(acc, want)
        assert torch.equal(acc.float() * scale,
                           cfmm_matmul.cfmm_matmul_plain(x, codes, scale))


# ---------------------------------------------------------------------------
# block_sparse.plan: the block-sparse matmul
# ---------------------------------------------------------------------------

# (M, K, N, block, kept blocks) -> (variant, m_tiles, n_tiles, splits) in
# bf16, at the cuda tests' and chip_smoke.py's shapes (ResNet50 1x1
# convs at microbatch 2, SmolLM-360M gate/up at 1024 tokens)
BS_PLANS = [
    ((64, 512, 256, (128, 128), 8), ("mma", 1, 4, 4)),
    ((8, 256, 128, (128, 128), 2), ("mma", 1, 2, 2)),
    ((98, 2048, 512, (64, 64), 256), ("mma", 2, 8, 9)),
    ((98, 2048, 512, (64, 64), 51), ("mma", 2, 8, 6)),
    ((1024, 960, 2560, (64, 64), 600), ("mma", 16, 40, 1)),
    ((37, 480, 400, (48, 80), 50), ("mma", 1, 10, 10)),
    ((130, 96, 72, (32, 24), 9), ("mma", 3, 3, 3)),
    ((1, 64, 64, (64, 64), 1), ("mma", 1, 1, 1)),
    ((392, 1024, 256, (64, 64), 64), ("mma", 7, 4, 5)),
    ((6272, 64, 256, (64, 64), 4), ("mma", 98, 4, 1)),
    ((1568, 128, 512, (64, 64), 16), ("mma", 25, 8, 1)),
    ((98, 256, 128, (64, 64), 7), ("mma", 2, 2, 3)),
]


@pytest.mark.parametrize("case,want", BS_PLANS)
def test_block_sparse_plan_at_test_and_chip_smoke_shapes(case, want):
    M, K, N, block, n_active = case
    p = block_sparse.plan(M, block, N // block[1], n_active, torch.bfloat16)
    assert tuple(p) == want
    assert block_sparse.plan(M, block, N // block[1], n_active,
                             torch.float32) == p._replace(variant="fma")


@pytest.mark.parametrize("M", [1, 37, 98, 130, 392, 1024, 6272])
@pytest.mark.parametrize("block,n_blocks_n,n_active", [
    ((64, 64), 8, 256), ((64, 64), 8, 3), ((64, 64), 4, 0),
    ((48, 80), 5, 50), ((128, 128), 2, 4), ((32, 24), 3, 9)])
def test_block_sparse_plan_fills_the_card(M, block, n_blocks_n, n_active):
    """Tiles cover M and every block column; a split only where the tiles
    fill at most half of the SMs, never more splits than the mean active
    blocks per column or the cluster allows, and then enough for a wave
    unless one of those caps it."""
    p = block_sparse.plan(M, block, n_blocks_n, n_active, torch.bfloat16)
    bn = block[1]
    assert (p.m_tiles - 1) * 64 < M <= p.m_tiles * 64
    assert p.n_tiles == n_blocks_n * -(-bn // 64)
    tiles = p.m_tiles * p.n_tiles
    assert 1 <= p.splits <= max(1, min(block_sparse.MAX_SPLITS,
                                       n_active // n_blocks_n))
    if 2 * tiles > block_sparse.SMS:
        assert p.splits == 1
    elif p.splits < min(block_sparse.MAX_SPLITS, n_active // n_blocks_n):
        assert tiles * p.splits >= block_sparse.SMS


@pytest.mark.parametrize("elt,lengths,want", [
    (2, (480, 48, 80), 16), (2, (96, 32, 24), 16), (2, (24, 12, 20), 4),
    (2, (28, 7, 5), 2), (4, (24, 12, 20), 16), (4, (28, 7, 5), 4)])
def test_block_sparse_copy_width(elt, lengths, want):
    """16-byte copies where K, bk and bn allow them (bf16: multiples of
    8), else 4-byte, else one element; an address off a 16-byte boundary
    takes at most 4 bytes."""
    assert block_sparse.copy_width(elt, lengths, (0, 256)) == want
    assert block_sparse.copy_width(elt, lengths, (0, 2 * elt)) == min(want, 4)


BS_RTOL, BS_ATOL = 1e-5, 1e-4        # as tests/test_torch_kernels_cuda.py


def _bs_split_replay(x, p, splits):
    """The kernel's decomposition: split z of a column with c active
    blocks takes blocks [c z / S, c (z + 1) / S); each block's f32
    product is added to the split's sum in ascending k, and the splits'
    sums are added in ascending z; rounded once to x's type."""
    M, _ = x.shape
    bk, bn = p.block_kn
    offs = p.offsets.tolist()
    kblock = p.meta[0].tolist()
    out = torch.zeros((M, p.n_blocks_n * bn))
    for nb in range(p.n_blocks_n):
        lo, cnt = offs[nb], offs[nb + 1] - offs[nb]
        col = None
        for z in range(splits):
            part = torch.zeros((M, bn))
            for b in range(lo + cnt * z // splits, lo + cnt * (z + 1) // splits):
                kb = kblock[b]
                part = part + x[:, kb * bk:(kb + 1) * bk].float() \
                    @ p.w_blocks[b].float()
            col = part if col is None else col + part
        out[:, nb * bn:(nb + 1) * bn] = col
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("keep", [1.0, 0.5, 0.2])
@pytest.mark.parametrize("M,K,N,block", [
    (98, 2048, 512, (64, 64)), (8, 256, 128, (128, 128)),
    (37, 480, 400, (48, 80)), (130, 96, 72, (32, 24))])
def test_block_sparse_split_replay_matches_plain(M, K, N, block, keep, dtype):
    """At the plan's split and at 1, 2 and 16 splits: within the kernel
    tests' tolerance of the plain version, and the same bits on a second
    replay."""
    bk, bn = block
    g = torch.Generator().manual_seed(M + K + N)
    w = torch.randn((K, N), generator=g)
    mask = torch.rand((K // bk, N // bn), generator=g) < keep
    if keep < 1.0:
        mask[:, 0] = False                   # an empty block column
    w *= mask.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    x = torch.randn((M, K), generator=g).to(dtype)
    p = block_sparse.pack_blocks(w, block, dtype, "cpu")
    want = ref.block_sparse_matmul_plain(x, p.w_blocks, p.meta, p.offsets,
                                         block, p.n_blocks_n)
    planned = block_sparse.plan(M, block, p.n_blocks_n, p.n_active, dtype)
    for splits in {planned.splits, 1, 2, 16}:
        got = _bs_split_replay(x, p, splits)
        assert torch.equal(got, _bs_split_replay(x, p, splits))
        err = (got.float() - want.float()).abs()
        tol = BS_ATOL + BS_RTOL * want.float().abs()
        if dtype == torch.bfloat16:
            tol = tol + want.float().abs() * 2.0 ** -7
        assert bool((err <= tol).all()), float(err.max())
        if keep < 1.0:
            assert bool((got[:, :bn] == 0).all())


# ---------------------------------------------------------------------------
# The int8 serve mode's linear runs the cfmm_matmul wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_apply_linear_runs_cfmm_matmul(monkeypatch, lead, per_row,
                                            stacked):
    """``apply_linear`` on an ``int8`` leaf calls ``ops.cfmm_matmul`` once,
    on the flattened rows and the leaf's ``values`` — for a stacked
    (layers, K, N) leaf, the layer's slice as it is, no copy — and its
    output equals the JAX package's jitted ``apply_linear`` (whose
    activation scale is ``amax * f32(1/127)``, as the port's) on the same
    leaf and inputs."""
    calls = []
    real = ops.cfmm_matmul

    def spy(x_q, codes, scale=None):
        calls.append((tuple(x_q.shape), codes.data_ptr(), scale))
        return real(x_q, codes, scale)

    monkeypatch.setattr(ops, "cfmm_matmul", spy)
    rng = np.random.RandomState(len(lead) + 2 * per_row + 4 * stacked)
    K, N = 40, 24
    w = torch.from_numpy(rng.randn(3, K, N).astype(np.float32) / 6)
    if stacked:                       # layer 1 of a compiled stacked leaf,
        leaf = tcl._compile_leaf(     # sliced as models/lm.py slices it
            nn.Param(w, ("layers", "embed", "mlp"), "linear"), "int8", 0.8)
        leaf = {k: p.value[1] for k, p in leaf.items()}
    else:
        leaf = _compile_leaf_2d(w[1], "int8", 0.8)
    x = rng.randn(*lead, K).astype(np.float32)
    y = tcl.apply_linear(leaf, torch.from_numpy(x), per_row=per_row)
    assert calls == [((int(np.prod(lead)), K), leaf["values"].data_ptr(),
                      None)]
    y_jax = jax.jit(jcl.apply_linear, static_argnames="per_row")(
        {k: jnp.asarray(v.numpy()) for k, v in leaf.items()},
        jnp.asarray(x), per_row=per_row)
    assert y.shape == lead + (N,)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_jax))
