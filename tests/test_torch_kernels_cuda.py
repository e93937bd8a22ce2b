"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without a CUDA device every test here skips.  On
a CUDA host run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which a CUDA host for
the port need not have.)

The geometry sweep mirrors the JAX package's kernel tests: k in {1, 3, 7}
x stride in {1, 2}, odd and even maps, channel counts that are and are
not tile multiples, every shortcut form; the conv kernels also at every
branch of their launch plan (``conv_implicit.plan``: 16-byte, 4-byte and
byte copies of the input and of the weights, N = 1 and 3, output tiles
across images and a ragged last tile, n_out off multiples of 8, K split
over the grid at full-width ResNet50 7x7 and 14x14 shapes, the sparse
split's popcount start past 8192 bitmap rows), and a split launch's
CUDA-graph replay equal to the eager call; their ``profile_g`` zero
counts equal to the plain version's dict at every group path of the
epilogue (g 1-8 in a thread, 16 and 32 over lanes, 64 over warps), in
tiles of one image, of several and of more than the shared slots hold,
under split K, at ragged n_out, and recounted on y where the group does
not fit the tile; the depthwise kernel at
MobileNetV2's channel counts and ragged ones, at every branch of its
plan (``conv_depthwise.plan``: copy width, channel slice, rows per band,
column pad, threads), k = 5, odd maps, N = 1 and 3 and an unaligned
view, its zero counts (``profile_g``) equal to the plain version's in
both routes, and CUDA-graph replays and a second stream equal to the
eager call; the cfmm matmul at the
heads' shapes, SmolLM-360M's linear shapes and ragged ones, under every
variant and split of its plan (``cfmm_matmul.plan``: ``rows`` or
``split``, K split over a cluster) and every copy width, with and
without a scale, and a split launch's CUDA-graph replay.  Asserted: int32 accumulators equal,
``y`` and the per-image amax equal (both sides round the Collector once,
``fmaf`` against ``ref.fma_f32``).  The flash-attention kernel against
its plain version in f32 and bf16 over the JAX kernel test's sweep, the
LM's served shapes, ragged and rectangular Tq/Tk, windows and Dv != D,
both kernels (the tensor-core ``mma`` and the CUDA-core ``fma``), within
the tolerances of ``FLASH_TOL``; the sparse matmul at the LM's linear
shapes, in both variants, with and without a split over K; the block-sparse matmul in f32 and bf16 with 100, 50, 20
and 0 % of its blocks kept, ragged M and blocks that are no multiple of
its tile, within ``BS_RTOL``/``BS_ATOL``; also at every split of a
column's active blocks (``block_sparse.plan``) and every copy width,
two calls and a CUDA-graph replay giving the same bits.  The dense LM
configs' served shapes: flash attention at StableLM-3B's, Gemma3-1B's
(window 512 and none) and Phi-3-medium's prefill (T = 1024 and 1000),
each through the variant the rule picks; ``cfmm_matmul`` at their
linears and untied heads (decode slots and the largest bucket);
``sparse_matvec`` at Gemma3-1B's linears; and one ``dense`` engine run
at ``reduced()`` on the card against the same run on the CPU.  The
flash-attention backward kernels against their plain version at
chip_smoke.py's shapes (the training shapes of SmolLM-360M and Gemma3-1B,
the served ones) and ragged ones, in f32 and bf16, the same bits on a
second run, the forward's log-sum-exp, and ``ops.flash_attention`` under
autograd launching one forward and one backward.
"""
import pytest
import torch

from repro_torch.core.compiled_linear import _compile_leaf_2d
from repro_torch.kernels import (block_sparse, cfmm_matmul, conv_depthwise,
                                 conv_implicit, conv_sparse, flash_attention,
                                 ops, ref, sparse_matvec)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(k, stride, c_in, c_out, hw, sc_kind, dev, seed=0, N=2):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-127, 128, (N, hw, hw, c_in), generator=g,
                      dtype=torch.int8)
    w = torch.randn((c_in * k * k, c_out), generator=g)
    dense = _compile_leaf_2d(w, "int8", 0.8, conv_k=k)
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8, conv_k=k)
    eff = 1e-3 * torch.rand((N, c_out), generator=g)
    bias = 0.1 * torch.randn((c_out,), generator=g)
    h = -(-hw // stride)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, h, h, c_out), generator=g).to(dev)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, h, h, c_out), generator=g,
                            dtype=torch.int8).to(dev),
              torch.rand((N,), generator=g).to(dev))
    put = lambda t: t.to(dev).contiguous()
    return (put(x), put(dense["values"]), put(packed["bitmap"]),
            put(packed["values"]), put(eff), put(bias), sc)


@pytest.mark.parametrize("k,stride,c_in,c_out,hw", [
    (1, 1, 8, 16, 7), (1, 2, 16, 64, 9), (3, 1, 8, 72, 9), (3, 2, 32, 64, 8),
    (7, 2, 3, 64, 17), (7, 1, 3, 16, 8), (3, 1, 64, 130, 5)])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_kernels_match_plain(dev, k, stride, c_in, c_out, hw, sc_kind,
                                  relu):
    x, codes, bitmap, values, eff, bias, sc = _case(k, stride, c_in, c_out,
                                                    hw, sc_kind, dev)
    kw = dict(k=k, stride=stride, relu=relu, return_acc=True)
    for kern, plain, w in (
            (conv_implicit.conv2d_implicit,
             conv_implicit.conv2d_implicit_plain, (codes,)),
            (conv_sparse.conv2d_sparse, conv_sparse.conv2d_sparse_plain,
             (bitmap, values))):
        y, amax, acc = kern(x, *w, eff, bias, sc, **kw)
        y_p, amax_p, acc_p = plain(x, *w, eff, bias, sc, **kw)
        torch.cuda.synchronize()
        assert torch.equal(acc, acc_p)
        assert torch.equal(y, y_p)
        assert torch.equal(amax, amax_p)


def _conv_pairs():
    return ((conv_implicit.conv2d_implicit,
             conv_implicit.conv2d_implicit_plain, conv_implicit.KERNEL,
             False),
            (conv_sparse.conv2d_sparse, conv_sparse.conv2d_sparse_plain,
             conv_sparse.KERNEL, True))


def _launch(kernel, x, wts, eff, bias, sc, cplan, **kw):
    """A conv kernel's launch under ``cplan`` rather than the wrapper's
    plan (``kw``: k, stride, relu, return_acc)."""
    ints = ((wts[0].shape[0], wts[1].shape[0])
            if kernel is conv_sparse.KERNEL else ())
    return conv_implicit.conv_launch(kernel, x, wts, eff, bias, sc,
                                     n_out=wts[-1].shape[1], cplan=cplan,
                                     sparse_ints=ints, **kw)


def _check_conv_plans(case, k, stride, relu, variants):
    """Both conv kernels, through the wrapper (the shape's plan) and
    under ``variants(plan, n_chunks)``, ``torch.equal`` to the plain
    version in acc, y, amax; one launch each."""
    x, codes, bitmap, values, eff, bias, sc = case
    N, _, _, C = x.shape
    _, _, h, w = conv_implicit.conv_geometry(x, k, stride)
    kw = dict(k=k, stride=stride, relu=relu, return_acc=True)
    seen = []
    for kern, plain, kernel, sparse in _conv_pairs():
        wts = (bitmap, values) if sparse else (codes,)
        p = conv_implicit.plan(N, h, w, C, k, codes.shape[1], sparse=sparse)
        rows = k * k * C
        n_chunks = -(-(-(-rows // 8) * 8 if sparse else rows) // 64)
        want = plain(x, *wts, eff, bias, sc, **kw)
        for cp in [p, *variants(p, n_chunks)]:
            before = kernel.launches
            got = (kern(x, *wts, eff, bias, sc, **kw) if cp is p else
                   _launch(kernel, x, wts, eff, bias, sc, cp, **kw))
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b), cp
            seen.append(cp)
    return seen


def _splits(p, n):
    per3 = -(-n // 3)
    return [p._replace(splits=1, chunks_per=n),
            p._replace(splits=n, chunks_per=1),
            p._replace(splits=-(-n // per3), chunks_per=per3)]


@pytest.mark.parametrize("k,stride,c_in,c_out,hw,N", [
    (7, 2, 3, 64, 23, 2),       # byte gather (C = 3), 16-byte weights
    (3, 2, 3, 32, 20, 3),       # C = 3, N = 3: tiles cross images
    (3, 1, 8, 20, 9, 2),        # 4-byte copies, n_out % 8 != 0
    (1, 1, 24, 144, 11, 1),     # C = 24, N = 1, ragged M
    (3, 1, 16, 72, 7, 3),       # C % 16 == 0, 4-byte weights
    (3, 2, 64, 130, 9, 2),      # byte weight loads (n_out = 130)
    (1, 2, 32, 96, 13, 3),      # strided 1x1, N = 3
])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_kernels_every_plan_branch(dev, k, stride, c_in, c_out, hw, N,
                                        sc_kind, relu):
    case = _case(k, stride, c_in, c_out, hw, sc_kind, dev,
                 seed=k + c_in + c_out + hw, N=N)
    seen = _check_conv_plans(case, k, stride, relu, _splits)
    assert any(p.splits > 1 for p in seen) or k * k * c_in <= 64


@pytest.mark.parametrize("k,c_in,c_out,hw", [
    (3, 512, 512, 7),           # conv5_x_2/b: K = 4608, 16 tiles
    (3, 256, 256, 14),          # conv4_x_2/b
    (1, 1024, 256, 14),         # conv4_x_2/a
    (1, 2048, 512, 7),          # conv5_x_2/a
    (1, 512, 2048, 7),          # conv5_x_2/c
])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
def test_conv_kernels_split_k_at_resnet50_small_maps(dev, k, c_in, c_out,
                                                     hw, sc_kind):
    """Full-width ResNet50 shapes at microbatch 2, where the plan splits K
    over the grid; also with about twice the splits (one cluster at
    most)."""
    case = _case(k, 1, c_in, c_out, hw, sc_kind, dev, seed=c_in + hw)
    def more(p, n):                     # half the chunks per split, within
        per = max(-(-n // conv_implicit.MAX_SPLITS), p.chunks_per // 2, 1)
        return [p._replace(splits=-(-n // per), chunks_per=per)]
    seen = _check_conv_plans(case, k, 1, True, more)
    assert all(p.splits > 1 for p in seen)


def test_conv_split_k_graph_replay_equals_eager(dev):
    """A split launch (a cluster per tile) keeps no state between calls:
    a second launch and CUDA-graph replays give the eager outputs."""
    x, codes, bitmap, values, eff, bias, sc = _case(3, 1, 256, 256, 14,
                                                    "int8", dev, seed=3)
    kw = dict(k=3, stride=1, relu=True, return_acc=True)
    for kern, _, _, sparse in _conv_pairs():
        wts = (bitmap, values) if sparse else (codes,)
        first = kern(x, *wts, eff, bias, sc, **kw)
        again = kern(x, *wts, eff, bias, sc, **kw)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kern(x, *wts, eff, bias, sc, **kw)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        for a, b, c in zip(first, again, captured):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_conv_kernels_refuse_a_plan_they_do_not_take(dev):
    x, codes, *_, eff, bias, _ = _case(3, 1, 8, 16, 5, None, dev)
    p = conv_implicit.plan(2, 5, 5, 8, 3, 16)
    kw = dict(k=3, stride=1, relu=True, return_acc=False)
    for bad in (p._replace(vec=16),                  # C = 8: not 16-byte
                p._replace(splits=3, chunks_per=1),  # an empty split
                p._replace(splits=1, chunks_per=1)): # K = 72: 2 chunks
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _launch(conv_implicit.KERNEL, x, (codes,), eff, bias, None, bad,
                    **kw)
    # more splits than one cluster holds (K = 4608: 72 chunks)
    x, codes, *_, eff, bias, _ = _case(3, 1, 512, 64, 3, None, dev)
    p = conv_implicit.plan(2, 3, 3, 512, 3, 64)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _launch(conv_implicit.KERNEL, x, (codes,), eff, bias, None,
                p._replace(splits=18, chunks_per=4), **kw)


def test_conv_sparse_split_start_past_8192_bitmap_rows(dev):
    """K = 73728 (9216 bitmap rows, 16 splits of 72 chunks): the later
    splits' 16-byte popcount start runs over two passes of its 16-bit
    lanes; acc, y, amax equal the plain version's."""
    x, _, bitmap, values, eff, bias, sc = _case(3, 1, 8192, 16, 3, "int8",
                                                dev, seed=11)
    p = conv_implicit.plan(2, 3, 3, 8192, 3, 16, sparse=True)
    assert p.bvec == 16 and (p.splits - 1) * p.chunks_per * 8 > 8192
    kw = dict(k=3, stride=1, relu=True, return_acc=True)
    got = conv_sparse.conv2d_sparse(x, bitmap, values, eff, bias, sc, **kw)
    want = conv_sparse.conv2d_sparse_plain(x, bitmap, values, eff, bias, sc,
                                           **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _zero_bias(bias):
    """A bias that zeroes whole blocks of channels after the ReLU (every
    other 64-channel tile and every third group of 8), so every group
    size has all-zero cells beside partly zero ones."""
    n = torch.arange(bias.numel(), device=bias.device)
    dead = ((n // 64) % 2 == 1) | ((n // 8) % 3 == 0)
    return torch.where(dead, torch.full_like(bias, -1e6), bias)


def _check_conv_zero_counts(case, k, stride, g, relu=True, variants=None):
    """Both conv kernels' ``profile_g`` zero counts against the plain
    version's dict, every key exact; acc, y and amax the same with
    profiling on and off and equal to the plain version's.  With
    ``variants``, also under those plans (``conv_launch``).  Returns
    whether the epilogue counted."""
    x, codes, bitmap, values, eff, bias, sc = case
    N, _, _, C = x.shape
    n_out = codes.shape[1]
    _, _, h, w = conv_implicit.conv_geometry(x, k, stride)
    kw = dict(k=k, stride=stride, relu=relu, return_acc=True)
    for kern, plain, kernel, sparse in _conv_pairs():
        wts = (bitmap, values) if sparse else (codes,)
        *want, zc_p = plain(x, *wts, eff, bias, sc, profile_g=g, **kw)
        p = conv_implicit.plan(N, h, w, C, k, n_out, sparse=sparse)
        rows = k * k * C
        n_chunks = -(-(-(-rows // 8) * 8 if sparse else rows) // 64)
        for cp in [p, *(variants(p, n_chunks) if variants else ())]:
            if cp is p:
                *on, zc = kern(x, *wts, eff, bias, sc, profile_g=g, **kw)
                off = kern(x, *wts, eff, bias, sc, **kw)
            else:
                *on, zc = _launch(kernel, x, wts, eff, bias, sc, cp,
                                  profile_g=g, **kw)
                off = _launch(kernel, x, wts, eff, bias, sc, cp, **kw)
            torch.cuda.synchronize()
            for a, b, c in zip(on, off, want):
                assert torch.equal(a, b) and torch.equal(a, c), cp
            assert zc.keys() == zc_p.keys()
            for key in zc:
                assert torch.equal(zc[key], zc_p[key]), (key, cp)
    return conv_implicit.counts_in_kernel(n_out, g)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("k,stride,c_in,c_out,hw,N", [
    (3, 1, 64, 256, 14, 2),     # one image per tile (196 rows an image)
    (1, 1, 256, 128, 7, 2),     # 49 rows an image: tiles cross images
    (3, 2, 16, 64, 8, 3),       # 16 rows an image: 4 images per tile
    (1, 1, 32, 64, 2, 40),      # 4 rows an image: past ZC_SLOTS images
    (7, 2, 3, 64, 23, 2),       # the byte-gather stem
])
def test_conv_zero_counts_every_group_path(dev, g, k, stride, c_in, c_out,
                                           hw, N):
    """Groups inside a thread (g <= 8), over a lane pair and a quad (16,
    32), over the two column warps (64); tiles in one image and across
    2, 4 and more images than the shared slots hold."""
    case = list(_case(k, stride, c_in, c_out, hw, None, dev,
                      seed=g + c_in + hw, N=N))
    case[5] = _zero_bias(case[5])
    assert _check_conv_zero_counts(case, k, stride, g)


@pytest.mark.parametrize("c_out,g", [(72, 8), (40, 8), (12, 4), (20, 4),
                                     (96, 32), (130, 2), (192, 64)])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
def test_conv_zero_counts_ragged_n_out(dev, c_out, g, sc_kind):
    """n_out off the 64-channel tile (groups past n_out skipped), off
    multiples of 8 (the epilogue's scalar path), and every shortcut."""
    case = list(_case(3, 1, 16, c_out, 9, sc_kind, dev, seed=c_out + g,
                      N=3))
    case[5] = _zero_bias(case[5])
    assert _check_conv_zero_counts(case, 3, 1, g)


@pytest.mark.parametrize("c_out,g", [(256, 128), (96, 48), (64, 3),
                                     (60, 8)])
def test_conv_zero_counts_recounted_on_y(dev, c_out, g):
    """A group wider than the tile, or not a power of two, or not
    dividing n_out (c_out 60, g 8: the plain version refuses it too):
    the wrapper recounts on y, as the JAX op's ``profile_fast`` false."""
    case = list(_case(1, 1, 32, c_out, 7, None, dev, seed=c_out, N=2))
    case[5] = _zero_bias(case[5])
    if c_out % g:
        with pytest.raises(ValueError, match="groups"):
            _check_conv_zero_counts(case, 1, 1, g)
        return
    assert not _check_conv_zero_counts(case, 1, 1, g)


@pytest.mark.parametrize("k,c_in,c_out,hw,g", [
    (3, 512, 512, 7, 8), (3, 256, 256, 14, 64), (1, 2048, 512, 7, 32),
    (1, 512, 2048, 7, 16)])
def test_conv_zero_counts_under_split_k(dev, k, c_in, c_out, hw, g):
    """ResNet50's small maps, where the plan splits K over a cluster:
    only the leaders' own rows count, under the plan and with one and
    with more splits."""
    case = list(_case(k, 1, c_in, c_out, hw, "int8", dev, seed=c_in + g))
    case[5] = _zero_bias(case[5])

    def more(p, n):
        per = max(-(-n // conv_implicit.MAX_SPLITS), p.chunks_per // 2, 1)
        return [p._replace(splits=1, chunks_per=n),
                p._replace(splits=-(-n // per), chunks_per=per)]
    assert _check_conv_zero_counts(case, k, 1, g, variants=more)


def test_conv_zero_counts_without_relu_and_graph_replay(dev):
    """Without the ReLU the zeros are rare but still counted; a profiled
    launch keeps no state between calls (the wrapper zeroes the counts):
    a second call and CUDA-graph replays give the eager counts."""
    case = list(_case(3, 1, 64, 128, 14, "f32", dev, seed=5))
    case[5] = _zero_bias(case[5])
    assert _check_conv_zero_counts(case, 3, 1, 8, relu=False)
    x, codes, bitmap, values, eff, bias, sc = case
    kw = dict(k=3, stride=1, relu=True, return_acc=False, profile_g=16)
    for kern, _, _, sparse in _conv_pairs():
        wts = (bitmap, values) if sparse else (codes,)
        first = kern(x, *wts, eff, bias, sc, **kw)
        again = kern(x, *wts, eff, bias, sc, **kw)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kern(x, *wts, eff, bias, sc, **kw)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        for out in (again, captured):
            assert torch.equal(first[0], out[0])
            for key in first[2]:
                assert torch.equal(first[2][key], out[2][key]), key


@pytest.mark.parametrize("M,K,N", [(1, 64, 10), (2, 2048, 1000),
                                   (9, 256, 33), (17, 512, 64)])
def test_sparse_matvec_matches_plain(dev, M, K, N):
    g = torch.Generator().manual_seed(M + K + N)
    leaf = _compile_leaf_2d(torch.randn((K, N), generator=g), "sparse_cfmm",
                            0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    x, bm, vals = (t.to(dev).contiguous()
                   for t in (x, leaf["bitmap"], leaf["values"]))
    out = sparse_matvec.sparse_matvec(x, bm, vals)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.sparse_matvec_ref(x, bm, vals))


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x, codes, *_ , eff, bias, _ = _case(3, 1, 8, 16, 5, None, dev)
    with pytest.raises(ValueError):
        conv_implicit.conv2d_implicit(x, codes.cpu(), eff, bias, k=3,
                                      stride=1)
    with pytest.raises(ValueError):
        conv_implicit.conv2d_implicit(x, codes, eff[:1], bias, k=3,
                                      stride=1)


@pytest.mark.parametrize("stride,C,hw", [
    (1, 8, 7), (2, 24, 9), (1, 40, 8), (2, 144, 14), (1, 960, 7),
    (2, 3, 9), (1, 13, 6)])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_depthwise_matches_plain(dev, stride, C, hw, sc_kind, relu):
    """Channel counts that are not multiples of 4 take the byte path and
    mask the ragged edge; no channel padding."""
    g = torch.Generator().manual_seed(C + hw + stride)
    N = 2
    x = torch.randint(-127, 128, (N, hw, hw, C), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-63, 64, (9, C), generator=g, dtype=torch.int8)
    eff = 1e-3 * torch.rand((N, C), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    h = -(-hw // stride)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, h, h, C), generator=g).to(dev)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, h, h, C), generator=g,
                            dtype=torch.int8).to(dev),
              torch.rand((N,), generator=g).to(dev))
    x, w, eff, bias = (t.to(dev).contiguous() for t in (x, w, eff, bias))
    kw = dict(k=3, stride=stride, relu=relu, return_acc=True)
    y, amax, acc = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    y_p, amax_p, acc_p = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc,
                                                        **kw)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_p)
    assert torch.equal(y, y_p)
    assert torch.equal(amax, amax_p)


@pytest.mark.parametrize("C", [13, 96])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
def test_conv_depthwise_unchanged_by_the_shared_epilogue(dev, C, sc_kind):
    """The depthwise kernel shares conv_common.cuh's Collector with the
    tensor-core conv kernel: with N = 3, ReLU off and every shortcut
    form it stays bit-equal to its plain version."""
    g = torch.Generator().manual_seed(C)
    N, hw = 3, 10
    x = torch.randint(-127, 128, (N, hw, hw, C), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-63, 64, (9, C), generator=g, dtype=torch.int8)
    eff = 1e-3 * torch.rand((N, C), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, hw, hw, C), generator=g).to(dev)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, hw, hw, C), generator=g,
                            dtype=torch.int8).to(dev),
              torch.rand((N,), generator=g).to(dev))
    x, w, eff, bias = (t.to(dev).contiguous() for t in (x, w, eff, bias))
    kw = dict(k=3, stride=1, relu=False, return_acc=True)
    got = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    want = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C,hw,stride", [
    (32, 112, 1), (96, 112, 2), (144, 56, 1), (144, 56, 2), (192, 28, 1),
    (192, 28, 2), (384, 14, 1), (576, 14, 1), (576, 14, 2), (960, 7, 1)])
def test_conv_depthwise_matches_plain_at_mobilenet_shapes(dev, C, hw, stride):
    """MobileNetV2's ten depthwise shapes at 224 px, N = 2, as served
    (ReLU, no shortcut, per-row dequant rows)."""
    g = torch.Generator().manual_seed(C * hw + stride)
    x = torch.randint(-127, 128, (2, hw, hw, C), generator=g,
                      dtype=torch.int8).to(dev)
    w = torch.randint(-63, 64, (9, C), generator=g, dtype=torch.int8).to(dev)
    eff = (1e-3 * torch.rand((2, C), generator=g)).to(dev)
    bias = (0.1 * torch.randn((C,), generator=g)).to(dev)
    kw = dict(k=3, stride=stride, relu=True, return_acc=True)
    got = conv_depthwise.conv2d_dw(x, w, eff, bias, **kw)
    want = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _dw_case(N, hw, C, k, stride, sc_kind, dev, seed=0, w_hw=None):
    """Depthwise inputs: int8 x (N, hw, w_hw or hw, C), INT7-range tap
    weights, per-image dequant rows, bias and the shortcut."""
    g = torch.Generator().manual_seed(seed)
    W = w_hw or hw
    x = torch.randint(-127, 128, (N, hw, W, C), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-63, 64, (k * k, C), generator=g, dtype=torch.int8)
    eff = 1e-3 * torch.rand((N, C), generator=g)
    bias = 0.1 * torch.randn((C,), generator=g)
    h, wo = -(-hw // stride), -(-W // stride)
    sc = None
    if sc_kind == "f32":
        sc = torch.randn((N, h, wo, C), generator=g).to(dev)
    elif sc_kind == "int8":
        sc = (torch.randint(-127, 128, (N, h, wo, C), generator=g,
                            dtype=torch.int8).to(dev),
              torch.rand((N,), generator=g).to(dev))
    put = lambda t: t.to(dev).contiguous()
    return put(x), put(w), put(eff), put(bias), sc


def _dw_plans(p, stride):
    """``p`` and the other branches of the depthwise launch: each narrower
    copy width, every other channel slice from 4 to 64 that the copy width
    allows (ragged past C), one, two, three rows per band and the whole
    map, a padded column, one warp per block.  Slice and band counts and
    shared memory are ``_dw_fix``'s."""
    out = [p]
    out += [p._replace(vec=v) for v in (4, 1) if v < p.vec]
    out += [p._replace(cb=cb, cw=conv_depthwise.column_words(
                cb // 4, stride, p.vec))
            for cb in (4, 8, 16, 32, 64) if cb % p.vec == 0 and cb != p.cb]
    out += [p._replace(rows=rows) for rows in (1, 2, 3, 1 << 20)]
    out += [p._replace(cw=p.cw + 4), p._replace(threads=32)]
    return out


def _dw_fix(p, N, H, W, C, k, stride):
    """A varied plan's slice and band counts and shared memory."""
    _, _, h = ref.same_pads(H, k, stride)
    _, _, w = ref.same_pads(W, k, stride)
    rows = min(p.rows, h)
    return p._replace(
        rows=rows, n_slices=-(-C // p.cb), n_bands=-(-h // rows),
        smem=conv_depthwise.smem_bytes(rows, w, k, stride, p.cw, p.cb))


@pytest.mark.parametrize("N,hw,C,k,stride", [
    (2, 112, 32, 3, 1), (2, 56, 144, 3, 2), (2, 14, 576, 3, 2),
    (1, 9, 3, 3, 2),      # C = 3: bytes, one slice of 4
    (3, 7, 13, 3, 1),     # C = 13: bytes, ragged slice
    (2, 11, 16, 5, 1),    # k = 5: the generic instance
    (1, 10, 960, 3, 1),   # 15 slices of 64
    (3, 9, 24, 5, 2),     # k = 5, stride 2, 4-byte copies
    (2, 8, 40, 3, 2),
])
@pytest.mark.parametrize("sc_kind", [None, "f32", "int8"])
def test_conv_depthwise_every_plan_branch(dev, N, hw, C, k, stride, sc_kind):
    """The wrapper's plan and every other branch of the launch (copy
    width, slice, band, column pad, threads) equal the plain version in
    acc, y and amax; one launch each."""
    x, w, eff, bias, sc = _dw_case(N, hw, C, k, stride, sc_kind, dev,
                                   seed=N + hw + C + k)
    kw = dict(k=k, stride=stride, relu=sc_kind != "int8", return_acc=True)
    want = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc, **kw)
    p = conv_depthwise.plan(N, hw, hw, C, k, stride)
    for q in _dw_plans(p, stride):
        q = _dw_fix(q, N, hw, hw, C, k, stride)
        if q.smem > conv_depthwise.MAX_SMEM:
            continue
        before = conv_depthwise.KERNEL.launches
        got = conv_depthwise.dw_launch(x, w, eff, bias, sc, profile_g=None,
                                       dplan=q, **kw)
        torch.cuda.synchronize()
        assert conv_depthwise.KERNEL.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), q


@pytest.mark.parametrize("N,H,W,C,stride", [
    (1, 9, 7, 16, 2), (3, 7, 11, 960, 2), (3, 13, 9, 3, 1), (1, 5, 15, 13, 2)])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("relu", [True, False])
def test_conv_depthwise_odd_maps(dev, N, H, W, C, stride, k, relu):
    """Odd and non-square maps, N of 1 and 3, k = 3 and 5."""
    x, w, eff, bias, sc = _dw_case(N, H, C, k, stride, "f32", dev,
                                   seed=H * W + C, w_hw=W)
    kw = dict(k=k, stride=stride, relu=relu, return_acc=True)
    got = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    want = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("offset", [1, 4, 8])
@pytest.mark.parametrize("C", [16, 32])
def test_conv_depthwise_takes_an_unaligned_view(dev, offset, C):
    """An x_q view off 16 bytes takes 4-byte copies, off 4 bytes single
    bytes; the result is the aligned call's."""
    x, w, eff, bias, _ = _dw_case(2, 12, C, 3, 1, None, dev, seed=C)
    buf = torch.empty(x.numel() + offset, dtype=torch.int8, device=dev)
    x_off = buf[offset:].view(x.shape)
    x_off.copy_(x)
    kw = dict(k=3, stride=1, relu=True, return_acc=True)
    got = conv_depthwise.conv2d_dw(x_off, w, eff, bias, **kw)
    want = conv_depthwise.conv2d_dw(x, w, eff, bias, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N,hw,C,stride,g", [
    (2, 14, 576, 2, 8), (2, 28, 192, 1, 4), (3, 9, 64, 2, 16),
    (2, 7, 960, 1, 64), (1, 8, 16, 1, 2), (2, 9, 13, 1, 1),
    (2, 9, 48, 2, 24),    # a slice of 16: recounted on y
    (2, 6, 12, 1, 3),     # C = 12, slice 4: recounted on y
])
@pytest.mark.parametrize("sc_kind", [None, "int8"])
def test_conv_depthwise_zero_counts(dev, N, hw, C, stride, g, sc_kind):
    """The zero counts equal the plain version's dict exactly, whether
    the epilogue counts them or they are recounted on y; y, amax and acc
    are the same with profiling on or off."""
    x, w, eff, bias, sc = _dw_case(N, hw, C, 3, stride, sc_kind, dev,
                                   seed=C + g)
    bias = bias - 0.05          # more zeros after the ReLU
    kw = dict(k=3, stride=stride, relu=True, return_acc=True)
    *got, zc = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, profile_g=g,
                                        **kw)
    off = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    *want, zc_p = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc,
                                                 profile_g=g, **kw)
    torch.cuda.synchronize()
    for a, b, c in zip(got, off, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert zc.keys() == zc_p.keys()
    for key in zc:
        assert torch.equal(zc[key], zc_p[key]), key
    assert float(zc["group_allzero"].sum()) > 0 or g > 4


def test_conv_depthwise_graph_replay_equals_eager(dev):
    """No state outlives a call (amax and the zero counts are zeroed by
    launches of their own): eager calls, then two CUDA graphs of the
    kernel (with and without zero counts) each replayed twice on new
    inputs, and eager calls on a second stream, all equal the plain
    version."""
    N, hw, C = 2, 28, 192
    x, w, eff, bias, sc = _dw_case(N, hw, C, 3, 1, "int8", dev, seed=5)
    kw = dict(k=3, stride=1, relu=True, return_acc=True)
    for _ in range(2):
        conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    torch.cuda.synchronize()
    graph, graph_zc = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
    with torch.cuda.graph(graph_zc):
        out_zc = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, profile_g=8,
                                          **kw)
    g = torch.Generator().manual_seed(6)
    side = torch.cuda.Stream()
    for _ in range(2):
        x.copy_(torch.randint(-127, 128, x.shape, generator=g,
                              dtype=torch.int8))
        graph.replay()
        graph_zc.replay()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            on_side = conv_depthwise.conv2d_dw(x, w, eff, bias, sc, **kw)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        *want, zc_p = conv_depthwise.conv2d_dw_plain(x, w, eff, bias, sc,
                                                     profile_g=8, **kw)
        for got in (out, out_zc[:3], on_side):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        for key in zc_p:
            assert torch.equal(out_zc[3][key], zc_p[key]), key


def test_conv_depthwise_refuses_a_plan_it_does_not_take(dev):
    x, w, eff, bias, _ = _dw_case(2, 7, 32, 3, 1, None, dev)
    p = conv_depthwise.plan(2, 7, 7, 32, 3, 1)
    kw = dict(k=3, stride=1, relu=True, return_acc=False, profile_g=None)
    for bad in (p._replace(cb=24), p._replace(cw=2),
                p._replace(threads=48), p._replace(threads=512),
                p._replace(cb=8, cw=2),           # 16-byte copies of 8
                p._replace(cw=10)):               # 16-byte copies unaligned
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            conv_depthwise.dw_launch(x, w, eff, bias, None, dplan=bad, **kw)


@pytest.mark.parametrize("M,K,N", [(1, 64, 10), (2, 2048, 1000),
                                   (2, 1280, 1000), (128, 2048, 1000),
                                   (9, 130, 33), (3, 7, 5), (17, 512, 256)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cfmm_matmul_matches_plain(dev, M, K, N, with_scale):
    """Exact int32 products (K and N off multiples of 4 take the byte
    path); with a scale, one f32 rounding of ``acc * scale``."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    codes = torch.randint(-63, 64, (K, N), generator=g, dtype=torch.int8)
    scale = (0.01 + torch.rand((1, N), generator=g)) if with_scale else None
    x, codes = x.to(dev), codes.to(dev)
    scale = None if scale is None else scale.to(dev)
    out = cfmm_matmul.cfmm_matmul(x, codes, scale)
    out_p = cfmm_matmul.cfmm_matmul_plain(x, codes, scale)
    torch.cuda.synchronize()
    assert out.dtype == out_p.dtype
    assert torch.equal(out, out_p)


@pytest.mark.parametrize("M,K,N", [(4, 960, 2560), (4, 2560, 960),
                                   (64, 960, 2560), (1024, 960, 960),
                                   (1024, 960, 320), (1024, 960, 2560),
                                   (1024, 2560, 960),
                                   # DeepSeek-V2-Lite: expert queues, MLA
                                   (120, 2048, 1408), (8, 1408, 2048),
                                   (1024, 2048, 576), (1024, 512, 2048),
                                   # Mamba x_proj, dt_proj (Jamba)
                                   (777, 8192, 288), (777, 256, 8192),
                                   (4, 8192, 288),
                                   # RWKV6 mix and decay loras
                                   (1000, 4096, 160), (1000, 4096, 64),
                                   (1000, 64, 4096), (4, 64, 4096),
                                   # Jamba experts, the 65536-token heads
                                   (128, 4096, 14336), (128, 14336, 4096),
                                   (8, 4096, 14336), (1, 4096, 65536),
                                   (4, 4096, 65536)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cfmm_matmul_matches_plain_at_lm_shapes(dev, M, K, N, with_scale):
    """SmolLM-360M's linears in int8: decode slots (M = 4) and prefill
    buckets; DeepSeek-V2-Lite's routed experts on their queues (cap 120
    at 1024 tokens, 8 in decode) and MLA's kv_down and k_up / v_up at
    1024 tokens; the SSM paths' new shapes: Mamba's x_proj and dt_proj
    at 777 tokens and in decode, RWKV6's low-rank mix (N = 160) and
    decay (N = 64, K = 64) projections at 1000 tokens, Jamba's experts
    at cap 128 and 8, and the 4096 x 65536 heads; the int32 product
    equal, the scaled output one rounding."""
    g = torch.Generator().manual_seed(M + K + N)
    leaf = _compile_leaf_2d(torch.randn((K, N), generator=g), "int8", 0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    x, codes, scale = (t.to(dev).contiguous()
                       for t in (x, leaf["values"], leaf["scale"]))
    scale = scale if with_scale else None
    before = cfmm_matmul.KERNEL.launches
    out = cfmm_matmul.cfmm_matmul(x, codes, scale)
    torch.cuda.synchronize()
    assert cfmm_matmul.KERNEL.launches == before + 1
    assert torch.equal(out, cfmm_matmul.cfmm_matmul_plain(x, codes, scale))


def _cfmm_plans(M, K, N):
    """The plan's own launch and every other split of K the kernel takes
    for this variant: 1, 2, 3 and 16 splits (as far as K has chunks)."""
    p = cfmm_matmul.plan(M, K, N)
    bk = cfmm_matmul.TILE[p.variant][1]
    n_chunks = -(-K // bk)
    plans = {p}
    for want in (1, 2, 3, 16):
        per = -(-n_chunks // min(want, n_chunks))
        plans.add(p._replace(splits=-(-n_chunks // per), chunks_per=per))
    return sorted(plans)


@pytest.mark.parametrize("M,K,N", [
    (1, 960, 2560), (4, 2560, 960), (16, 1288, 1000), (2, 2050, 33),
    (17, 960, 320), (130, 1288, 1000), (1000, 2560, 33), (64, 130, 2560)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cfmm_matmul_every_split(dev, M, K, N, with_scale):
    """Both variants (split at M <= 16, rows above, ragged row tiles at
    17, 130, 1000), every split of K from 1 to 16 (a ragged last chunk at
    K = 1288, 2050, 130), and every copy width (K, N multiples of 16, 8,
    or neither: 2050 and 33 take byte loads)."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    codes = torch.randint(-63, 64, (K, N), generator=g, dtype=torch.int8)
    scale = (0.01 + torch.rand((N,), generator=g)) if with_scale else None
    x, codes = x.to(dev), codes.to(dev)
    scale = None if scale is None else scale.to(dev)
    want = cfmm_matmul.cfmm_matmul_plain(x, codes, scale)
    for p in _cfmm_plans(M, K, N):
        got = cfmm_matmul.cfmm_launch(x, codes, scale, p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p


def test_cfmm_matmul_takes_unaligned_operands(dev):
    """x and codes that start off a 16-, 8- or 4-byte boundary take
    narrower copies (down to byte loads), as do stacked-leaf slices."""
    g = torch.Generator().manual_seed(5)
    M, K, N = 4, 960, 320
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    codes = torch.randint(-63, 64, (K, N), generator=g, dtype=torch.int8)
    want = cfmm_matmul.cfmm_matmul_plain(x, codes)
    for off in (1, 4, 8):
        xb = torch.empty(x.numel() + off, dtype=torch.int8, device=dev)
        wb = torch.empty(codes.numel() + off, dtype=torch.int8, device=dev)
        xo, wo = xb[off:].view(M, K), wb[off:].view(K, N)
        xo.copy_(x.to(dev))
        wo.copy_(codes.to(dev))
        got = cfmm_matmul.cfmm_matmul(xo, wo)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), off
    stacked = torch.stack([codes, codes.flip(0)]).to(dev)
    got = cfmm_matmul.cfmm_matmul(x.to(dev), stacked[1])
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cfmm_matmul.cfmm_matmul_plain(
        x, codes.flip(0)))


@pytest.mark.parametrize("M,K,N", [(4, 960, 2560), (64, 960, 2560)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_cfmm_matmul_graph_replay_equals_eager(dev, M, K, N, with_scale):
    """A split launch (a cluster per tile) captured in a CUDA graph and
    replayed on new inputs equals the eager call on them."""
    g = torch.Generator().manual_seed(M)
    mk = lambda: torch.randint(-127, 128, (M, K), generator=g,
                               dtype=torch.int8).to(dev)
    codes = torch.randint(-63, 64, (K, N), generator=g,
                          dtype=torch.int8).to(dev)
    scale = (0.01 + torch.rand((N,), generator=g)).to(dev) \
        if with_scale else None
    assert cfmm_matmul.plan(M, K, N).splits > 1
    x = mk()
    cfmm_matmul.cfmm_matmul(x, codes, scale)          # first launch: eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cfmm_matmul.cfmm_matmul(x, codes, scale)
    for _ in range(2):
        x.copy_(mk())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, cfmm_matmul.cfmm_matmul(x, codes, scale))


def test_cfmm_matmul_refuses_a_plan_it_does_not_take(dev):
    x = torch.zeros((20, 960), dtype=torch.int8, device=dev)
    codes = torch.zeros((960, 64), dtype=torch.int8, device=dev)
    p = cfmm_matmul.plan(20, 960, 64)
    for bad in (p._replace(variant="split"),       # M > 16
                p._replace(splits=17, chunks_per=1),
                p._replace(splits=1, chunks_per=1),  # chunks left out
                p._replace(splits=15, chunks_per=2)):  # an empty split
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            cfmm_matmul.cfmm_launch(x, codes, None, bad)


# flash attention, kernel against plain version: the two sum the scores
# and p.v in other orders, and the kernel's p is relative to a running
# max, so it rounds to bf16 at other points (2**-9 relative each, at
# most about 2**-9 * max|v| < 1e-2 on the output).  f32: 2e-5 absolute on
# O(1) outputs; bf16: 1e-2 absolute plus one output ulp (<= 2**-7 of it).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_inputs(B, KVH, G, Tq, Tk, D, Dv, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, KVH, G, Tq, D), generator=g)
    k = torch.randn((B, KVH, Tk, D), generator=g)
    v = torch.randn((B, KVH, Tk, Dv), generator=g)
    return tuple(t.to(dtype).to(dev) for t in (q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KVH,G,Tq,Tk,D,Dv,causal,window", [
    # tests/test_kernels.py's sweep
    (1, 2, 1, 128, 256, 32, 32, True, None),
    (1, 2, 4, 128, 256, 32, 32, True, None),
    (1, 2, 2, 128, 256, 32, 32, False, None),
    (1, 2, 2, 128, 256, 32, 32, True, 64),
    (1, 2, 2, 128, 256, 32, 16, True, None),
    # SmolLM-360M prefill, ragged buckets and rectangles
    (1, 5, 3, 64, 64, 64, 64, True, None),
    (1, 5, 3, 1000, 1000, 64, 64, True, None),
    (2, 5, 3, 37, 37, 64, 64, True, None),
    (1, 5, 3, 7, 1000, 64, 64, True, None),
    (1, 5, 3, 1, 1000, 64, 64, True, None),
    (1, 1, 2, 8, 1500, 16, 16, False, None),
    # Gemma3-like window, MLA's Dv != D, G = 32 (one position per tile)
    (1, 1, 4, 1024, 1024, 256, 256, True, 512),
    (1, 2, 2, 100, 100, 192, 128, True, None),
    # DeepSeek-V2-Lite's MLA prefill at the 1024 bucket: D = 192, Dv = 128
    (1, 16, 1, 1024, 1024, 192, 128, True, None),
    (1, 1, 32, 33, 50, 32, 32, True, 9),
    # the mma kernel's edges: Tq no multiple of 16 or 64, Tq < Tk, the
    # causal edge inside a warp's 16 rows (G = 1: one position per row;
    # G = 3: 21 positions per 64-row tile, one row padding), Dv != D,
    # a window narrower than a key tile; and shapes the rule sends to
    # the CUDA-core kernel (D = 24, not a multiple of 16)
    (1, 1, 1, 40, 40, 64, 64, True, None),
    (1, 2, 3, 77, 77, 64, 64, True, None),
    (1, 5, 3, 300, 1000, 64, 64, True, None),
    (1, 2, 3, 130, 130, 128, 64, True, 24),
    (1, 2, 2, 65, 65, 16, 32, False, None),
    (1, 2, 2, 33, 70, 24, 40, True, None),
])
def test_flash_attention_matches_plain(dev, B, KVH, G, Tq, Tk, D, Dv,
                                       causal, window, dtype):
    q, k, v = _flash_inputs(B, KVH, G, Tq, Tk, D, Dv, dtype, dev,
                            seed=Tq + Tk + D)
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v, causal, window)
    want = flash_attention.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert flash_attention.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs()
    tol = FLASH_TOL[dtype] + (want.float().abs() * 2.0 ** -7
                              if dtype == torch.bfloat16 else 0.0)
    assert bool((err <= tol).all()), float(err.max())


def test_flash_attention_mma_takes_unaligned_views(dev):
    """A q, k or v that starts off a 16-byte boundary (a view into a
    larger buffer) is copied first: the mma kernel reads 16-byte rows."""
    q, k, v = _flash_inputs(1, 5, 3, 64, 64, 64, 64, torch.bfloat16, dev)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 and q_off.is_contiguous()
    got = flash_attention.flash_attention(q_off, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, flash_attention.flash_attention(q, k, v))


def test_flash_attention_rejects_what_it_does_not_take(dev):
    q, k, v = _flash_inputs(1, 1, 2, 9, 8, 16, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="Tq <= Tk"):
        flash_attention.flash_attention(q, k, v)          # Tq > Tk
    q, k, v = _flash_inputs(1, 1, 2, 8, 8, 16, 16, torch.float16, dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention.flash_attention(q, k, v)


# the backward kernels against their plain version, from the forward
# kernel's output and log-sum-exp (chip_smoke.py's FLASH_BWD_TOL): both
# sum in f32 in other orders and round once.  f32: 1e-4 absolute plus
# 1e-5 relative; bf16: 1e-2 absolute plus one output ulp.
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-5),
                 torch.bfloat16: (1e-2, 2.0 ** -7)}
FLASH_BWD_SHAPES = [
    # chip_smoke.py's: the training shapes and the served ones
    (8, 5, 3, 512, 512, 64, 64, True, None),        # SmolLM-360M train
    (1, 5, 3, 1024, 1024, 64, 64, True, None),
    (1, 5, 3, 7, 1000, 64, 64, True, None),
    (1, 12, 1, 1500, 1500, 64, 64, False, None),
    (1, 32, 1, 1024, 1024, 80, 80, True, None),     # StableLM-3B
    (1, 10, 4, 1024, 1024, 128, 128, True, None),   # Phi-3-medium
    (8, 1, 4, 512, 512, 256, 256, True, 512),       # Gemma3-1B train
    (1, 1, 4, 1024, 1024, 256, 256, True, 512),     # Gemma3-1B window
    (1, 16, 1, 1024, 1024, 192, 128, True, None),   # DeepSeek MLA
    # ragged edges: Tq, Tk no multiple of 32, a window narrower than a
    # tile, G = 32 (one position per dq block), Dv != D both ways
    (2, 2, 3, 37, 41, 16, 32, True, 5),
    (1, 1, 32, 33, 50, 32, 32, True, 9),
    (1, 2, 2, 65, 65, 40, 24, False, None),
    (1, 2, 1, 1, 77, 64, 64, True, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,KVH,G,Tq,Tk,D,Dv,causal,window",
                         FLASH_BWD_SHAPES)
def test_flash_attention_bwd_matches_plain(dev, B, KVH, G, Tq, Tk, D, Dv,
                                           causal, window, dtype):
    q, k, v = _flash_inputs(B, KVH, G, Tq, Tk, D, Dv, dtype, dev,
                            seed=Tq + Tk + D)
    do = torch.randn((B, KVH, G, Tq, Dv),
                     generator=torch.Generator().manual_seed(1)).to(
                         dtype).to(dev)
    o, lse = flash_attention.flash_attention_fwd(q, k, v, causal, window)
    assert torch.equal(o, flash_attention.flash_attention(q, k, v, causal,
                                                          window))
    _, lse_p = flash_attention.flash_attention_plain(q, k, v, causal,
                                                     window, True)
    assert float((lse - lse_p).abs().max()) <= 1e-5 * float(
        lse_p.abs().max() + 1)
    before = flash_attention.BWD_KERNEL.launches
    got = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, causal,
                                              window)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, o, do, lse,
                                                     causal, window)
    torch.cuda.synchronize()
    assert flash_attention.BWD_KERNEL.launches == before + 1
    atol, rtol = FLASH_BWD_TOL[dtype]
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all()
        err = (a.float() - b.float()).abs()
        assert bool((err <= atol + rtol * b.float().abs()).all()), \
            float(err.max())
    # deterministic: no float atomics, the same bits again
    again = flash_attention.flash_attention_bwd(q, k, v, o, do, lse, causal,
                                                window)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_autograd_runs_both_kernels(dev):
    """``ops.flash_attention`` on CUDA tensors that need a gradient: one
    forward launch (with the log-sum-exp) and one backward launch, the
    gradients within the tolerance of autograd through the plain
    version; without a gradient, the serve forward alone."""
    q, k, v = _flash_inputs(2, 2, 3, 64, 64, 64, 64, torch.bfloat16, dev)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = (flash_attention.KERNEL.launches,
              flash_attention.BWD_KERNEL.launches)
    out = ops.flash_attention(*leaves)
    do = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, do)
    assert (flash_attention.KERNEL.launches - f0,
            flash_attention.BWD_KERNEL.launches - b0) == (1, 1)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_attention.flash_attention_plain(
        *ref_leaves), ref_leaves, do)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs()
        assert bool((err <= 2e-2 + 2.0 ** -6 * b.float().abs()).all())
    with torch.no_grad():
        ops.flash_attention(*leaves)
    assert flash_attention.BWD_KERNEL.launches - b0 == 1


@pytest.mark.parametrize("M,K,N", [(64, 960, 960), (37, 960, 320),
                                   (4, 960, 2560), (130, 2560, 960)])
def test_sparse_matvec_matches_plain_at_lm_shapes(dev, M, K, N):
    """SmolLM-360M's linears in sparse_cfmm: prefill rows (M = bucket)
    and decode rows (M = slots)."""
    g = torch.Generator().manual_seed(M + K + N)
    packed = _compile_leaf_2d(torch.randn((K, N), generator=g),
                              "sparse_cfmm", 0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    x, bm, vals = (t.to(dev).contiguous() for t in
                   (x, packed["bitmap"], packed["values"]))
    got = sparse_matvec.sparse_matvec(x, bm, vals)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.sparse_matvec_ref(x, bm, vals))


@pytest.mark.parametrize("N", [1000, 33])
@pytest.mark.parametrize("K", [960, 1288])
@pytest.mark.parametrize("M", [1, 2, 4, 15, 16, 17, 64, 1000, 1024])
def test_sparse_matvec_variants_and_splits(dev, M, K, N):
    """Both variants (``split`` at M <= 16, ``rows`` above: ragged row
    tiles at 17, 1000), a ragged last K chunk (1288 = 10 chunks of 128
    and 8 rows), a ragged column tile (N = 33), and K split over the
    grid wherever ``plan`` splits it (N = 33 always; M <= 64 at
    N = 1000)."""
    g = torch.Generator().manual_seed(M + K + N)
    packed = _compile_leaf_2d(torch.randn((K, N), generator=g),
                              "sparse_cfmm", 0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    x, bm, vals = (t.to(dev).contiguous() for t in
                   (x, packed["bitmap"], packed["values"]))
    before = sparse_matvec.KERNEL.launches
    got = sparse_matvec.sparse_matvec(x, bm, vals)
    torch.cuda.synchronize()
    assert sparse_matvec.KERNEL.launches == before + 1
    assert torch.equal(got, ref.sparse_matvec_ref(x, bm, vals))


def test_sparse_matvec_clamps_past_keep_k_and_takes_unaligned_x(dev):
    """Columns with more nonzeros than ``keep_k`` read the last packed
    value for the rest, as the plain version does; an x that starts off
    an 8-byte boundary is copied first."""
    from repro_torch.core.compiled_linear import bitmap_pack
    g = torch.Generator().manual_seed(7)
    codes = torch.randint(-63, 64, (512, 70), generator=g, dtype=torch.int8)
    bm, vals = bitmap_pack(codes, 40)          # ~500 nonzeros per column
    for M in (3, 40):
        x = torch.randint(-127, 128, (M, 512), generator=g, dtype=torch.int8)
        buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=dev)
        x_off = buf[1:].view(M, 512)
        x_off.copy_(x.to(dev))
        assert x_off.data_ptr() % 8
        got = sparse_matvec.sparse_matvec(x_off, bm.to(dev), vals.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.sparse_matvec_ref(x, bm, vals))


# block-sparse matmul, kernel against plain version: the same f32 terms
# summed in another order (the kernel one FMA at a time, the plain version
# block product by block product), then rounded once to x's type.  f32:
# 1e-5 relative plus 1e-4 absolute; bf16: that plus one output ulp
# (<= 2**-7 of it), since the two f32 sums may straddle a rounding point.
BS_RTOL, BS_ATOL = 1e-5, 1e-4


def _bs_close(got, want):
    err = (got.float() - want.float()).abs()
    tol = BS_ATOL + BS_RTOL * want.float().abs()
    if want.dtype == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -7
    return bool((err <= tol).all()), float(err.max())


def _bs_inputs(M, K, N, block, keep, dtype, dev, seed=0):
    """Normal x and w with whole (bk, bn) blocks zeroed, as
    tests/test_kernels.py zeroes them: a seeded mask keeps ``keep`` of
    the blocks; one block column is emptied whenever blocks are dropped."""
    bk, bn = block
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=g)
    keep_mask = torch.rand((K // bk, N // bn), generator=g) < keep
    if keep < 1.0:
        keep_mask[:, 0] = False
    w *= keep_mask.repeat_interleave(bk, 0).repeat_interleave(bn, 1)
    x = torch.randn((M, K), generator=g)
    return x.to(dtype).to(dev), w


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("keep", [1.0, 0.5, 0.2, 0.0])
@pytest.mark.parametrize("M,K,N,block", [
    (64, 512, 256, (128, 128)),       # tests/test_kernels.py's shapes
    (8, 256, 128, (128, 128)),
    (98, 2048, 512, (64, 64)),        # ResNet50 conv5_x, ragged M
    (1024, 960, 2560, (64, 64)),      # SmolLM-360M gate/up, 1024 tokens
    (37, 480, 400, (48, 80)),         # blocks no multiple of the tile
    (130, 96, 72, (32, 24)),
    (1, 64, 64, (64, 64)),
])
def test_block_sparse_matches_plain(dev, M, K, N, block, keep, dtype):
    x, w = _bs_inputs(M, K, N, block, keep, dtype, dev, seed=M + K + N)
    p = block_sparse.pack_blocks(w, block, dtype, dev)
    mask = p.mask
    args = (p.w_blocks, p.meta, p.offsets, block, p.n_blocks_n)
    before = block_sparse.KERNEL.launches
    got = block_sparse.block_sparse_matmul(x, *args)
    want = ref.block_sparse_matmul_plain(x, *args)
    torch.cuda.synchronize()
    assert block_sparse.KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    ok, err = _bs_close(got, want)
    assert ok, err
    empty_cols = torch.from_numpy(~mask.any(axis=0)).repeat_interleave(
        block[1]).to(dev)
    assert bool((got[:, empty_cols] == 0).all())
    # the op: the same kernel on the same operands, bit for bit; an empty
    # mask returns zeros without a launch
    before = block_sparse.KERNEL.launches
    via_op = ops.block_sparse_matmul(x, w, block)
    torch.cuda.synchronize()
    assert torch.equal(via_op, got)
    assert block_sparse.KERNEL.launches == before + int(mask.any())


def test_block_sparse_rejects_what_it_does_not_take(dev):
    x, w = _bs_inputs(16, 128, 64, (32, 32), 0.5, torch.float32, dev)
    p = block_sparse.pack_blocks(w, (32, 32), torch.float32, dev)
    call = lambda x, wb=p.w_blocks, meta=p.meta, offs=p.offsets: \
        block_sparse.block_sparse_matmul(x, wb, meta, offs, (32, 32),
                                         p.n_blocks_n)
    with pytest.raises(ValueError, match="f32 or bf16"):
        call(x.half(), wb=p.w_blocks.half())
    with pytest.raises(ValueError, match="expected torch.float32"):
        call(x, wb=p.w_blocks.bfloat16())
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        call(x, wb=p.w_blocks.cpu())
    with pytest.raises(ValueError, match="expected shape"):
        call(x, offs=p.offsets[:-1])                       # bad offsets
    with pytest.raises(ValueError, match="expected torch.int32"):
        call(x, offs=p.offsets.long())
    with pytest.raises(ValueError, match="does not tile"):
        block_sparse.block_sparse_matmul(x[:, :100].contiguous(),
                                         p.w_blocks, p.meta, p.offsets,
                                         (32, 32), p.n_blocks_n)
    with pytest.raises(NotImplementedError):
        ops.block_sparse_matmul(x.to(torch.int8), w, (32, 32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M,K,N,block,keep", [
    (98, 2048, 512, (64, 64), 1.0),     # ResNet50 conv5_x: plan splits 9
    (98, 2048, 512, (64, 64), 0.2),
    (17, 960, 640, (64, 64), 0.5),
    (1, 480, 400, (48, 80), 1.0),
    (70, 96, 72, (32, 24), 1.0),
    (33, 240, 200, (12, 20), 0.5),      # bf16: 4-byte copies
    (9, 63, 35, (7, 5), 1.0),           # element loads
])
def test_block_sparse_every_split(dev, M, K, N, block, keep, dtype):
    """Every split of a column's active blocks (1, 2, 3, 16 and the
    plan's: more splits than a column has blocks leaves some empty),
    every copy width, ragged M: within the tolerance of the plain
    version, two calls giving the same bits, empty columns zero."""
    x, w = _bs_inputs(M, K, N, block, keep, dtype, dev, seed=M + K)
    p = block_sparse.pack_blocks(w, block, dtype, dev)
    args = (p.w_blocks, p.meta, p.offsets, block, p.n_blocks_n)
    want = ref.block_sparse_matmul_plain(x, *args)
    planned = block_sparse.plan(M, block, p.n_blocks_n, p.n_active, dtype)
    empty = torch.from_numpy(~p.mask.any(axis=0)).repeat_interleave(
        block[1]).to(dev)
    for splits in sorted({1, 2, 3, 16, planned.splits}):
        got = block_sparse.block_sparse_launch(x, *args, splits)
        again = block_sparse.block_sparse_launch(x, *args, splits)
        torch.cuda.synchronize()
        ok, err = _bs_close(got, want)
        assert ok, (splits, err)
        assert torch.equal(got, again), splits
        assert bool((got[:, empty] == 0).all())


def test_block_sparse_takes_unaligned_x(dev):
    """An x that starts off a 16-byte boundary takes narrower copies."""
    x, w = _bs_inputs(40, 256, 128, (64, 64), 1.0, torch.bfloat16, dev)
    p = block_sparse.pack_blocks(w, (64, 64), torch.bfloat16, dev)
    args = (p.w_blocks, p.meta, p.offsets, (64, 64), p.n_blocks_n)
    buf = torch.empty(x.numel() + 2, dtype=x.dtype, device=dev)
    x_off = buf[2:].view(x.shape)
    x_off.copy_(x)
    got = block_sparse.block_sparse_matmul(x_off, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, block_sparse.block_sparse_matmul(x, *args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_block_sparse_graph_replay_equals_eager(dev, dtype):
    """A split launch captured in a CUDA graph and replayed on new inputs
    equals the eager call on them, bit for bit."""
    M, K, N, block = 98, 2048, 512, (64, 64)
    x, w = _bs_inputs(M, K, N, block, 1.0, dtype, dev)
    p = block_sparse.pack_blocks(w, block, dtype, dev)
    args = (p.w_blocks, p.meta, p.offsets, block, p.n_blocks_n)
    assert block_sparse.plan(M, block, p.n_blocks_n, p.n_active,
                             dtype).splits > 1
    block_sparse.block_sparse_matmul(x, *args)        # first launch: eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = block_sparse.block_sparse_matmul(x, *args)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        x.copy_(torch.randn((M, K), generator=g).to(dtype))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, block_sparse.block_sparse_matmul(x, *args))


# ---------------------------------------------------------------------------
# The dense LM configs' served shapes (Gemma3-1B, StableLM-3B, Phi-3-medium)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("KVH,G,D,window,want_variant", [
    (32, 1, 80, None, "fma"),        # StableLM-3B
    (1, 4, 256, 512, "fma"),         # Gemma3-1B local layers
    (1, 4, 256, None, "fma"),        # Gemma3-1B global layers
    (10, 4, 128, None, "mma"),       # Phi-3-medium-14B
    (8, 4, 128, None, "mma"),        # Jamba-v0.1's attention layers
])
@pytest.mark.parametrize("T", [1024, 1000])
def test_flash_attention_matches_plain_at_dense_lm_shapes(
        dev, KVH, G, D, window, want_variant, T):
    """Each new config's prefill attention in bf16 at the largest bucket
    (and a ragged 1000), through the variant the rule picks."""
    assert flash_attention.variant(torch.bfloat16, D, D) == want_variant
    q, k, v = _flash_inputs(1, KVH, G, T, T, D, D, torch.bfloat16, dev,
                            seed=KVH + D + T)
    got = flash_attention.flash_attention(q, k, v, True, window)
    want = flash_attention.flash_attention_plain(q, k, v, True, window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = FLASH_TOL[torch.bfloat16] + want.float().abs() * 2.0 ** -7
    assert bool(torch.isfinite(got).all()) and bool((err <= tol).all()), \
        float(err.max())


# (K, N) of every linear of the three configs, and the untied heads
DENSE_LM_LINEARS = [
    (1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152),
    (2560, 2560), (2560, 6912), (6912, 2560), (2560, 50304),
    (5120, 5120), (5120, 1280), (5120, 17920), (17920, 5120),
    (5120, 100352)]


@pytest.mark.parametrize("K,N", DENSE_LM_LINEARS)
@pytest.mark.parametrize("M", [4, 1024])
def test_cfmm_matmul_matches_plain_at_dense_lm_shapes(dev, M, K, N):
    """The int8 mode's linears of Gemma3-1B, StableLM-3B and
    Phi-3-medium-14B (and the two untied heads) at the decode slots and
    the largest prefill bucket: the int32 product equal."""
    g = torch.Generator().manual_seed(M + K + N)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    codes = torch.randint(-63, 64, (K, N), generator=g, dtype=torch.int8)
    x, codes = x.to(dev), codes.to(dev)
    out = cfmm_matmul.cfmm_matmul(x, codes)
    torch.cuda.synchronize()
    assert torch.equal(out, cfmm_matmul.cfmm_matmul_plain(x, codes))


@pytest.mark.parametrize("K,N", [(1152, 1024), (1152, 256), (1024, 1152),
                                 (1152, 6912), (6912, 1152)])
@pytest.mark.parametrize("M", [4, 64, 1024])
def test_sparse_matvec_matches_plain_at_gemma3_shapes(dev, M, K, N):
    """Gemma3-1B's linears in sparse_cfmm (K = 1024, 1152 and 6912)."""
    g = torch.Generator().manual_seed(M + K + N)
    packed = _compile_leaf_2d(torch.randn((K, N), generator=g),
                              "sparse_cfmm", 0.8)
    x = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    x, bm, vals = (t.to(dev).contiguous() for t in
                   (x, packed["bitmap"], packed["values"]))
    got = sparse_matvec.sparse_matvec(x, bm, vals)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.sparse_matvec_ref(x, bm, vals))


@pytest.mark.parametrize("arch", ["gemma3_1b", "stablelm_3b",
                                  "phi3_medium_14b"])
def test_dense_engine_on_the_card_matches_the_cpu(dev, arch):
    """One ``dense`` engine run at ``reduced()`` on the card (cuBLAS bf16
    linears, the flash kernel) against the same run on the CPU (plain
    versions): every prefill's logits within the CPU-vs-JAX ``dense``
    bound of every config (tests/_torch_lm_parity.py: 0.06), and the
    bucketed prefill (a 37-token prompt, bucket 64) on the card against
    the unpadded one within the same bound."""
    from repro_torch import nn
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = get_config(arch).reduced()
    bound = 0.06
    params = nn.unbox(lm.init(torch.Generator().manual_seed(0), cfg))
    rng = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab, (L,), generator=rng).tolist()
               for L in (37, 13)]
    logits = {}
    for device in ("cpu", "cuda"):
        eng = ServingEngine(cfg, params, mode="dense", batch_slots=2,
                            max_seq=64, device=device)
        seen, orig = [], lm.forward_prefill

        def spy(*a, **kw):
            out = orig(*a, **kw)
            seen.append(out[0][0, -1].float().cpu())
            return out
        lm.forward_prefill = spy
        try:
            eng.run([Request(rid=i, prompt=p, max_new_tokens=3)
                     for i, p in enumerate(prompts)])
        finally:
            lm.forward_prefill = orig
        logits[device] = seen
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert float((a - b).abs().max()) <= bound
    card = nn.to_device(params, dev)

    def prefill(width):
        cache = nn.unbox(lm.cache_init(cfg, 1, 64, device=dev))
        toks = torch.zeros((1, width), dtype=torch.long)
        toks[0, :37] = torch.tensor(prompts[0])
        batch = {"tokens": toks.to(dev)}
        if width != 37:
            batch["length"] = torch.tensor([37], dtype=torch.int32)
        return lm.forward_prefill(card, batch, cfg, cache)[0].float()
    assert float((prefill(64) - prefill(37)).abs().max()) <= bound
