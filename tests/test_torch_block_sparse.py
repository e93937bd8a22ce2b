"""Port parity of the block-sparse constant-weight matmul: ``plan_blocks``,
``ops.block_sparse_matmul`` on the CPU (the kernel's plain version,
``ref.block_sparse_matmul_plain``) and the row-major oracle
``ref.block_sparse_matmul_ref``, against the JAX package's.

``ops.block_sparse_matmul`` is held against the JAX op under both of its
lowerings: ``REPRO_PALLAS=jnp`` (a dense product of the masked weights)
and ``interpret`` (the Pallas kernel's own function, one f32 block
product at a time).  Shapes: the JAX test's three, ragged M = 98 and a
block that is no power of two, (48, 80).  Inputs are made with numpy
from a seed, with whole zero blocks as the JAX test makes them.
Tolerances: f32 2e-5 relative + 2e-4 absolute (the JAX test's: the same
sum in another order); bf16 one bf16 ulp of the JAX output on top of that
f32 tolerance (both sides round an f32 sum once, and the two sums may
differ by the f32 tolerance before the rounding, which near zero is
many bf16 ulps).  Measured with jax 0.9.0: f32 equal to the interpreted
Pallas kernel bit for bit (the plain version sums the same f32 block
products in the same order) and within 5.2e-5 of the jnp lowering
(|y| up to 86); bf16 within one ulp of both, bar one output of
|y| < 0.5 off the interpreted kernel by 0.0078.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as js
from repro.kernels import block_sparse as jbs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import sparsity as ts
from repro_torch.core.quantize import quantize_int7
from repro_torch.kernels import block_sparse as tbs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL, ATOL = 2e-5, 2e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (M, K, N, block): the JAX test's shapes, ragged M, an odd block
SHAPES = [(64, 512, 256, (128, 128)), (128, 256, 384, (128, 128)),
          (8, 256, 128, (128, 128)), (98, 256, 256, (64, 64)),
          (40, 480, 400, (48, 80))]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch runs one thread beside XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(M, K, N, block, seed=7):
    """x and w as test_kernels.py makes them: normal values, whole
    (bk, bn) blocks zeroed (a corner block and, where K allows, a whole
    row of blocks), so some block columns lose blocks."""
    bk, bn = block
    rng = np.random.RandomState(seed + M + K + N)
    w = rng.randn(K, N).astype(np.float32)
    w[:bk, :bn] = 0.0
    if K >= 4 * bk:
        w[2 * bk:3 * bk, :] = 0.0
    x = rng.randn(M, K).astype(np.float32)
    return x, w


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |a| (8 significant bits)."""
    mag = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _assert_close(got: torch.Tensor, want, dtype: str):
    g = got.float().numpy()
    w = np.asarray(want).astype(np.float32)
    assert g.shape == w.shape
    tol = ATOL + RTOL * np.abs(w)
    if dtype == "bfloat16":
        tol = tol + _bf16_ulp(w)
    err = np.abs(g - w)
    assert (err <= tol).all(), f"max |d| {err.max():.3g} ({dtype})"


@pytest.mark.parametrize("seed", range(4))
def test_plan_blocks_equal(seed):
    rng = np.random.RandomState(seed)
    mask = rng.rand(6, 5) < 0.4
    mask[:, 1] = False                          # an empty block column
    np.testing.assert_array_equal(tbs.plan_blocks(mask),
                                  jbs.plan_blocks(mask))


def test_plan_blocks_all_empty_and_the_jax_example():
    empty = np.zeros((3, 4), bool)
    assert tbs.plan_blocks(empty).shape == (4, 0)
    np.testing.assert_array_equal(tbs.plan_blocks(empty),
                                  jbs.plan_blocks(empty))
    mask = np.zeros((4, 3), bool)
    mask[0, 0] = mask[2, 0] = mask[1, 2] = True
    meta = tbs.plan_blocks(mask)
    np.testing.assert_array_equal(meta, jbs.plan_blocks(mask))
    np.testing.assert_array_equal(meta, [[0, 2, 1], [0, 0, 2], [1, 0, 1],
                                         [0, 1, 1]])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,K,N,block", SHAPES,
                         ids=[f"{m}x{k}x{n}-{b[0]}x{b[1]}"
                              for m, k, n, b in SHAPES])
def test_block_sparse_matmul_matches_jax(monkeypatch, M, K, N, block, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w = _inputs(M, K, N, block)
    xt = torch.from_numpy(x).to(tdt)
    got = tops.block_sparse_matmul(xt, torch.from_numpy(w), block)
    assert got.dtype == tdt and got.shape == (M, N)
    mask = js.block_mask(w, block)
    assert not mask.all()                       # blocks really were dropped
    col_empty = np.repeat(~mask.any(axis=0), block[1])
    assert (got.float().numpy()[:, col_empty] == 0).all()
    for mode in ("jnp", "interpret"):
        monkeypatch.setenv("REPRO_PALLAS", mode)
        want = jops.block_sparse_matmul(jnp.asarray(x, jdt), jnp.asarray(w),
                                        block)
        assert want.dtype == jdt
        _assert_close(got, want, dtype)


def test_empty_block_columns_are_exact_zeros():
    x, w = _inputs(10, 128, 192, (32, 64), seed=3)
    w[:, 64:128] = 0.0                          # block column 1 empty
    w[:, 130] = 0.0
    y = tops.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 (32, 64))
    assert torch.equal(y[:, 64:128], torch.zeros(10, 64))
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=RTOL, atol=ATOL)


def test_all_empty_mask_returns_zeros_without_the_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an empty mask reached the kernel's wrapper")

    monkeypatch.setattr(tbs, "block_sparse_matmul", refuse)
    x = torch.randn(5, 64, dtype=torch.bfloat16)
    y = tops.block_sparse_matmul(x, torch.zeros(64, 32), (32, 32))
    assert y.dtype == torch.bfloat16 and torch.equal(y, torch.zeros(5, 32,
                                                     dtype=torch.bfloat16))


def test_refusals_match_the_jax_op():
    x = torch.zeros(4, 96)
    with pytest.raises(AssertionError):
        tops.block_sparse_matmul(x, torch.ones(96, 64), (64, 64))
    with pytest.raises(AssertionError):
        jops.block_sparse_matmul(jnp.zeros((4, 96)), jnp.ones((96, 64)),
                                 (64, 64))
    with pytest.raises(NotImplementedError, match="int8"):
        tops.block_sparse_matmul(torch.ones(4, 64, dtype=torch.int8),
                                 torch.ones(64, 64), (32, 32))
    with pytest.raises(ValueError, match="does not match"):
        tops.block_sparse_matmul(torch.zeros(4, 32), torch.ones(64, 64),
                                 (32, 32))


def test_bf16_weights_round_before_the_product():
    """The JAX op casts w to x's type first: a weight that bf16 cannot
    hold rounds, and the sum is then f32, rounded once.  Here
    x0 w0 + x1 w1 = 1 * (1 + 2**-9) - 1 * 1 is 2**-9 in f32, and 0 once
    w0 has rounded to 1."""
    w = np.zeros((64, 64), np.float32)
    w[0, 0], w[1, 0] = 1.0 + 2.0 ** -9, 1.0
    x = np.zeros((2, 64), np.float32)
    x[:, 0], x[:, 1] = 1.0, -1.0
    y = tops.block_sparse_matmul(torch.from_numpy(x).bfloat16(),
                                 torch.from_numpy(w), (64, 64))
    y32 = tops.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   (64, 64))
    assert float(y[0, 0]) == 0.0 and float(y32[0, 0]) == 2.0 ** -9
    want = jops.block_sparse_matmul(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(w), (64, 64))
    assert float(want[0, 0]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_row_major_ref_matches_jax(dtype):
    """``block_sparse_matmul_ref`` takes its blocks in ROW-major mask
    order, unlike the plan; fed so, it equals the JAX oracle."""
    rng = np.random.RandomState(11)
    bk, bn = 16, 8
    mask = rng.rand(4, 5) < 0.5
    mask[0, 0] = mask[3, 4] = True
    kb, nb = np.nonzero(mask)                   # row-major
    if dtype == "int8":
        blocks = rng.randint(-63, 64, (len(kb), bk, bn)).astype(np.int8)
        x = rng.randint(-127, 128, (6, 4 * bk)).astype(np.int8)
    else:
        blocks = rng.randn(len(kb), bk, bn).astype(np.float32)
        x = rng.randn(6, 4 * bk).astype(np.float32)
    got = tref.block_sparse_matmul_ref(torch.from_numpy(x),
                                       torch.from_numpy(blocks), (bk, bn),
                                       mask)
    want = np.asarray(jref.block_sparse_matmul_ref(
        jnp.asarray(x), jnp.asarray(blocks), (bk, bn), mask))
    assert got.numpy().dtype == want.dtype
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_version_on_plan_ordered_blocks_equals_dense():
    """The kernel's operands through ``pack_blocks``: the plain version
    equals the dense product of the masked weights, and the row-major
    oracle would need the blocks in another order."""
    x, w = _inputs(33, 192, 160, (64, 32), seed=5)
    mask = js.block_mask(w, (64, 32))
    p = tbs.pack_blocks(torch.from_numpy(w), (64, 32), torch.float32, "cpu")
    np.testing.assert_array_equal(p.mask, mask)
    assert p.n_active == int(mask.sum()) and p.offsets[-1] == p.n_active
    np.testing.assert_array_equal(p.meta.numpy(), jbs.plan_blocks(mask))
    y = tbs.block_sparse_matmul(torch.from_numpy(x), p.w_blocks, p.meta,
                                p.offsets, p.block_kn, p.n_blocks_n)
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block_k", [16, 32])
def test_product_invariant_under_cluster_rows(block_k):
    """The paper's recipe: prune to 80 %, INT7 codes, cluster rows; the
    permuted product (w's rows and x's columns alike) is the product."""
    rng = np.random.RandomState(block_k)
    w = ts.magnitude_prune(torch.from_numpy(
        rng.randn(128, 64).astype(np.float32)), 0.8)
    codes = quantize_int7(w).values
    perm = torch.from_numpy(ts.cluster_rows(codes, block_k))
    x = torch.from_numpy(rng.randn(9, 128).astype(np.float32))
    y = tops.block_sparse_matmul(x[:, perm], w[perm], (block_k, 16))
    np.testing.assert_allclose(y.numpy(), (x @ w).numpy(), rtol=RTOL,
                               atol=ATOL)
