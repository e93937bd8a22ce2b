"""Port parity: ``repro_torch.core.sparsity`` and the ternary helpers and
``quantization_error`` of ``repro_torch.core.quantize`` against the JAX
package's.

Every function gets the same numpy inputs on both sides, made from a
seed.  Exact where the function is: pruned weights, statistics, bitmap
packing, block masks, the ``cluster_rows`` permutation (on 80 %-pruned
INT7 codes and on the two-population case of ``test_cfmm.py``) and the
ternary decomposition.  ``quantization_error`` is a ratio of two f32
norms summed in other orders: 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core import sparsity as js
from repro_torch.core import quantize as tq
from repro_torch.core import sparsity as ts


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch runs one thread beside XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(K, N, seed):
    return np.random.RandomState(seed).randn(K, N).astype(np.float32)


def _pruned_codes(K, N, seed, sparsity=0.8):
    """The paper's recipe, on the JAX side: prune, then INT7 codes."""
    w = js.magnitude_prune(jnp.asarray(_weights(K, N, seed)), sparsity)
    return np.array(jq.quantize_int7(w).values)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.8, 0.97])
def test_magnitude_prune_equal(sparsity):
    w = _weights(48, 40, 1)
    w[::7] = np.round(w[::7] * 4) / 4          # ties at many magnitudes
    want = np.asarray(js.magnitude_prune(jnp.asarray(w), sparsity))
    got = ts.magnitude_prune(torch.from_numpy(w), sparsity).numpy()
    np.testing.assert_array_equal(got, want)
    assert ts.sparsity_stats(torch.from_numpy(got)) == \
        js.sparsity_stats(jnp.asarray(want))


def test_magnitude_prune_ties_fall_the_same_way():
    """Many equal magnitudes straddle the k-th one: all of them go."""
    w = np.array([[1.0, -1.0, 2.0, 1.0], [-1.0, 3.0, 1.0, 0.5]], np.float32)
    want = np.asarray(js.magnitude_prune(jnp.asarray(w), 0.5))
    got = ts.magnitude_prune(torch.from_numpy(w), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert int((got != 0).sum()) == 2          # only 2.0 and 3.0 stay


@pytest.mark.parametrize("K,N", [(64, 24), (96, 33)])
def test_bitmap_pack_and_unpack_equal(K, N):
    codes = _pruned_codes(K, N, 2)
    want, got = js.bitmap_pack(codes), ts.bitmap_pack(torch.from_numpy(codes))
    for f in ("bitmap", "values", "nnz_per_col"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.shape == want.shape
    assert (got.packed_bytes, got.dense_bf16_bytes) == \
        (want.packed_bytes, want.dense_bf16_bytes)
    np.testing.assert_array_equal(ts.bitmap_unpack(got), js.bitmap_unpack(want))
    np.testing.assert_array_equal(ts.bitmap_unpack(got), codes)


@pytest.mark.parametrize("block", [(4, 4), (16, 8), (32, 32)])
def test_block_mask_and_sparsity_equal(block):
    codes = _pruned_codes(64, 32, 3, sparsity=0.9)
    codes[:32, :16] = 0                        # some whole blocks empty
    np.testing.assert_array_equal(ts.block_mask(torch.from_numpy(codes), block),
                                  js.block_mask(codes, block))
    assert ts.block_sparsity(torch.from_numpy(codes), block) == \
        js.block_sparsity(codes, block)


@pytest.mark.parametrize("K,N,block_k", [(128, 64, 16), (256, 96, 32),
                                         (200, 40, 64)])
def test_cluster_rows_identical_on_pruned_int7_codes(K, N, block_k):
    codes = _pruned_codes(K, N, K + N)
    perm = ts.cluster_rows(torch.from_numpy(codes), block_k)
    np.testing.assert_array_equal(perm, js.cluster_rows(codes, block_k))
    assert sorted(perm.tolist()) == list(range(K))


def test_cluster_rows_identical_on_two_populations():
    """``test_cfmm.py``'s case: rows of two disjoint supports, shuffled;
    clustering separates them, in the same order as the JAX package."""
    rng = np.random.RandomState(0)
    w = np.zeros((128, 64), np.float32)
    rows_a = rng.choice(128, 64, replace=False)
    mask_a = np.zeros(128, bool)
    mask_a[rows_a] = True
    w[mask_a, :16] = rng.randn(64, 16)
    w[~mask_a, 48:] = rng.randn(64, 16)
    w = w[rng.permutation(128)]
    q = tq.quantize_int7(torch.from_numpy(w)).values
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jq.quantize_int7(jnp.asarray(w)).values))
    perm = ts.cluster_rows(q, block_k=32)
    np.testing.assert_array_equal(perm, js.cluster_rows(q.numpy(), 32))
    assert ts.block_sparsity(q[torch.from_numpy(perm)], (32, 16)) >= 0.6


def test_effective_ops_equal():
    codes = _pruned_codes(64, 48, 5)
    assert ts.effective_ops(torch.from_numpy(codes), 64 * 48 * 10) == \
        js.effective_ops(jnp.asarray(codes), 64 * 48 * 10)


def test_ternary_residuals_exact():
    q = np.arange(-63, 64, dtype=np.int8).reshape(-1, 1) * \
        np.ones((1, 3), np.int8)
    want = np.asarray(jq.ternary_residual_decompose(jnp.asarray(q)))
    got = tq.ternary_residual_decompose(torch.from_numpy(q))
    assert got.dtype == torch.int8 and got.shape == (127, 3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tq.ternary_residual_reconstruct(got)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), q.astype(np.int32))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jq.ternary_residual_reconstruct(
            jnp.asarray(want))))


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantization_error_agrees(axis):
    w = _weights(96, 40, 6)
    want = float(jq.quantization_error(jnp.asarray(w), axis))
    got = tq.quantization_error(torch.from_numpy(w), axis)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
