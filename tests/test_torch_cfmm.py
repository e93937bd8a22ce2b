"""Port parity: the CFMM algebra (``repro_torch.core.cfmm``) and the
``cfmm_matmul`` op against the JAX package's, bit for bit.

Every function of ``core/cfmm.py`` gets the same numpy inputs on both
sides: codes from ``quantize_int7`` of seeded normal weights, int8
activations.  ``ops.cfmm_matmul`` is held against the JAX package's
jitted op under its exact jnp lowering, with and without a scale; one
case drives |acc| past 2**24, where an f32 detour would lose bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cfmm as jcfmm
from repro.core.quantize import quantize_int7 as jquantize_int7
from repro.kernels import ops as jops
from repro_torch.core import cfmm as tcfmm
from repro_torch.core.quantize import quantize_int7
from repro_torch.kernels import cfmm_matmul as tcfmm_kernel
from repro_torch.kernels import ops as tops

SHAPES = [(1, 2, 1), (3, 17, 5), (8, 40, 24), (2, 64, 33)]


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its exact jnp lowering; torch runs one thread
    beside XLA's pool."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


def _inputs(M, K, N, seed=0):
    rng = np.random.RandomState(seed + 7 * M + 11 * K + N)
    w = rng.randn(K, N).astype(np.float32)
    codes = quantize_int7(torch.from_numpy(w)).values.numpy()
    x = rng.randint(-127, 128, (M, K)).astype(np.int8)
    return x, codes


def _eq(t, j):
    a, b = t.numpy(), np.asarray(j)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_luts_and_constants_equal():
    np.testing.assert_array_equal(tcfmm.ODD_VALUES, jcfmm.ODD_VALUES)
    np.testing.assert_array_equal(tcfmm._MAG_IDX_LUT, jcfmm._MAG_IDX_LUT)
    np.testing.assert_array_equal(tcfmm._SHIFT_LUT, jcfmm._SHIFT_LUT)
    assert (tcfmm.N_UNIQUE_PRODUCTS, tcfmm.MAX_SHIFT) == (32, 5)


def test_decompose_reconstruct_all_int7_values():
    q = np.arange(-63, 64, dtype=np.int8)
    t = tcfmm.decompose(torch.from_numpy(q))
    j = jcfmm.decompose(jnp.asarray(q))
    for a, b in zip(t, j):
        _eq(a, b)
    _eq(tcfmm.reconstruct(*t), jcfmm.reconstruct(*j))
    np.testing.assert_array_equal(tcfmm.reconstruct(*t).numpy(),
                                  q.astype(np.int32))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_pack_unpack_and_product_table_equal(M, K, N):
    x, codes = _inputs(M, K, N)
    scale = np.linspace(0.1, 1.0, N, dtype=np.float32)
    tw = tcfmm.pack(torch.from_numpy(codes), torch.from_numpy(scale))
    jw = jcfmm.pack(jnp.asarray(codes), jnp.asarray(scale))
    for f in ("sign", "mag_idx", "shift", "scale"):
        _eq(getattr(tw, f), getattr(jw, f))
    assert tuple(tw.shape) == tuple(jw.shape)
    _eq(tcfmm.unpack_int8(tw), jcfmm.unpack_int8(jw))
    _eq(tcfmm.product_table(torch.from_numpy(x)),
        jcfmm.product_table(jnp.asarray(x)))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_matmul_dataflows_bit_equal(M, K, N):
    """Product-table, decode-then-multiply (packed and raw codes) and
    bit-serial matmuls: each equal to the JAX package's and to the
    integer product."""
    x, codes = _inputs(M, K, N)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    tc, jc = torch.from_numpy(codes), jnp.asarray(codes)
    one = np.ones((1, N), np.float32)
    tw = tcfmm.pack(tc, torch.from_numpy(one))
    jw = jcfmm.pack(jc, jnp.asarray(one))
    exact = x.astype(np.int64) @ codes.astype(np.int64)
    for t, j in ((tcfmm.cfmm_matmul_exact(tx, tw),
                  jcfmm.cfmm_matmul_exact(jx, jw)),
                 (tcfmm.cfmm_matmul_int8(tx, tw),
                  jcfmm.cfmm_matmul_int8(jx, jw)),
                 (tcfmm.cfmm_matmul_int8(tx, tc),
                  jcfmm.cfmm_matmul_int8(jx, jc)),
                 (tcfmm.bitserial_matmul(tx, tc),
                  jcfmm.bitserial_matmul(jx, jc))):
        _eq(t, j)
        np.testing.assert_array_equal(t.numpy(), exact)


def test_bitserial_matmul_batched_input():
    """A leading batch axis contracts the last axis, as in the JAX
    package's ``dot_general``."""
    rng = np.random.RandomState(4)
    x = rng.randint(-127, 128, (2, 3, 16)).astype(np.int8)
    _, codes = _inputs(1, 16, 6)
    _eq(tcfmm.bitserial_matmul(torch.from_numpy(x), torch.from_numpy(codes)),
        jcfmm.bitserial_matmul(jnp.asarray(x), jnp.asarray(codes)))


@pytest.mark.parametrize("sparse", [False, True])
def test_unique_products_and_flops_accounting_equal(sparse):
    w = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    if sparse:                          # few magnitudes in use
        w = np.round(w) * 0.01
    t = quantize_int7(torch.from_numpy(w)).values
    j = jquantize_int7(jnp.asarray(w)).values
    _eq(t, j)
    assert tcfmm.unique_product_count(t) == jcfmm.unique_product_count(j)
    assert tcfmm.unique_product_count(t) <= 32
    assert tcfmm.cfmm_flops_saved(t, 2304) == jcfmm.cfmm_flops_saved(j, 2304)
    zero = torch.zeros((4, 4), dtype=torch.int8)
    assert tcfmm.unique_product_count(zero) == 0


@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("M,K,N", [(2, 64, 10), (3, 130, 7), (9, 40, 128)])
def test_cfmm_matmul_op_bit_equal(M, K, N, with_scale):
    x, codes = _inputs(M, K, N, seed=1)
    scale = (0.01 + np.random.RandomState(N).rand(1, N)).astype(np.float32)
    s = scale if with_scale else None
    j = jax.jit(lambda x, c, s: jops.cfmm_matmul(x, c, s))(x, codes, s)
    t = tops.cfmm_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                         None if s is None else torch.from_numpy(s))
    assert t.dtype == (torch.float32 if with_scale else torch.int32)
    _eq(t, j)


def test_cfmm_matmul_exact_past_f32_range():
    """|acc| = 127 * 63 * 4096 > 2**24: the int32 product stays exact
    (the port follows the jnp oracle, not the TPU path's f32 detour)."""
    K = 4096
    x = np.full((2, K), 127, np.int8)
    codes = np.full((K, 3), 63, np.int8)
    codes[0, 0] = 62                              # an odd total
    t = tcfmm_kernel.cfmm_matmul(torch.from_numpy(x), torch.from_numpy(codes))
    j = jax.jit(lambda x, c: jops.cfmm_matmul(x, c))(x, codes)
    _eq(t, j)
    assert int(t[0, 0]) == 127 * (63 * K - 1) and abs(int(t[0, 0])) > 2**24
