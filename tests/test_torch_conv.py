"""Port parity: ``repro_torch.kernels.ops.conv2d`` (CPU, plain versions)
against the JAX package's ``ops.conv2d`` under its exact jnp lowering.

The sweep covers k in {1, 3, 7} x stride in {1, 2} x shortcut {none, f32}
x ReLU +- x scalar / per-row ``x_scale`` x dense / packed weights, plus the
int8-pair shortcut on the 1x1 convs.  The JAX side runs jitted, as its serving path does; one jit per
(k, stride) computes every variant.  Expected, and asserted, bit-equal:
the int32 accumulators, ``y``, ``y_q`` and ``s_y``.  The int8-pair
shortcut is the identity block's: JAX adds ``q * s`` computed in the same
jit, which XLA fuses to ``fma(q, s, y)``; the port passes the pair.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiled_linear as jcl
from repro.kernels import bitmap as jbitmap
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import compiled_linear as tcl
from repro_torch.kernels import bitmap as tbitmap
from repro_torch.kernels import conv_implicit, conv_sparse
from repro_torch.kernels import ops as tops

N, HW, C_OUT = 2, 9, 16
GEOMS = [(1, 1), (1, 2), (3, 1), (3, 2), (7, 1), (7, 2)]


def _variants(k):
    """(shortcut, relu, x_scale kind, weights) combinations for one k.
    The int8-pair shortcut is swept on 1x1 convs: identity shortcuts feed
    only the bottleneck's 1x1 c-conv."""
    shortcuts = (None, "f32", "int8") if k == 1 else (None, "f32")
    return list(itertools.product(shortcuts, (True, False),
                                  ("scalar", "row"), ("dense", "packed")))


CASES = [(k, s) + v for k, s in GEOMS for v in _variants(k)]


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its exact jnp lowering.  Torch runs one thread:
    beside XLA's CPU thread pool, torch's own pool oversubscribes the
    cores and slows these small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(k, stride):
    """Inputs for one (k, stride): numpy arrays both packages read."""
    c_in = 3 if k == 7 else 8                  # k=7: the C=3 stem
    rng = np.random.RandomState(100 * k + stride)
    kk = c_in * k * k
    w = (rng.randn(kk, C_OUT) / np.sqrt(kk)).astype(np.float32)
    dense = tcl._compile_leaf_2d(torch.from_numpy(w), "int8", 0.8, conv_k=k)
    packed = tcl._compile_leaf_2d(torch.from_numpy(w), "sparse_cfmm", 0.5,
                                  conv_k=k)
    h_out = -(-HW // stride)
    return dict(
        c_in=c_in,
        x=rng.randint(-127, 128, (N, HW, HW, c_in)).astype(np.int8),
        codes=dense["values"].numpy(), scale_w=dense["scale"].numpy(),
        bitmap=packed["bitmap"].numpy(), values=packed["values"].numpy(),
        scale_p=packed["scale"].numpy(),
        s_scalar=np.float32(0.023),
        s_row=(0.01 + 0.02 * rng.rand(N)).astype(np.float32),
        gamma=(0.5 + rng.rand(C_OUT)).astype(np.float32),
        beta=(0.2 * rng.randn(C_OUT)).astype(np.float32),
        sc_f32=rng.randn(N, h_out, h_out, C_OUT).astype(np.float32),
        sc_q=rng.randint(-127, 128, (N, h_out, h_out, C_OUT)).astype(np.int8),
        sc_s=(0.01 + 0.02 * rng.rand(N)).astype(np.float32))


def _weights(c, kind):
    if kind == "dense":
        return c["codes"], c["scale_w"]
    return (c["bitmap"], c["values"]), c["scale_p"]


@functools.lru_cache(maxsize=None)
def _jax_outputs(k, stride):
    """Every variant's JAX outputs for one (k, stride), from one jit."""
    c = _case(k, stride)

    def run(x, codes, bitmap, values, scale_w, scale_p, s_scalar, s_row,
            gamma, beta, sc_f32, sc_q, sc_s):
        out = {"acc_dense": jref.conv2d_int8_ref(x, codes, k, stride,
                                                 layout="spatial"),
               "acc_packed": jref.conv2d_sparse_int8_ref(x, bitmap, values,
                                                         k, stride),
               "variants": []}
        eff = s_row.reshape(-1, 1, 1, 1) * scale_w.reshape(1, 1, 1, -1)
        out["oracle_dense"] = jref.conv2d_collector_ref(
            x, codes, k, stride, eff, beta, sc_f32, relu=True,
            layout="spatial")
        out["oracle_packed"] = jref.conv2d_sparse_collector_ref(
            x, bitmap, values, k, stride, eff, beta, sc_f32, relu=True)
        for sc_kind, relu, scale, kind in _variants(k):
            w = codes if kind == "dense" else (bitmap, values)
            shortcut = (None if sc_kind is None else sc_f32
                        if sc_kind == "f32" else
                        sc_q.astype(jnp.float32) * sc_s.reshape(-1, 1, 1, 1))
            kw = dict(x_scale=s_scalar if scale == "scalar" else s_row,
                      w_scale=scale_w if kind == "dense" else scale_p,
                      gamma=gamma, beta=beta, shortcut=shortcut, relu=relu,
                      w_layout="spatial")
            y = jops.conv2d(x, w, k, stride, **kw)
            y_q, s_y = jops.conv2d(x, w, k, stride, quant_out=True, **kw)
            out["variants"].append((y, y_q, s_y))
        return out

    names = ("x", "codes", "bitmap", "values", "scale_w", "scale_p",
             "s_scalar", "s_row", "gamma", "beta", "sc_f32", "sc_q", "sc_s")
    res = jax.jit(run)(*(jnp.asarray(c[n]) for n in names))
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("k,stride", GEOMS)
def test_conv_accumulators_equal(k, stride):
    c, j = _case(k, stride), _jax_outputs(k, stride)
    x = torch.from_numpy(c["x"])
    eff = torch.ones((N, C_OUT))
    zero = torch.zeros((C_OUT,))
    *_, acc = conv_implicit.conv2d_implicit(
        x, torch.from_numpy(c["codes"]), eff, zero, k=k, stride=stride,
        return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), j["acc_dense"])
    *_, acc = conv_sparse.conv2d_sparse(
        x, torch.from_numpy(c["bitmap"]), torch.from_numpy(c["values"]),
        eff, zero, k=k, stride=stride, return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), j["acc_packed"])


@pytest.mark.parametrize("k,stride,sc_kind,relu,scale,kind", CASES)
def test_conv2d_bit_equal(k, stride, sc_kind, relu, scale, kind):
    c = _case(k, stride)
    y_j, yq_j, sy_j = _jax_outputs(k, stride)["variants"][
        _variants(k).index((sc_kind, relu, scale, kind))]
    w, w_scale = _weights(c, kind)
    t = torch.from_numpy
    w = (t(w[0]), t(w[1])) if kind == "packed" else t(w)
    shortcut = {None: None, "f32": t(c["sc_f32"]),
                "int8": (t(c["sc_q"]), t(c["sc_s"]))}[sc_kind]
    kw = dict(x_scale=(torch.tensor(c["s_scalar"]) if scale == "scalar"
                       else t(c["s_row"])),
              w_scale=t(w_scale), gamma=t(c["gamma"]), beta=t(c["beta"]),
              shortcut=shortcut, relu=relu)
    y = tops.conv2d(t(c["x"]), w, k, stride, **kw)
    y_q, s_y = tops.conv2d(t(c["x"]), w, k, stride, quant_out=True, **kw)
    np.testing.assert_array_equal(y.numpy(), y_j)
    np.testing.assert_array_equal(y_q.numpy(), yq_j)
    np.testing.assert_array_equal(s_y.numpy(), sy_j)
    assert s_y.shape == sy_j.shape


@pytest.mark.parametrize("k,stride", GEOMS)
def test_collector_oracles_bit_equal(k, stride):
    """The plain fused conv + Collector oracles (per-row scale rows, f32
    shortcut, ReLU) against the JAX package's."""
    from repro_torch.kernels import ref as tref
    c, j = _case(k, stride), _jax_outputs(k, stride)
    t = torch.from_numpy
    eff = (t(c["s_row"]).reshape(-1, 1, 1, 1)
           * t(c["scale_w"]).reshape(1, 1, 1, -1))
    tail = (eff, t(c["beta"]), t(c["sc_f32"]))
    got = tref.conv2d_collector_ref(t(c["x"]), t(c["codes"]), k, stride,
                                    *tail)
    np.testing.assert_array_equal(got.numpy(), j["oracle_dense"])
    got = tref.conv2d_sparse_collector_ref(
        t(c["x"]), t(c["bitmap"]), t(c["values"]), k, stride, *tail)
    np.testing.assert_array_equal(got.numpy(), j["oracle_packed"])


@pytest.mark.parametrize("K,with_scale", [(24, False), (20, False),
                                          (20, True), (147, False)])
def test_sparse_cfmm_matmul_bit_equal(K, with_scale):
    """K % 8 != 0 exercises the pad of x to the bitmap's rows."""
    rng = np.random.RandomState(K)
    w = rng.randn(K, 11).astype(np.float32)
    leaf = tcl._compile_leaf_2d(torch.from_numpy(w), "sparse_cfmm", 0.7)
    x = rng.randint(-127, 128, (3, K)).astype(np.int8)
    scale = leaf["scale"] if with_scale else None
    j = jax.jit(lambda x, b, v, s: jops.sparse_cfmm_matmul(x, b, v, s))(
        x, leaf["bitmap"].numpy(), leaf["values"].numpy(),
        None if scale is None else scale.numpy())
    t = tops.sparse_cfmm_matmul(torch.from_numpy(x), leaf["bitmap"],
                                leaf["values"], scale)
    assert t.dtype == (torch.float32 if with_scale else torch.int32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_expand_bitmap_tile_chunks_bit_equal():
    """Chunked expansion carries the running count exactly as the JAX
    tile does (the streaming form both sparse kernels use)."""
    rng = np.random.RandomState(5)
    w = rng.randn(64, 9).astype(np.float32)
    leaf = tcl._compile_leaf_2d(torch.from_numpy(w), "sparse_cfmm", 0.6)
    bm, vals = leaf["bitmap"], leaf["values"]
    keep = vals.shape[0]
    base_t = torch.zeros((1, 9), dtype=torch.int32)
    base_j = jnp.zeros((1, 9), jnp.int32)
    for r in range(0, bm.shape[0], 2):
        wt, base_t = tbitmap.expand_bitmap_tile(bm[r:r + 2], vals, base_t,
                                                keep)
        wj, base_j = jbitmap.expand_bitmap_tile(
            jnp.asarray(bm[r:r + 2].numpy()), jnp.asarray(vals.numpy()),
            base_j, keep)
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(
        tcl.bitmap_unpack(bm, vals).numpy(),
        np.asarray(jcl.bitmap_unpack(jnp.asarray(bm.numpy()),
                                     jnp.asarray(vals.numpy()))))


def test_fma_f32_rounds_once():
    """``fma_f32`` equals the exactly rounded a*b + c, including the
    double-rounding ties that a plain f64 evaluation would get wrong."""
    from fractions import Fraction
    from repro_torch.kernels.ref import fma_f32
    rng = np.random.RandomState(0)
    a = rng.randint(-2**24, 2**24, 2000).astype(np.float32)
    b = (rng.rand(2000) * 1e-3).astype(np.float32)
    c = (rng.randn(2000)).astype(np.float32)
    # a tie case: a*b + c exactly halfway between two f32 after f64
    # rounding, with a nonzero f64 rounding error below it
    a[0], b[0], c[0] = np.float32(1 + 2**-23), np.float32(1 + 2**-23), \
        np.float32(2**-24 + 2**-47)
    got = fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        # correct rounding: the f32 nearest to exact (ties to even)
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        assert abs(Fraction(float(got[i])) - exact) == best, i


# ---------------------------------------------------------------------------
# Depthwise conv: ``ops.conv2d_dw`` against the JAX package's
# ---------------------------------------------------------------------------

DW_GEOMS = [(s, c) for s in (1, 2) for c in (8, 24, 40)]
DW_VARIANTS = list(itertools.product((None, "f32"), (True, False),
                                     ("scalar", "row")))


@functools.lru_cache(maxsize=None)
def _dw_case(stride, C):
    """Inputs for one depthwise (stride, C): the tap-major (9, C) weight
    compiled as ``compile_params`` compiles a ``dwconv`` leaf."""
    from repro_torch import nn as tnn
    rng = np.random.RandomState(1000 + 10 * C + stride)
    w = (rng.randn(9, C) / 3.0).astype(np.float32)
    leaf = tcl.compile_params({"w": tnn.Param(torch.from_numpy(w),
                                              ("conv_in", "conv_out"),
                                              tnn.dwconv_kind(3, stride))},
                              mode="int8")["w"]
    assert leaf["geom"] == tcl.ConvGeom(3, stride, 1, dw=True)
    h_out = -(-HW // stride)
    return dict(
        x=rng.randint(-127, 128, (N, HW, HW, C)).astype(np.int8),
        values=leaf["values"].value.numpy(),
        scale_w=leaf["scale"].value.numpy(),
        s_scalar=np.float32(0.031),
        s_row=(0.01 + 0.02 * rng.rand(N)).astype(np.float32),
        gamma=(0.5 + rng.rand(C)).astype(np.float32),
        beta=(0.2 * rng.randn(C)).astype(np.float32),
        sc_f32=rng.randn(N, h_out, h_out, C).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _dw_jax_outputs(stride, C):
    """Every depthwise variant's JAX outputs for one (stride, C), from one
    jit, plus the int32 accumulators and the fused oracle."""
    c = _dw_case(stride, C)

    def run(x, values, scale_w, s_scalar, s_row, gamma, beta, sc_f32):
        eff = s_row.reshape(-1, 1, 1, 1) * scale_w.reshape(1, 1, 1, -1)
        out = {"acc": jref.conv2d_dw_int8_ref(x, values, 3, stride),
               "oracle": jref.conv2d_dw_collector_ref(
                   x, values, 3, stride, eff, beta, sc_f32, relu=True),
               "variants": []}
        for sc_kind, relu, scale in DW_VARIANTS:
            kw = dict(x_scale=s_scalar if scale == "scalar" else s_row,
                      w_scale=scale_w, gamma=gamma, beta=beta,
                      shortcut=sc_f32 if sc_kind else None, relu=relu)
            y = jops.conv2d_dw(x, values, 3, stride, **kw)
            y_q, s_y = jops.conv2d_dw(x, values, 3, stride, quant_out=True,
                                      **kw)
            out["variants"].append((y, y_q, s_y))
        return out

    names = ("x", "values", "scale_w", "s_scalar", "s_row", "gamma", "beta",
             "sc_f32")
    res = jax.jit(run)(*(jnp.asarray(c[n]) for n in names))
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("stride,C", DW_GEOMS)
def test_conv_dw_accumulators_and_oracle_equal(stride, C):
    from repro_torch.kernels import conv_depthwise
    from repro_torch.kernels import ref as tref
    c, j = _dw_case(stride, C), _dw_jax_outputs(stride, C)
    t = torch.from_numpy
    *_, acc = conv_depthwise.conv2d_dw(
        t(c["x"]), t(c["values"]), torch.ones((N, C)), torch.zeros((C,)),
        k=3, stride=stride, return_acc=True)
    np.testing.assert_array_equal(acc.numpy(), j["acc"])
    eff = (t(c["s_row"]).reshape(-1, 1, 1, 1)
           * t(c["scale_w"]).reshape(1, 1, 1, -1))
    got = tref.conv2d_dw_collector_ref(t(c["x"]), t(c["values"]), 3, stride,
                                       eff, t(c["beta"]), t(c["sc_f32"]))
    np.testing.assert_array_equal(got.numpy(), j["oracle"])


@pytest.mark.parametrize("sc_kind,relu,scale", DW_VARIANTS)
@pytest.mark.parametrize("stride,C", DW_GEOMS)
def test_conv2d_dw_bit_equal(stride, C, sc_kind, relu, scale):
    c = _dw_case(stride, C)
    y_j, yq_j, sy_j = _dw_jax_outputs(stride, C)["variants"][
        DW_VARIANTS.index((sc_kind, relu, scale))]
    t = torch.from_numpy
    kw = dict(x_scale=(torch.tensor(c["s_scalar"]) if scale == "scalar"
                       else t(c["s_row"])),
              w_scale=t(c["scale_w"]), gamma=t(c["gamma"]),
              beta=t(c["beta"]), relu=relu,
              shortcut=t(c["sc_f32"]) if sc_kind else None)
    y = tops.conv2d_dw(t(c["x"]), t(c["values"]), 3, stride, **kw)
    y_q, s_y = tops.conv2d_dw(t(c["x"]), t(c["values"]), 3, stride,
                              quant_out=True, **kw)
    np.testing.assert_array_equal(y.numpy(), y_j)
    np.testing.assert_array_equal(y_q.numpy(), yq_j)
    np.testing.assert_array_equal(s_y.numpy(), sy_j)
    assert s_y.shape == sy_j.shape


# ---------------------------------------------------------------------------
# Depthwise zero counts (``zero_count=``): the port against JAX's dict
# ---------------------------------------------------------------------------

DW_ZC = list(itertools.product((4, 8), (False, True)))


@functools.lru_cache(maxsize=None)
def _dw_zc_jax(stride, C):
    """JAX ``ops.conv2d_dw(zero_count=g)`` for every (g, quant_out) of
    ``DW_ZC`` at one (stride, C), per-row scales, ReLU, from one jit."""
    c = _dw_case(stride, C)

    def run(x, values, scale_w, s_row, gamma, beta):
        out = []
        for g, quant_out in DW_ZC:
            out.append(jops.conv2d_dw(x, values, 3, stride, x_scale=s_row,
                                      w_scale=scale_w, gamma=gamma,
                                      beta=beta, relu=True,
                                      quant_out=quant_out, zero_count=g))
        return out

    names = ("x", "values", "scale_w", "s_row", "gamma", "beta")
    res = jax.jit(run)(*(jnp.asarray(c[n]) for n in names))
    return jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("g,quant_out", DW_ZC)
@pytest.mark.parametrize("stride,C", DW_GEOMS)
def test_conv2d_dw_zero_counts_equal(stride, C, g, quant_out):
    """Every key of the zero-count dict, and y or (y_q, s_y), equal JAX's
    under its exact jnp lowering."""
    c = _dw_case(stride, C)
    want = _dw_zc_jax(stride, C)[DW_ZC.index((g, quant_out))]
    t = torch.from_numpy
    got = tops.conv2d_dw(t(c["x"]), t(c["values"]), 3, stride,
                         x_scale=t(c["s_row"]), w_scale=t(c["scale_w"]),
                         gamma=t(c["gamma"]), beta=t(c["beta"]), relu=True,
                         quant_out=quant_out, zero_count=g)
    assert len(got) == len(want) == (3 if quant_out else 2)
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a.numpy(), b)
    zc, zc_j = got[-1], want[-1]
    assert sorted(zc) == sorted(zc_j)
    for key in zc:
        assert zc[key].dtype == torch.float32
        assert tuple(zc[key].shape) == zc_j[key].shape, key
        np.testing.assert_array_equal(zc[key].numpy(), zc_j[key])
    assert float(zc["row_zeros"].min()) > 0
    assert g > 4 or float(zc["group_allzero"].sum()) > 0


@pytest.mark.parametrize("g", [1, 2, 4, 8, 24])
def test_zero_counts_ref_matches_jax(g):
    """The port's ``ref.zero_counts_ref`` against JAX's on the same y:
    a ReLU'd map with whole zero groups planted."""
    from repro_torch.kernels import ref as tref
    rng = np.random.RandomState(g)
    y = np.maximum(rng.randn(2, 5, 3, 24), 0).astype(np.float32)
    y[0, 1, :, :g] = 0.0
    y[1, :, 2, -g:] = 0.0
    got = tref.zero_counts_ref(torch.from_numpy(y), g)
    want = jax.tree.map(np.asarray, jref.zero_counts_ref(jnp.asarray(y), g))
    assert sorted(got) == sorted(want)
    for key in got:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    with pytest.raises(ValueError):
        tref.zero_counts_ref(torch.from_numpy(y), 5)
