"""Port parity: ``repro_torch`` constant-parameter compilation against
the JAX package's, byte for byte, and the parameter carry-across.

The JAX tree comes from ``repro.models.resnet.init``; ``params_from_numpy``
carries it into the port, and both packages compile it.  Codes, scales,
bitmap, values and the spatial-major row order must be the same bytes.
The JAX side compiles eagerly, as its serving engine does
(``ensure_compiled``).  Every layer of this small ResNet is 8 to 32
channels wide, which keeps the JAX package's eager compile short while
covering every leaf kind: the 7x7 stem (K = 147, padded to 152 for the
bitmap), 3x3 and 1x1 convs, strided projections and the linear head, in
all four ported serve modes.
"""
import jax
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.core import compiled_linear as jcl
from repro.models import resnet as jres
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.core import quantize as tq
from repro_torch.kernels import ref as tref

CFG = jres.ResNetConfig(width_mult=1 / 64, num_classes=10, in_hw=16)


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


@pytest.fixture(scope="module")
def jax_tree():
    return jax.jit(jres.init, static_argnums=1)(jax.random.PRNGKey(0), CFG)


def _is_jparam(x):
    return isinstance(x, jnn.Param)


def _assert_same(j, t, path="params"):
    """Walk a JAX tree and a port tree side by side: same structure,
    same Param axes/kinds, arrays byte-equal with equal dtypes."""
    if _is_jparam(j):
        assert isinstance(t, tnn.Param), path
        assert tuple(j.axes) == tuple(t.axes) and j.kind == t.kind, path
        _assert_same(j.value, t.value, path)
    elif isinstance(j, dict):
        assert isinstance(t, dict) and set(j) == set(t), path
        for k in j:
            _assert_same(j[k], t[k], f"{path}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, jcl.ConvGeom):
        assert (j.k, j.stride, j.c_in, j.dw) == (t.k, t.stride, t.c_in,
                                                 t.dw), path
    else:
        a, b = np.asarray(j), t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_compile_params_byte_equal(jax_tree, mode):
    j = jcl.compile_params(jax_tree, mode=mode, sparsity=0.8)
    t = tcl.compile_params(tnn.params_from_numpy(jax_tree), mode=mode,
                           sparsity=0.8)
    _assert_same(j, t)


def test_params_carry_across_round_trip(jax_tree):
    """JAX tree -> port -> numpy -> JAX Params: shapes, kinds, axes and
    values survive bit for bit."""
    port = tnn.params_from_numpy(jax_tree)
    _assert_same(jax_tree, port)
    back = tnn.params_to_numpy(port)

    def rebox(j, b):
        if _is_jparam(j):
            value, axes, kind = b
            return jnn.Param(jax.numpy.asarray(value), tuple(axes), kind)
        if isinstance(j, dict):
            return {k: rebox(j[k], b[k]) for k in j}
        return [rebox(x, y) for x, y in zip(j, b)]

    rebuilt = rebox(jax_tree, back)
    leaves_a = jax.tree.leaves(jax_tree, is_leaf=_is_jparam)
    leaves_b = jax.tree.leaves(rebuilt, is_leaf=_is_jparam)
    assert len(leaves_a) == len(leaves_b)
    for a, b in zip(leaves_a, leaves_b):
        assert a.axes == b.axes and a.kind == b.kind
        assert np.asarray(a.value).tobytes() == np.asarray(b.value).tobytes()


def test_ensure_compiled_passes_compiled_tree_through(jax_tree):
    compiled = tcl.ensure_compiled(tnn.params_from_numpy(jax_tree), "int8",
                                   0.8)
    assert tcl.ensure_compiled(compiled, "int8", 0.8) is compiled


@pytest.mark.parametrize("mode", ["dense"])
def test_unported_modes_raise(jax_tree, mode):
    """Every serve mode of the JAX package is ported: ``dense`` (which
    raised before it was) returns the tree as it is, as JAX's does; a
    mode neither package has raises."""
    tree = tnn.params_from_numpy(jax_tree)
    assert tcl.compile_params(tree, mode=mode) is tree
    assert jcl.compile_params(jax_tree, mode=mode) is jax_tree
    assert set(tcl.SERVE_MODES) == set(jcl.SERVE_MODES)
    with pytest.raises(ValueError, match="serve mode"):
        tcl.compile_params(tree, mode="fp4")


@pytest.mark.parametrize("K,N,keep", [(16, 5, 8), (152, 7, 32), (64, 3, 64)])
def test_bitmap_pack_unpack_byte_equal(K, N, keep):
    rng = np.random.RandomState(K + N)
    w = rng.randn(K, N).astype(np.float32)
    jq = jcl.balanced_prune_codes(jax.numpy.asarray(w), keep)
    tqv = tcl.balanced_prune_codes(torch.from_numpy(w), keep)
    assert np.asarray(jq.values).tobytes() == tqv.values.numpy().tobytes()
    assert np.asarray(jq.scale).tobytes() == tqv.scale.numpy().tobytes()
    jb, jv = jcl.bitmap_pack(jq.values, keep)
    tb, tv = tcl.bitmap_pack(tqv.values, keep)
    assert np.asarray(jb).tobytes() == tb.numpy().tobytes()
    assert np.asarray(jv).tobytes() == tv.numpy().tobytes()
    np.testing.assert_array_equal(tcl.bitmap_unpack(tb, tv).numpy(),
                                  tqv.values.numpy())


def test_balanced_prune_ties_break_like_jax():
    """Equal magnitudes (and both signs of them) rank by row, as the JAX
    package's double stable argsort does."""
    w = np.array([[1, -2], [-1, 2], [1, 0], [0.5, -2], [-1, 2],
                  [1, 1], [0, 0], [-0.5, 2]], np.float32)
    j = jcl.balanced_prune_codes(jax.numpy.asarray(w), 3)
    t = tcl.balanced_prune_codes(torch.from_numpy(w), 3)
    np.testing.assert_array_equal(np.asarray(j.values), t.values.numpy())


@pytest.mark.parametrize("per_row", [False, True])
def test_quantizers_match_jax(per_row):
    from repro.core import quantize as jq
    rng = np.random.RandomState(3)
    w = (rng.randn(24, 6) * rng.rand(1, 6) * 10).astype(np.float32)
    a, b = jq.quantize_int7(jax.numpy.asarray(w)), tq.quantize_int7(
        torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(a.values), b.values.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())
    x = (rng.randn(3, 4, 4, 5) * 4).astype(np.float32)
    a = jq.quantize_act_int8(jax.numpy.asarray(x), per_row=per_row)
    b = tq.quantize_act_int8(torch.from_numpy(x), per_row=per_row)
    np.testing.assert_array_equal(np.asarray(a.values), b.values.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())


@pytest.mark.parametrize("k,c_in", [(1, 8), (3, 4), (7, 3)])
def test_spatial_major_round_trip(k, c_in):
    from repro.kernels import ref as jref
    codes = np.arange(c_in * k * k * 5, dtype=np.int32).reshape(-1, 5)
    j = np.asarray(jref.to_spatial_major(jax.numpy.asarray(codes), k, c_in))
    t = tref.to_spatial_major(torch.from_numpy(codes), k, c_in)
    np.testing.assert_array_equal(j, t.numpy())
    np.testing.assert_array_equal(
        tref.from_spatial_major(t, k, c_in).numpy(), codes)


def _compile_leaf_list_then_stack(p, mode, sparsity):
    """The stacked-leaf compile ``_compile_leaf`` replaced (a list of
    per-slice results, then ``torch.stack``: two copies of the largest
    output at its peak), for linear leaves: the bytes to hold it to."""
    w = p.value.float()
    slices = [tcl._compile_leaf_2d(wi, mode, sparsity)
              for wi in w.reshape((-1,) + tuple(w.shape[-2:]))]
    return {k: torch.stack([o[k] for o in slices]).reshape(
        tuple(w.shape[:-2]) + tuple(slices[0][k].shape)) for k in slices[0]}


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_stacked_leaf_compiles_like_list_then_stack(mode):
    """A (layers, experts, K, N) leaf compiles slice by slice into
    outputs allocated once: the same keys, shapes, dtypes and bytes as
    the list-then-stack compile."""
    gen = torch.Generator().manual_seed(7)
    p = tnn.Param(torch.randn((3, 2, 64, 48), generator=gen),
                  ("layers", "experts_stack", "embed", "ffn_in"), "linear")
    got = tcl._compile_leaf(p, mode, 0.8)
    want = _compile_leaf_list_then_stack(p, mode, 0.8)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].axes[:2] == ("layers", "experts_stack"), k
        g = got[k].value
        assert g.dtype == v.dtype and g.shape == v.shape, k
        assert torch.equal(g, v), k
