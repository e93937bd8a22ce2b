"""Port parity of the CNN zoo's dense reference forwards (the ``dense``
serve mode): ``resnet.apply``, ``mobilenet_v2.apply`` and
``repvgg.apply`` (fused and unfused) on unboxed float trees, against the
JAX package's dense ``apply`` (jitted, ``REPRO_PALLAS=jnp``), on the same
f32 weights carried across with ``params_from_numpy``.

* The im2col patch order: with an identity weight the dense conv returns
  its patches, which equal ``jax.lax.conv_general_dilated_patches`` bit
  for bit, at k = 3 and 7 with c_in = 3 (channel-major: c_in slowest),
  at stride 1 and 2 on even and odd maps (SAME pads more at the end at
  stride 2).
* The dense forwards within ``F32_BOUND`` of JAX's: both sum the same
  f32 products in other orders (measured max |dlogit| / max |logit|
  3.3e-7 ResNet50, 6.6e-7 MobileNetV2, 8.6e-7 / 1.2e-6 RepVGG fused /
  unfused).
* The residual block of JAX's ``test_serve_modes.py``: the port's dense
  block against JAX's, and every compiled mode of the port within its
  own 0.08 relative error of the dense block (``sparse_cfmm`` on the
  pruned weights its packed leaves carry).
* RepVGG: the fused dense chain against the unfused three branches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.core import compiled_linear as jcl
from repro.models import mobilenet_v2 as jmb
from repro.models import repvgg as jrv
from repro.models import resnet as jres
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import mobilenet_v2 as tmb
from repro_torch.models import repvgg as trv
from repro_torch.models import resnet as tres
from test_torch_zoo import _perturb_bn

# max |dlogit| allowed, relative to max |logit|: the same f32 products
# summed in other orders (measured at most 1.2e-6, see the docstring)
F32_BOUND = 1e-5
HW = 24                          # 24 -> 12 -> 6 -> 3 -> 2 -> 1: odd maps
MODELS = {
    "resnet50": (jres, tres, jres.ResNetConfig(0.125, 10, HW),
                 tres.ResNetConfig(0.125, 10, HW)),
    "mobilenet_v2": (jmb, tmb, jmb.MobileNetV2Config(0.25, 10, HW),
                     tmb.MobileNetV2Config(0.25, 10, HW)),
    "repvgg_a0": (jrv, trv, jrv.RepVGGConfig(0.25, 10, HW),
                  trv.RepVGGConfig(0.25, 10, HW)),
}


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
def images():
    return np.random.RandomState(0).randn(2, HW, HW, 3).astype(np.float32)


_trees = {}


def _dense_trees(model):
    """(JAX boxed float tree, port boxed float tree): JAX ``init`` with
    folded-BN scales and biases perturbed from a seed, carried across."""
    if model not in _trees:
        jmod, _, jcfg, _ = MODELS[model]
        jt = jax.jit(jmod.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
        jt = _perturb_bn(jt, np.random.RandomState(1))
        _trees[model] = (jt, tnn.params_from_numpy(jt))
    return _trees[model]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# The im2col conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,hw", [(3, 1, 7), (3, 2, 8), (3, 2, 7),
                                         (7, 1, 9), (7, 2, 16), (7, 2, 15),
                                         (1, 2, 7)])
def test_conv_patches_equal_jax_patches(k, stride, hw):
    """With an identity weight (c_out = c_in*k*k) and no Collector the
    dense conv returns its im2col patches: equal, bit for bit, to JAX's
    ``conv_general_dilated_patches`` (k = 1: the strided slice), so the
    feature order (c_in slowest, then kh, kw) and the SAME padding
    (stride 2: (0, 1) on an even map, (1, 1) on an odd one at k = 3)
    match."""
    c_in = 3
    x = np.random.RandomState(k + hw).randn(2, hw, hw, c_in).astype(
        np.float32)
    n = c_in * k * k
    p = {"w": np.eye(n, dtype=np.float32), "scale": np.ones(n, np.float32),
         "bias": np.zeros(n, np.float32)}
    want = np.asarray(jres._conv_apply(
        {key: jnp.asarray(v) for key, v in p.items()}, jnp.asarray(x), k,
        stride, relu=False))
    got = tres._conv_apply({key: torch.from_numpy(v) for key, v in p.items()},
                           torch.from_numpy(x), k, stride, relu=False)
    assert got.shape == want.shape == (2, -(-hw // stride), -(-hw // stride),
                                       n)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The zoo's dense forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,fused", [("resnet50", False),
                                         ("mobilenet_v2", False),
                                         ("repvgg_a0", False),
                                         ("repvgg_a0", True)])
def test_dense_forward_matches_jax(images, model, fused):
    jmod, tmod, jcfg, tcfg = MODELS[model]
    jt, tt = _dense_trees(model)
    if fused:
        jt, tt = jcfg.fuse(jt), tcfg.fuse(tt)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=2)(
        jnn.unbox(jt), jnp.asarray(images), jcfg))
    got = tmod.apply(tnn.unbox(tt), torch.from_numpy(images), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 10)
    assert _rel(got.numpy(), want) <= F32_BOUND, (model, fused)


def test_repvgg_fused_dense_equals_unfused_branches(images):
    """ROADMAP A9's gate: the fold against the three float branches it
    replaces (3x3, the 1x1 on its centre tap, the identity BN), through
    the whole network, in the port alone."""
    _, tt = _dense_trees("repvgg_a0")
    cfg = MODELS["repvgg_a0"][3]
    x = torch.from_numpy(images)
    unfused = trv.apply(tnn.unbox(tt), x, cfg)
    fused = trv.apply(tnn.unbox(trv.fuse_params(tt, cfg)), x, cfg)
    assert _rel(fused.numpy(), unfused.numpy()) <= F32_BOUND


def test_compile_params_dense_returns_the_tree():
    jt, tt = _dense_trees("mobilenet_v2")
    assert tcl.compile_params(tt, mode="dense") is tt
    assert jcl.compile_params(jt, mode="dense") is jt
    served = tcl.ensure_compiled(tt, "dense", 0.8)
    w = tt["blocks"][0]["dw"]["w"].value
    assert served["blocks"][0]["dw"]["w"] is w      # unboxed, not copied


# ---------------------------------------------------------------------------
# The residual block of test_serve_modes.py
# ---------------------------------------------------------------------------

IN_CH, MID, OUT = 8, 8, 16
H, W = 7, 9                            # odd-spatial corner


def _block_params(k, stride, seed=0):
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 7 * k), 8))
    return {
        "a": jres._conv_init(next(keys), IN_CH, MID, 1),
        "b": jres._conv_init(next(keys), MID, MID, k, stride=stride),
        "c": jres._conv_init(next(keys), MID, OUT, 1),
        "sc": jres._conv_init(next(keys), IN_CH, OUT, 1, stride=stride),
    }


def _port_block(params, x, k, stride):
    """The port's residual block, dense or compiled by the leaf form —
    test_serve_modes.py's ``_block_forward``."""
    if not isinstance(params["a"]["w"], dict):     # dense
        sc = tres._conv_apply(params["sc"], x, 1, stride, relu=False)
        y = tres._conv_apply(params["a"], x, 1)
        y = tres._conv_apply(params["b"], y, k, stride)
        return tres._conv_apply(params["c"], y, 1, relu=True, shortcut=sc)
    x_q, s = tcl.act_quant(x, per_row=True)

    def conv(name, xq, xs, **kw):
        p = params[name]
        return tcl.apply_conv(p["w"], xq, xs, gamma=p["scale"],
                              beta=p["bias"], **kw)
    sc = conv("sc", x_q, s, relu=False)
    a_q, s_a = conv("a", x_q, s, quant_out=True)
    b_q, s_b = conv("b", a_q, s_a, quant_out=True)
    return conv("c", b_q, s_b, shortcut=sc, relu=True)


@pytest.fixture(scope="module")
def block_x():
    return np.array(jax.random.normal(jax.random.PRNGKey(1),
                                      (2, H, W, IN_CH)) * 0.5)


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2), (7, 2)])
def test_dense_block_matches_jax(block_x, k, stride):
    jp = _block_params(k, stride)
    tp = tnn.unbox(tnn.params_from_numpy(jp))
    jd = jnn.unbox(jp)
    xj = jnp.asarray(block_x)
    sc = jres._conv_apply(jd["sc"], xj, 1, stride, relu=False)
    y = jres._conv_apply(jd["a"], xj, 1)
    y = jres._conv_apply(jd["b"], y, k, stride)
    want = np.asarray(jres._conv_apply(jd["c"], y, 1, relu=True,
                                       shortcut=sc))
    got = _port_block(tp, torch.from_numpy(block_x), k, stride).numpy()
    assert got.shape == want.shape == (2, -(-H // stride), -(-W // stride),
                                       OUT)
    assert _rel(got, want) <= F32_BOUND


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_block_modes_within_quant_tolerance_of_dense(block_x, mode):
    """Every compiled mode's block output within 0.08 relative error of
    the dense block, all in the port (JAX ``test_serve_modes.py``'s
    anchor); ``sparse_cfmm`` against the dense block on the pruned
    weights its packed leaves carry (JAX's ``packed_codes`` of the same
    bytes: tier 1 of the compile parity)."""
    k, stride = 3, 1
    jp = _block_params(k, stride)
    tp = tnn.params_from_numpy(jp)
    served = tnn.unbox(tcl.compile_params(tp, mode=mode, sparsity=0.5))
    dense = tnn.unbox(tp)
    if mode == "sparse_cfmm":
        jserved = jnn.unbox(jcl.compile_params(jp, mode=mode, sparsity=0.5))
        for name in ("a", "b", "c", "sc"):
            w = jserved[name]["w"]
            wd = np.asarray(jcl.packed_codes(w), np.float32) \
                * np.asarray(w["scale"])
            dense[name]["w"] = torch.from_numpy(wd)
    x = torch.from_numpy(block_x)
    want = _port_block(dense, x, k, stride)
    got = _port_block(served, x, k, stride)
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    assert rel < 0.08, (mode, rel)
