"""Port parity for the rest of the CNN zoo: MobileNetV2 and RepVGG-A0.

JAX ``init`` trees (folded-BN scales and biases perturbed from a numpy
seed, so the Collector's bias and the RepVGG fold are exercised) are
carried into the port with ``params_from_numpy``.  Held against the JAX
package (jnp lowering), bit for bit:

* ``compile_params`` bytes, depthwise leaves included, in all four
  ported modes for MobileNetV2, and for the fused RepVGG (K = 27 and
  108: the bitmap pads them to 32 and 112);
* RepVGG ``fuse_params``;
* unit names, block ids, cut-edge bytes and stage plans of both graphs;
* every unit's int8 edge codes and scales, and the logits of the port's
  ``PipelineEngine(device="cpu")`` at 1 and 2 stages against the JAX
  package's jitted ``serving.pipeline.reference_logits`` — MobileNetV2 in
  ``int8`` and ``sparse_cfmm``, RepVGG in ``int8``; the logit bound is 0.

At 32 px both models end in a 1x1 map, so the head mean has one term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import nn as jnn
from repro.core import compiled_linear as jcl
from repro.core import partition as jpartition
from repro.models import graph as jgraph
from repro.models import mobilenet_v2 as jmb
from repro.models import repvgg as jrv
from repro.serving import pipeline as jpipe
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.core import partition as tpartition
from repro_torch.kernels.ref import pad_same_nhwc
from repro_torch.models import graph as tgraph
from repro_torch.models import mobilenet_v2 as tmb
from repro_torch.models import repvgg as trv
from repro_torch.serving import pipeline as tpipe
from test_torch_compile import _assert_same

CFGS = {
    "mobilenet_v2": (jmb.MobileNetV2Config(0.25, 10, 32),
                     tmb.MobileNetV2Config(0.25, 10, 32)),
    "repvgg_a0": (jrv.RepVGGConfig(0.25, 10, 32),
                  trv.RepVGGConfig(0.25, 10, 32)),
}
# (model, mode) pairs held against the JAX reference
CELLS = [("mobilenet_v2", "int8"), ("mobilenet_v2", "sparse_cfmm"),
         ("repvgg_a0", "int8")]
LOGIT_BOUND = 0.0          # measured max |dlogit| vs JAX at this size
ROWS = (3, 1, 2)           # request sizes; microbatch 2 packs across them


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


def _perturb_bn(tree, rng):
    """Seeded folded-BN scales and biases (``scale``/``bias`` Params),
    the same numbers for both packages."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in ("scale", "bias") and isinstance(v, jnn.Param):
                n = v.value.shape[0]
                val = (0.5 + rng.rand(n) if k == "scale"
                       else 0.1 * rng.randn(n)).astype(np.float32)
                out[k] = jnn.Param(jnp.asarray(val), v.axes, v.kind)
            else:
                out[k] = _perturb_bn(v, rng)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb_bn(v, rng) for v in tree)
    return tree


def _jax_init(model, jcfg, seed=0):
    mod = jmb if model == "mobilenet_v2" else jrv
    tree = jax.jit(mod.init, static_argnums=1)(jax.random.PRNGKey(seed),
                                               jcfg)
    return _perturb_bn(tree, np.random.RandomState(seed))


_cache = {}


def _trees(model):
    """(JAX serving tree, port serving tree) before compilation: the
    MobileNetV2 init tree, or the FUSED RepVGG tree (each package fuses
    its own copy of the same unfused tree)."""
    if model not in _cache:
        jcfg, tcfg = CFGS[model]
        jtree = _jax_init(model, jcfg)
        ttree = tnn.params_from_numpy(jtree)
        if model == "repvgg_a0":
            jtree, ttree = jcfg.fuse(jtree), tcfg.fuse(ttree)
        _cache[model] = (jtree, ttree)
    return _cache[model]


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return rng.randn(sum(ROWS), 32, 32, 3).astype(np.float32)


def _to_jax(tree):
    """The port's compiled tree as the JAX package's (same bytes)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    if isinstance(tree, tcl.ConvGeom):
        return jcl.ConvGeom(tree.k, tree.stride, tree.c_in, tree.dw)
    return jnp.asarray(tree.numpy())


# ---------------------------------------------------------------------------
# Compile artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_mobilenet_compile_params_byte_equal(mode):
    """At width 1/64 every layer is 8-48 channels wide (the JAX package
    compiles eagerly, one dispatch per distinct leaf shape); the tree
    holds every leaf kind: stem, expand, depthwise s1/s2, project, tail,
    head."""
    jcfg = jmb.MobileNetV2Config(1 / 64, 10, 16)
    jtree = _jax_init("mobilenet_v2", jcfg, seed=3)
    j = jcl.compile_params(jtree, mode=mode, sparsity=0.8)
    t = tcl.compile_params(tnn.params_from_numpy(jtree), mode=mode,
                           sparsity=0.8)
    _assert_same(j, t)
    dw = t["blocks"][1]["dw"]["w"]
    assert dw["geom"] == tcl.ConvGeom(3, 2, 1, dw=True)
    assert set(dw) == {"values", "scale", "geom"}    # dense in every mode


@pytest.mark.parametrize("mode", ["int8", "sparse_cfmm"])
def test_repvgg_compile_params_byte_equal(mode):
    jtree, ttree = _trees("repvgg_a0")
    j = jcl.compile_params(jtree, mode=mode, sparsity=0.8)
    t = tcl.compile_params(ttree, mode=mode, sparsity=0.8)
    _assert_same(j, t)
    if mode == "sparse_cfmm":                  # K = 27 and 108, padded
        rows = [t["blocks"][i]["w"]["bitmap"].value.shape[0]
                for i in (0, 3)]
        assert rows == [32 // 8, 112 // 8]


def test_repvgg_fuse_params_byte_equal():
    jcfg, tcfg = CFGS["repvgg_a0"]
    unfused = _jax_init("repvgg_a0", jcfg, seed=5)
    _assert_same(jcfg.fuse(unfused), tcfg.fuse(tnn.params_from_numpy(unfused)))


@pytest.mark.parametrize("block", [0, 1])     # stride 2; stride 1 + identity
def test_repvgg_fusion_equals_its_branches(block):
    """Inside the port: the fused 3x3 conv computes the three-branch sum
    (3x3, center-embedded 1x1, identity, each with its folded BN), in
    float64 up to rounding of the f32 fold."""
    jcfg, tcfg = CFGS["repvgg_a0"]
    unfused = tnn.params_from_numpy(_jax_init("repvgg_a0", jcfg, seed=5))
    _, c_in, c_out, stride, ident = trv.block_specs(tcfg)[block + 1]
    blk = unfused["blocks"][block + 1]
    fused = trv.fuse_params(unfused, tcfg)["blocks"][block + 1]
    x = torch.from_numpy(np.random.RandomState(block).randn(
        2, 8, 8, c_in)).double()

    def conv(w_flat, scale, bias):
        w = w_flat.double().reshape(c_in, 3, 3, -1).permute(3, 0, 1, 2)
        xp, _, _ = pad_same_nhwc(x, 3, stride)
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=stride)
        return y.permute(0, 2, 3, 1) * scale.double() + bias.double()

    v = lambda p: p.value
    want = (conv(v(blk["conv3"]["w"]), v(blk["conv3"]["scale"]),
                 v(blk["conv3"]["bias"]))
            + conv(trv.embed_1x1(v(blk["conv1"]["w"]), c_in),
                   v(blk["conv1"]["scale"]), v(blk["conv1"]["bias"])))
    if ident:
        want = want + x * v(blk["id"]["scale"]).double() \
            + v(blk["id"]["bias"]).double()
    got = conv(v(fused["w"]), v(fused["scale"]), v(fused["bias"]))
    assert ident == (block == 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# Graph structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", sorted(CFGS))
def test_units_edges_and_plans_match_jax(model):
    jcfg, tcfg = CFGS[model]
    jg, tg = jcfg.graph(), tcfg.graph()
    assert [n for n, _ in jg.units()] == [n for n, _ in tg.units()]
    assert [[m.name for m in s] for _, s in jg.units()] == \
        [[m.name for m in s] for _, s in tg.units()]
    assert jg.edge_bytes() == tg.edge_bytes()
    astuple = lambda blocks: [[(l.name, l.c_in, l.c_out, l.k, l.hw, l.stride)
                               for l in b] for b in blocks]
    assert astuple(jg.blocks()) == astuple(tg.blocks())
    for n_stages in (1, 2, 4):
        jp = jpartition.plan_stages(jg.blocks(), n_stages, jg.edge_bytes())
        tp = tpartition.plan_stages(tg.blocks(), n_stages, tg.edge_bytes())
        assert [(p.block_ids, p.layer_names, p.link_bytes, p.macs)
                for p in jp] == [(p.block_ids, p.layer_names, p.link_bytes,
                                  p.macs) for p in tp]
    jtree, ttree = _trees(model)
    junits = jgraph.compile_graph(jg, jtree)
    tunits = tgraph.compile_graph(tg, ttree)
    assert [(u.name, u.block_id) for u in junits] == [
        (u.name, u.block_id) for u in tunits]
    mod = tmb if model == "mobilenet_v2" else trv
    jmod = jmb if model == "mobilenet_v2" else jrv
    assert mod.block_specs(tcfg) == jmod.block_specs(jcfg)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

_fwd = {}


def _cell_data(model, mode, images):
    """Per cell: the port's compiled tree, the JAX reference logits and
    the JAX per-unit outputs (one jit of the unit chain)."""
    if (model, mode) not in _fwd:
        jcfg, _ = CFGS[model]
        compiled = tcl.ensure_compiled(_trees(model)[1], mode, 0.8)
        jc = _to_jax(compiled)
        ref = np.asarray(jpipe.reference_logits(jc, jcfg,
                                                jnp.asarray(images), 2))
        units = jgraph.compile_graph(jcfg.graph(), jc)

        def chain(ps, x):
            outs = []
            for u, p in zip(units, ps):
                x = u.fn(p, x)
                outs.append(x)
            return outs

        edges = jax.jit(chain)(tuple(u.params for u in units),
                               jnp.asarray(images[:2]))
        _fwd[(model, mode)] = (compiled, ref,
                               jax.tree.map(np.asarray, edges))
    return _fwd[(model, mode)]


@pytest.mark.parametrize("model,mode", CELLS)
def test_unit_edges_match_jax(images, model, mode):
    compiled, _, j_edges = _cell_data(model, mode, images)
    units = tgraph.compile_graph(CFGS[model][1].graph(), compiled)
    carry = torch.from_numpy(images[:2])
    for u, j in zip(units, j_edges):
        carry = u.fn(u.params, carry)
        if u.name == "head":
            np.testing.assert_array_equal(carry.numpy(), j)
            continue
        q, s = carry
        assert np.array_equal(q.numpy(), j[0]), \
            f"first differing unit: {u.name} (int8 codes)"
        assert np.array_equal(s.numpy(), j[1]), \
            f"first differing unit: {u.name} (scales)"


def _requests(images):
    starts = np.cumsum((0,) + ROWS)
    return [tpipe.PipelineRequest(rid=i, images=images[a:b])
            for i, (a, b) in enumerate(zip(starts[:-1], starts[1:]))]


@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("model,mode", CELLS)
def test_pipeline_matches_jax_reference(images, model, mode, n_stages):
    compiled, ref, _ = _cell_data(model, mode, images)
    eng = tpipe.PipelineEngine(CFGS[model][1], compiled, mode=mode,
                               n_stages=n_stages, microbatch=2,
                               device="cpu")
    reqs = _requests(images)
    eng.run(reqs)
    got = np.concatenate([r.logits for r in reqs])
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    assert float(np.abs(got - ref).max()) <= LOGIT_BOUND
    st = eng.stats()
    for e, b in enumerate(st["edge_bytes"]):
        assert b["int8_bytes"] == st["planned_link_bytes"][e] * 2


@pytest.mark.parametrize("model,mode", CELLS)
def test_pipeline_bit_identical_to_port_reference(images, model, mode):
    """Stage count and cross-request row packing change no bit inside
    the port."""
    tcfg = CFGS[model][1]
    compiled = tcl.ensure_compiled(_trees(model)[1], mode, 0.8)
    ref = tpipe.reference_logits(compiled, tcfg, torch.from_numpy(images),
                                 1).numpy()
    for n_stages in (1, 2):
        eng = tpipe.PipelineEngine(tcfg, compiled, mode=mode,
                                   n_stages=n_stages, microbatch=2,
                                   device="cpu")
        reqs = _requests(images)
        eng.run(reqs)
        np.testing.assert_array_equal(
            np.concatenate([r.logits for r in reqs]), ref)
        assert eng.stats()["mb_injected"] == 3


def test_dense_forwards_raise():
    """The dense forwards, which raised before they were ported, run on
    the float trees (tests/test_torch_dense.py holds them to JAX); a
    compiled conv leaf on the dense path still raises, as in JAX
    (``apply_linear``: use ``apply_conv``) — here the compiled UNFUSED
    RepVGG tree."""
    x = torch.zeros((1, 32, 32, 3))
    for model in sorted(CFGS):
        _, tcfg = CFGS[model]
        logits = tcfg.apply(tnn.unbox(_trees(model)[1]), x)
        assert logits.shape == (1, 10) and bool(torch.isfinite(logits).all())
    jcfg, tcfg = CFGS["repvgg_a0"]
    unfused = tnn.params_from_numpy(_jax_init("repvgg_a0", jcfg, seed=5))
    compiled = tnn.unbox(tcl.compile_params(unfused, mode="int8"))
    with pytest.raises(AssertionError, match="use apply_conv"):
        tcfg.apply(compiled, x)
