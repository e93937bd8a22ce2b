"""Port parity for the whole slice: JAX ``resnet.init`` ->
``params_from_numpy`` -> the port's ``PipelineEngine(device="cpu")`` at 1
and 2 stages, in ``int8`` and ``sparse_cfmm`` and in the two modes that
change only the head (``cfmm``, ``bitserial``), held against the JAX
package's jitted ``serving.pipeline.reference_logits`` (jnp lowering) for
``ResNetConfig(width_mult=0.25, in_hw=32)``.

The JAX side is fed the port's compiled parameters (converted leaf for
leaf): test_torch_compile.py holds the two packages' ``compile_params``
byte-equal, and this file spends its time on the forward.  Each unit's
int8 edge codes and scales are compared, naming the first unit that
differs.  The logit bound at this size is 0: the port reproduces the JAX
logits bit for bit (the head's map is 1x1, so the head mean has a single
term; at 7x7 the port follows XLA's fused order, see models/graph.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiled_linear as jcl
from repro.core import partition as jpartition
from repro.models import graph as jgraph
from repro.models import resnet as jres
from repro.serving import pipeline as jpipe
from repro_torch import nn as tnn
from repro_torch.core import compiled_linear as tcl
from repro_torch.core import partition as tpartition
from repro_torch.models import graph as tgraph
from repro_torch.models import resnet as tres
from repro_torch.serving import pipeline as tpipe

JCFG = jres.ResNetConfig(width_mult=0.25, in_hw=32)
TCFG = tres.ResNetConfig(width_mult=0.25, in_hw=32)
MODES = ("int8", "sparse_cfmm")
HEAD_MODES = ("cfmm", "bitserial")   # the int8 convs, another head
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


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(7)
    return rng.randn(sum(ROWS), 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def port_tree():
    jax_tree = jax.jit(jres.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                    JCFG)
    return tnn.params_from_numpy(jax_tree)


def _to_jax(tree):
    """The port's compiled tree as the JAX package's (same bytes)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    if isinstance(tree, tcl.ConvGeom):
        return jcl.ConvGeom(tree.k, tree.stride, tree.c_in, tree.dw)
    return jnp.asarray(tree.numpy())


_cache = {}
_ref_cache = {}


def _reference(port_tree, images, mode):
    """Per mode: the port's compiled tree and the JAX reference logits."""
    if mode not in _ref_cache:
        compiled = tcl.ensure_compiled(port_tree, mode, 0.8)
        ref = np.asarray(jpipe.reference_logits(_to_jax(compiled), JCFG,
                                                jnp.asarray(images), 2))
        _ref_cache[mode] = (compiled, ref)
    return _ref_cache[mode]


def _mode_data(port_tree, images, mode):
    """Per mode: the port's compiled tree, the JAX reference logits and
    the JAX per-unit outputs (one jit of the unit chain)."""
    if mode not in _cache:
        compiled, ref = _reference(port_tree, images, mode)
        jc = _to_jax(compiled)
        units = jgraph.compile_graph(JCFG.graph(), jc)

        def chain(ps, x):
            outs = []
            for u, p in zip(units, ps):
                x = u.fn(p, x)
                outs.append(x)
            return outs

        edges = jax.jit(chain)(tuple(u.params for u in units),
                               jnp.asarray(images[:2]))
        _cache[mode] = (compiled, ref, jax.tree.map(np.asarray, edges))
    return _cache[mode]


@pytest.mark.parametrize("mode", MODES)
def test_unit_edges_match_jax(port_tree, images, mode):
    compiled, _, j_edges = _mode_data(port_tree, images, mode)
    units = tgraph.compile_graph(TCFG.graph(), compiled)
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


@pytest.mark.parametrize("n_stages", [1, 2])
@pytest.mark.parametrize("mode", MODES + HEAD_MODES)
def test_pipeline_matches_jax_reference(port_tree, images, mode, n_stages):
    compiled, ref = _reference(port_tree, images, mode)
    eng = tpipe.PipelineEngine(TCFG, compiled, mode=mode, n_stages=n_stages,
                               microbatch=2, device="cpu")
    starts = np.cumsum((0,) + ROWS)
    reqs = [tpipe.PipelineRequest(rid=i, images=images[a:b])
            for i, (a, b) in enumerate(zip(starts[:-1], starts[1:]))]
    eng.run(reqs)
    got = np.concatenate([r.logits for r in reqs])
    assert (got.argmax(-1) == ref.argmax(-1)).all()
    assert float(np.abs(got - ref).max()) <= LOGIT_BOUND
    st = eng.stats()
    # measured int8 edge bytes per microbatch == the plan's per-image bytes
    for e, b in enumerate(st["edge_bytes"]):
        assert b["int8_bytes"] == st["planned_link_bytes"][e] * 2


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_plans_units_and_edge_bytes_match_jax(n_stages):
    jg, tg = JCFG.graph(), TCFG.graph()
    assert [n for n, _ in jg.units()] == [n for n, _ in tg.units()]
    assert jg.edge_bytes() == tg.edge_bytes()
    astuple = lambda blocks: [[(l.name, l.c_in, l.c_out, l.k, l.hw, l.stride)
                               for l in b] for b in blocks]
    assert astuple(jg.blocks()) == astuple(tg.blocks())
    assert astuple(jres.conv_blocks_for(JCFG)) == astuple(
        tres.conv_blocks_for(TCFG))
    jp = jpartition.plan_stages(jg.blocks(), n_stages, jg.edge_bytes())
    tp = tpartition.plan_stages(tg.blocks(), n_stages, tg.edge_bytes())
    assert [(p.block_ids, p.layer_names, p.link_bytes, p.macs) for p in jp] \
        == [(p.block_ids, p.layer_names, p.link_bytes, p.macs) for p in tp]
    params = {"stem": {}, "head": {}, **{
        f"conv{i}_x": [{"a": {}, "b": {}, "c": {}, "sc": {}}] * 6
        for i in range(2, 6)}}
    junits = jgraph.compile_graph(jg, params)
    tunits = tgraph.compile_graph(tg, params)
    assert [(u.name, u.block_id) for u in junits] == [
        (u.name, u.block_id) for u in tunits]
    assert tres.table1() == jres.table1()


@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("mode", MODES + HEAD_MODES)
def test_pipeline_bit_identical_to_port_reference(port_tree, images, mode,
                                                  pack):
    """Cross-request row packing and stage count change no bit (per-row
    quantization domains), checked inside the port."""
    compiled = tcl.ensure_compiled(port_tree, mode, 0.8)
    ref = tpipe.reference_logits(compiled, TCFG, torch.from_numpy(images),
                                 1).numpy()
    eng = tpipe.PipelineEngine(TCFG, compiled, mode=mode, n_stages=2,
                               microbatch=2, device="cpu",
                               pack_requests=pack)
    starts = np.cumsum((0,) + ROWS)
    reqs = [tpipe.PipelineRequest(rid=i, images=images[a:b])
            for i, (a, b) in enumerate(zip(starts[:-1], starts[1:]))]
    eng.run(reqs)
    np.testing.assert_array_equal(np.concatenate([r.logits for r in reqs]),
                                  ref)
    st = eng.stats()
    assert st["mb_injected"] == (3 if pack else 4)
    assert sum(sum(c) for c in st["bubble_attribution"].values()) \
        == st["idle_stage_ticks"]


def test_reference_logits_zero_rows(port_tree):
    compiled = tcl.ensure_compiled(port_tree, "int8", 0.8)
    out = tpipe.reference_logits(compiled, TCFG,
                                 torch.zeros((0, 32, 32, 3)), 2)
    assert tuple(out.shape) == (0, TCFG.num_classes)
