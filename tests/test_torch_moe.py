"""Port parity of the MoE FFN (``repro_torch/models/moe.py``) against the
JAX package's ``moe_forward``, under ``REPRO_PALLAS=jnp``, at
``olmoe_1b_7b.reduced()`` (d 128, 8 experts of width 64) with top-1,
top-2 and top-8 routing, on the same bf16 input, in ``dense``, ``int8``
and ``sparse_cfmm``.  JAX initialises the weights; the port takes them
through numpy.

* Routing: the f32 router logits within 1e-6 relative; the picks
  (``expert_idx``), the queue slots and the keep mask equal wherever
  JAX's K-th against (K+1)-th probability margin exceeds 1e-6 (JAX's
  logits, picks, slots and capacity are recorded inside its
  ``moe_forward``: ``_jax_routing``); the count of tokens under that
  margin is printed (0 on these inputs).  The capacity equals JAX's,
  read off the dispatch buffer of its traced forward.
* y within ``Y_BOUND`` of the jitted JAX forward, and the aux losses
  within 1e-5 relative (1e-7 absolute: JAX's ``dropped_frac`` of an
  undropped batch reads -3e-8 in f32).
* The compiled expert leaves, stacked ``(E, K, N)`` under
  ``experts_stack``, are the same bytes.
* A tight ``capacity_factor=0.25`` drops picks: the keep mask and
  ``dropped_frac`` equal JAX's.  An exact tie (a zero router) picks the
  lower indices, as ``jax.lax.top_k`` does.  Shared experts
  (``n_shared=2`` through ``dataclasses.replace``; JAX's own test uses
  DeepSeek, whose MLA is not ported).
* The combine: XLA's bf16 scatter-add of a token's K terms equals the
  port's adds in choice order bit for bit; summing in f32 first does not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.core import compiled_linear as jcl
from repro.models import moe as jmoe
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import moe as tmoe

MODES = ("dense", "int8", "sparse_cfmm")
TOP_K = (1, 2, 8)
# max |dy| against the jitted JAX forward.  Measured (jax 0.9.0, 2 x 24
# tokens, max |y| 0.32-1.70): dense 0.0059-0.0078, int8 0.0078-0.0215,
# sparse_cfmm 0.0039-0.0156.  bf16 rounds where XLA's fusion puts it
# (silu, the gate product; ROADMAP queue C), and in the compiled modes a
# flipped int8 activation code moves an expert's output by a step of its
# scale.  Held with 2x headroom over the largest reading.
Y_BOUND = 0.045
MARGIN = 1e-6


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


def _configs(top_k=2, n_experts=8, **moe_over):
    out = []
    for get in (jget_config, tget_config):
        cfg = get("olmoe_1b_7b").reduced()
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, top_k=top_k, n_experts=n_experts, **moe_over)))
    return tuple(out)


@pytest.fixture(scope="module")
def setup():
    """top_k -> (JAX cfg, port cfg, JAX boxed tree, port boxed tree)."""
    out = {}

    def get(top_k, **over):
        key = (top_k, tuple(sorted(over.items())))
        if key not in out:
            jcfg, tcfg = _configs(top_k, **over)
            jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
            out[key] = (jcfg, tcfg, jp, tnn.params_from_numpy(jp))
        return out[key]
    return get


def _x(d, shape=(2, 24), seed=0):
    """The same bf16 input on both sides."""
    x = np.random.RandomState(seed).randn(*shape, d).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    return xj, xt


def _served(jp, tp, mode):
    if mode == "dense":
        return jnn.unbox(jp), tnn.unbox(tp)
    return (jnn.unbox(jcl.compile_params(jp, mode=mode)),
            tnn.unbox(tcl.compile_params(tp, mode=mode)))


def _record(monkeypatch, module, name, seen):
    """Wrap ``module.name`` so that each call's arguments and result are
    appended to ``seen``."""
    orig = getattr(module, name)

    def rec(*a, **kw):
        out = orig(*a, **kw)
        seen.append((a, out))
        return out
    monkeypatch.setattr(module, name, rec)


def _jax_dispatch_buffers(run, cfg, monkeypatch):
    """The shapes of the ``(E, cap, d)`` dispatch buffers that JAX's
    ``moe_forward`` allocates (``jnp.zeros``) while ``run()`` traces or
    runs it."""
    seen = []
    _record(monkeypatch, jnp, "zeros", seen)
    try:
        run()
    finally:
        monkeypatch.undo()
    E, d = cfg.moe.n_experts, cfg.d_model
    return [tuple(a[0]) for a, _ in seen
            if len(a[0]) == 3 and a[0][0] == E and a[0][2] == d]


def _jax_cap(cfg, n_tok, capacity_factor, monkeypatch):
    """JAX's capacity at ``n_tok`` tokens, read off the dispatch buffer
    of ``moe_forward`` traced abstractly (``jax.eval_shape``)."""
    p = jax.eval_shape(lambda k: jnn.unbox(jmoe.moe_init(k, cfg)),
                       jax.random.PRNGKey(0))
    x = jax.ShapeDtypeStruct((1, n_tok, cfg.d_model), jnp.bfloat16)
    (shape,) = _jax_dispatch_buffers(lambda: jax.eval_shape(
        lambda p, x: jmoe.moe_forward(p, x, cfg,
                                      capacity_factor=capacity_factor),
        p, x), cfg, monkeypatch)
    return shape[1]


def _jax_routing(p, x, cfg, capacity_factor, monkeypatch):
    """JAX's own routing of ``x``, recorded from ``moe_forward`` run
    eagerly: the router logits and probs (``jax.nn.softmax``), the picks
    (``jax.lax.top_k``), the queue slots (``jnp.take_along_axis``) and the
    capacity (the dispatch buffer's ``jnp.zeros``), the keep mask being
    ``slot < cap`` as in ``moe.py``.  -> (logits, probs, picks, slot,
    keep, aux, cap)."""
    soft, top, take, aux = [], [], [], []
    _record(monkeypatch, jax.nn, "softmax", soft)
    _record(monkeypatch, jax.lax, "top_k", top)
    _record(monkeypatch, jnp, "take_along_axis", take)
    (shape,) = _jax_dispatch_buffers(lambda: aux.append(jmoe.moe_forward(
        p, x, cfg, capacity_factor=capacity_factor)[1]), cfg, monkeypatch)
    (logits,), probs = soft[0][0][:1], soft[0][1]
    idx = top[0][1][1]
    slot = np.asarray(take[0][1])[:, 0]
    return (np.asarray(logits), np.asarray(probs), np.asarray(idx), slot,
            slot < shape[1], aux[0], shape[1])


def _margins(probs, K):
    """JAX's K-th against (K+1)-th probability margin per token (inf at
    K = E)."""
    s = -np.sort(-probs, axis=-1)
    return s[:, K - 1] - s[:, K] if K < s.shape[1] else \
        np.full(s.shape[0], np.inf)


@pytest.mark.parametrize("top_k", TOP_K)
def test_routing_matches_jax(setup, top_k, monkeypatch):
    jcfg, tcfg, jp, tp = setup(top_k)
    xj, xt = _x(jcfg.d_model)
    pj, pt = jnn.unbox(jp), tnn.unbox(tp)
    logits, probs, idx, slot, keep, _, cap = _jax_routing(pj, xj, jcfg, 1.25,
                                                          monkeypatch)
    r = tmoe.route(xt.reshape(-1, tcfg.d_model), pt["router"], top_k, 1.25)
    np.testing.assert_allclose(r.logits.numpy(), logits, rtol=1e-6,
                               atol=1e-6 * np.abs(logits).max())
    np.testing.assert_allclose(r.probs.numpy(), probs, rtol=1e-6,
                               atol=1e-7)
    clear = _margins(probs, top_k) > MARGIN
    print(f"top_k={top_k}: {int((~clear).sum())} of {len(clear)} tokens "
          f"within {MARGIN} of a routing tie")
    np.testing.assert_array_equal(r.expert_idx.numpy()[clear], idx[clear])
    if clear.all():
        np.testing.assert_array_equal(r.slot.numpy(), slot)
        np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert r.cap == cap


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("top_k", TOP_K)
def test_moe_forward_matches_jitted_jax(setup, top_k, mode):
    jcfg, tcfg, jp, tp = setup(top_k)
    xj, xt = _x(jcfg.d_model)
    pj, pt = _served(jp, tp, mode)
    yj, auxj = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(pj, xj)
    yt, auxt = tmoe.moe_forward(pt, xt, tcfg)
    assert yt.dtype == torch.bfloat16 and yt.shape == xt.shape
    d = float(np.abs(np.asarray(yj.astype(jnp.float32))
                     - yt.float().numpy()).max())
    assert d <= Y_BOUND, (top_k, mode, d)
    assert set(auxt) == set(auxj)
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["int8", "sparse_cfmm"])
def test_compiled_expert_bytes_equal_jax(setup, mode):
    """Tier 1: the stacked (E, K, N) expert leaves compile to the same
    bytes under the same axes; the f32 router stays as it is."""
    jcfg, _, jp, tp = setup(2)
    jc, tc = jcl.compile_params(jp, mode=mode), tcl.compile_params(tp,
                                                                   mode=mode)
    assert isinstance(tc["router"], tnn.Param)
    np.testing.assert_array_equal(np.asarray(jc["router"].value),
                                  tc["router"].value.numpy())
    n = 0
    for name in ("gate", "up", "down"):
        for key, jleaf in jc["experts"][name].items():
            if not isinstance(jleaf, jnn.Param):
                continue                       # JAX's childless markers
            tleaf = tc["experts"][name][key]
            assert tleaf.axes == jleaf.axes and tleaf.axes[0] == \
                "experts_stack", (name, key)
            a, b = np.asarray(jleaf.value), tleaf.value.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (name, key)
            assert a.shape[0] == jcfg.moe.n_experts
            np.testing.assert_array_equal(a, b, err_msg=f"{name}/{key}")
            n += 1
    assert n == 3 * (2 if mode == "int8" else 3)


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_tight_capacity_drops_like_jax(setup, mode, monkeypatch):
    """``capacity_factor=0.25`` on 4 x 32 tokens: cap 8 of 256 picks over
    8 experts drops some; the keep mask and ``dropped_frac`` equal
    JAX's, and y stays within the bound."""
    jcfg, tcfg, jp, tp = setup(2)
    xj, xt = _x(jcfg.d_model, (4, 32), seed=3)
    pj, pt = _served(jp, tp, mode)
    _, probs, idx, slot, keep, auxj, cap = _jax_routing(pj, xj, jcfg, 0.25,
                                                        monkeypatch)
    assert (_margins(probs, 2) > MARGIN).all()
    r = tmoe.route(xt.reshape(-1, tcfg.d_model), pt["router"], 2, 0.25)
    assert r.cap == cap == 8 and not keep.all()
    np.testing.assert_array_equal(r.expert_idx.numpy(), idx)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    yt, auxt = tmoe.moe_forward(pt, xt, tcfg, capacity_factor=0.25)
    assert float(auxt["dropped_frac"]) == pytest.approx(
        float(auxj["dropped_frac"]), rel=1e-6)
    assert float(auxt["dropped_frac"]) == pytest.approx(1 - keep.mean())
    yj, _ = jax.jit(lambda p, x: jmoe.moe_forward(
        p, x, jcfg, capacity_factor=0.25))(pj, xj)
    assert float(np.abs(np.asarray(yj.astype(jnp.float32))
                        - yt.float().numpy()).max()) <= Y_BOUND


@pytest.mark.parametrize("top_k", [2, 8])
def test_exact_tie_takes_lower_index(setup, top_k, monkeypatch):
    """A zero router gives every expert the same probability: both
    packages pick experts 0..K-1 for every token."""
    jcfg, tcfg, jp, tp = setup(top_k)
    pj = dict(jnn.unbox(jp), router=jnp.zeros_like(jp["router"].value))
    pt = dict(tnn.unbox(tp), router=torch.zeros_like(tp["router"].value))
    xj, xt = _x(jcfg.d_model, (1, 8))
    idx = _jax_routing(pj, xj, jcfg, 1.25, monkeypatch)[2]
    r = tmoe.route(xt.reshape(-1, tcfg.d_model), pt["router"], top_k, 1.25)
    want = np.broadcast_to(np.arange(top_k), (8, top_k))
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_array_equal(r.expert_idx.numpy(), want)
    assert tmoe.pick_experts(torch.tensor([[0.25, 0.5, 0.25, 0.5]]),
                             3).tolist() == [[1, 3, 0]]


@pytest.mark.parametrize("mode", MODES)
def test_shared_experts_match_jax(setup, mode):
    jcfg, tcfg, jp, tp = setup(2, n_shared=2)
    assert jcfg.moe.n_shared == tcfg.moe.n_shared == 2
    assert tuple(tp["shared"]["up"].value.shape) == (128, 128)
    assert set(tp["shared"]) == set(jp["shared"]) == {"gate", "up", "down"}
    xj, xt = _x(jcfg.d_model, (1, 16), seed=5)
    pj, pt = _served(jp, tp, mode)
    yj, _ = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg))(pj, xj)
    yt, _ = tmoe.moe_forward(pt, xt, tcfg)
    assert float(np.abs(np.asarray(yj.astype(jnp.float32))
                        - yt.float().numpy()).max()) <= Y_BOUND


def test_init_tree_matches_jax(setup):
    """Leaf for leaf, axes and kinds included (the router generic, the
    experts linear under ``experts_stack``)."""
    _, tcfg, jp, _ = setup(2)
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    is_j, is_t = (lambda x: isinstance(x, jnn.Param)), \
        (lambda x: isinstance(x, tnn.Param))
    jl = jax.tree_util.tree_flatten_with_path(jp, is_leaf=is_j)[0]
    tl = tnn.tree_leaves(tp, is_leaf=is_t)
    assert len(jl) == len(tl)
    jd = {jax.tree_util.keystr(k): v for k, v in jl}
    for path, jv in jd.items():
        keys = [s.strip("'") for s in path.strip("[]").split("][")]
        tv = tp
        for k in keys:
            tv = tv[k]
        assert (tv.axes, tv.kind) == (jv.axes, jv.kind), path
        assert tuple(tv.value.shape) == jv.value.shape, path
    assert tp["router"].kind == "generic"
    assert tp["experts"]["up"].axes == ("experts_stack", "embed", "ffn_in")


@pytest.mark.parametrize("n_tok,top_k,E,cf", [
    (37, 8, 64, 1.25), (64, 8, 64, 1.25), (512, 8, 64, 1.25),
    (1024, 8, 64, 1.25), (4, 8, 64, 1.25), (128, 2, 8, 0.25),
    (26, 2, 8, 16.0), (3, 1, 8, 1.25)])
def test_capacity_arithmetic(n_tok, top_k, E, cf, monkeypatch):
    """The port's capacity against JAX's, read off the dispatch buffer of
    JAX's ``moe_forward`` traced at ``n_tok`` tokens."""
    jcfg, _ = _configs(top_k, n_experts=E)
    cap = _jax_cap(jcfg, n_tok, cf, monkeypatch)
    assert tmoe.capacity(n_tok, top_k, E, cf) == cap
    if (n_tok, cf) in ((1024, 1.25), (512, 1.25), (64, 1.25), (4, 1.25)):
        assert cap == {1024: 160, 512: 80, 64: 16, 4: 8}[n_tok]


@pytest.mark.parametrize("n_tok", [24, 1024])
def test_combine_order_matches_xla_scatter(n_tok):
    """JAX's ``zeros.at[tok_id].add(gathered * w)`` in bf16, jitted,
    equals the K terms added in choice order, bit for bit (K = 8); an f32
    sum rounded once differs."""
    K, d = 8, 64
    rng = np.random.RandomState(n_tok)
    g = rng.randn(n_tok * K, d).astype(np.float32)
    w = rng.rand(n_tok * K).astype(np.float32)
    tok_id = jnp.asarray(np.repeat(np.arange(n_tok), K))
    want = jax.jit(lambda g, w: jnp.zeros((n_tok, d), jnp.bfloat16)
                   .at[tok_id].add(g.astype(jnp.bfloat16)
                                   * w[:, None].astype(jnp.bfloat16)))(g, w)
    want = np.asarray(want.astype(jnp.float32))
    terms = (torch.from_numpy(g).to(torch.bfloat16)
             * torch.from_numpy(w)[:, None].to(torch.bfloat16)
             ).reshape(n_tok, K, d)
    seq = torch.zeros((n_tok, d), dtype=torch.bfloat16)
    for k in range(K):
        seq = seq + terms[:, k]
    np.testing.assert_array_equal(seq.float().numpy(), want)
    f32 = terms.float().sum(1).to(torch.bfloat16).float().numpy()
    assert (f32 != want).any()


def test_qat_raises(setup):
    """``moe_forward(qat=True)`` (it raised before the training slice)
    fake-quantizes every expert's and shared expert's dense linears, as
    JAX's does: y within ``Y_BOUND`` of JAX's jitted QAT forward, the aux
    as in ``test_moe_forward_matches_jitted_jax``, and y off the plain
    forward's."""
    jcfg, tcfg, jp, tp = setup(2)
    xj, xt = _x(jcfg.d_model)
    pj, pt = _served(jp, tp, "dense")
    yj, auxj = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jcfg, qat=True))(
        pj, xj)
    yt, auxt = tmoe.moe_forward(pt, xt, tcfg, qat=True)
    d = float(np.abs(np.asarray(yj.astype(jnp.float32))
                     - yt.float().numpy()).max())
    assert d <= Y_BOUND, d
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k]), float(auxj[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert not torch.equal(yt, tmoe.moe_forward(pt, xt, tcfg)[0])
