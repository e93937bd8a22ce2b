"""Port parity of the training substrate (``repro_torch.data``,
``core.quantize.fake_quant_int7``, ``training.grad_compression``,
``training.optimizer``, the flash-attention backward's plain version and
``checkpoint``) with the JAX package, on the CPU with ``REPRO_PALLAS=jnp``.
Inputs are made with numpy from a seed.  Bounds, each beside what these
cases measure:

* data batches, ``fake_quant_int7``'s forward, ``grad_compression``,
  ``lr_at`` and every checkpoint leaf: equal to the bit.
* the straight-through gradient of ``fake_quant_int7``: 1e-6 of its
  largest entry against JAX's ``jax.grad`` (the scale's gradient summed
  in another order; measured 4.3e-7).
* two AdamW steps (eager JAX ``apply_updates``): params, m and v within
  2e-6 of each leaf's largest entry, the grad norm within 2e-6 relative
  (f32 sums of squares taken in another order; measured 5.3e-7 and
  1.7e-7).
* the flash backward's plain version in f32 against torch autograd of
  ``flash_attention_plain``: 2e-5 absolute (measured at most 1.2e-6);
  against ``jax.vjp`` of ``repro.models.attention.flash_attention``: 2e-5
  absolute (measured at most 1.4e-6).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.checkpoint import checkpoint as jckpt
from repro.core import quantize as jquant
from repro.data import pipeline as jdata
from repro.launch.train import build_cfg as jbuild
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro_torch import nn as tnn
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import quantize as tquant
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.training import grad_compression as tgc
from repro_torch.training import optimizer as topt

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its jnp lowering; torch runs one thread beside
    XLA's pool (the two pools oversubscribe the cores and slow these
    small ops by an order of magnitude)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["markov", "random"])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_batches_byte_equal(source, shard):
    cfg = dict(vocab=97, seq_len=33, global_batch=6, seed=5, source=source)
    jd = jdata.SyntheticDataset(jdata.DataConfig(**cfg), *shard)
    td = tdata.SyntheticDataset(tdata.DataConfig(**cfg), *shard)
    assert td.entropy_floor == jd.entropy_floor
    for step in (0, 1, 7, 123):
        a, b = jd.batch(step), td.batch(step)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()


# ---------------------------------------------------------------------------
# QAT fake-quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((64, 48), 0),
                                        ((3, 40, 24), -1)])
def test_fake_quant_forward_bit_equal(shape, axis):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.1
    w[0, 0] = 0.0
    want = np.asarray(jquant.fake_quant_int7(jnp.asarray(w), axis))
    got = _np(tquant.fake_quant_int7(torch.from_numpy(w), axis))
    assert got.tobytes() == want.tobytes()


def test_fake_quant_straight_through_gradient():
    rng = np.random.RandomState(1)
    w = rng.randn(40, 24).astype(np.float32) * 0.1
    c = rng.randn(40, 24).astype(np.float32)
    want = np.asarray(jax.grad(lambda w: jnp.sum(
        jquant.fake_quant_int7(w) * c))(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    (tquant.fake_quant_int7(wt) * torch.from_numpy(c)).sum().backward()
    got = _np(wt.grad)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the round itself passes the gradient as the identity
    x = torch.linspace(-3, 3, 13, requires_grad=True)
    tquant._SteRound.apply(x).sum().backward()
    assert torch.equal(x.grad, torch.ones(13))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _grad_tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(32, 16).astype(np.float32),
            "b": [rng.randn(8).astype(np.float32),
                  (rng.randn(4, 5, 6) * 1e-3).astype(np.float32)],
            "z": np.zeros((3, 3), np.float32)}


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tx(tree):
    return tnn.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same_leaves(jtree, ttree):
    jl = [np.asarray(a) for a in jax.tree.leaves(jtree)]
    tl = [_np(t) for _, t in tnn.tree_flatten_with_path(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_compress_decompress_bit_equal():
    g = _grad_tree(2)
    _same_leaves(jgc.compress_decompress(_jx(g)),
                 tgc.compress_decompress(_tx(g)))
    none = tgc.compress_decompress(_tx(g), "none")
    assert np.array_equal(_np(none["a"]), g["a"])


def test_compress_with_feedback_bit_equal():
    g1, g2 = _grad_tree(3), _grad_tree(4)
    je = jgc.init_error_feedback(_jx(g1))
    te = tgc.init_error_feedback(_tx(g1))
    _same_leaves(je, te)
    for g in (g1, g2):                     # the residual carries over
        jc, je = jgc.compress_with_feedback(_jx(g), je)
        tc, te = tgc.compress_with_feedback(_tx(g), te)
        _same_leaves(jc, tc)
        _same_leaves(je, te)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 19, 20, 57, 99, 150])
def test_lr_at_bit_equal(step):
    cfg = dict(lr=3e-3, warmup_steps=20, total_steps=100)
    want = np.float32(jopt.lr_at(jnp.int32(step), jopt.OptConfig(**cfg)))
    got = topt.lr_at(torch.tensor(step, dtype=torch.int32),
                     topt.OptConfig(**cfg))
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == want.tobytes()


def test_adamw_step_matches_jax():
    """Two AdamW steps from a random state (decay on the 2-D leaves, a
    clip that bites) against the JAX package's, eagerly."""
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(24, 16).astype(np.float32),
              "b": rng.randn(16).astype(np.float32),
              "s": [rng.randn(3, 8, 4).astype(np.float32)]}
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, grad_clip=1.0)
    jp, tp = _jx(params), _tx(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(2):
        grads = jax.tree.map(lambda a: (rng.randn(*a.shape) * (i + 1))
                             .astype(np.float32), params)
        jp, js, jm = jopt.apply_updates(jp, _jx(grads), js,
                                        jopt.OptConfig(**cfg))
        tp, ts, tm = topt.apply_updates(tp, _tx(grads), ts,
                                        topt.OptConfig(**cfg))
        assert int(ts.step) == int(js.step) == i + 1
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            2e-6 * float(jm["grad_norm"])
        for jt, tt in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
            jl = [np.asarray(a) for a in jax.tree.leaves(jt)]
            tl = [_np(t) for _, t in tnn.tree_flatten_with_path(tt)]
            for a, b in zip(jl, tl, strict=True):
                assert np.abs(a - b).max() <= 2e-6 * np.abs(a).max()


# ---------------------------------------------------------------------------
# flash attention backward (plain version)
# ---------------------------------------------------------------------------

BWD_CASES = [  # B, KVH, G, Tq, Tk, D, Dv, causal, window
    (1, 2, 1, 24, 24, 16, 16, True, None),
    (2, 1, 3, 19, 19, 8, 8, True, None),
    (1, 2, 3, 9, 23, 16, 8, True, None),        # Tq < Tk, Dv != D
    (1, 1, 3, 30, 30, 16, 24, True, 7),         # window
    # non-causal, Tq < Tk; Tk a multiple of the JAX chunk: without the
    # causal mask JAX's jnp flash attends to its zero kv pad (ROADMAP C)
    (1, 2, 1, 11, 16, 8, 8, False, None),
    (1, 1, 2, 20, 20, 24, 16, True, 5),
]


def _bwd_inputs(case, seed=0):
    B, KVH, G, Tq, Tk, D, Dv, *_ = case
    rng = np.random.RandomState(seed)
    return (rng.randn(B, KVH, G, Tq, D).astype(np.float32),
            rng.randn(B, KVH, Tk, D).astype(np.float32),
            rng.randn(B, KVH, Tk, Dv).astype(np.float32),
            rng.randn(B, KVH, G, Tq, Dv).astype(np.float32))


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_against_autograd(case):
    causal, window = case[-2:]
    q, k, v, do = (torch.from_numpy(a) for a in _bwd_inputs(case))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.flash_attention_plain(*leaves, causal, window)
    want = torch.autograd.grad(o, leaves, do)
    o2, lse = tfa.flash_attention_fwd(q, k, v, causal, window)
    assert torch.equal(o2, o.detach())
    got = tfa.flash_attention_bwd(q, k, v, o2, do, lse, causal, window)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= 2e-5
    # ops.flash_attention takes the autograd function when a gradient is
    # needed, the plain forward (no lse) otherwise
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tops.flash_attention(*leaves, causal, window)
    assert out.grad_fn is not None and "FlashAttention" in \
        type(out.grad_fn).__name__
    got2 = torch.autograd.grad(out, leaves, do)
    for a, b in zip(got2, got):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert tops.flash_attention(*leaves, causal, window).grad_fn is None


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_against_jax_vjp(case):
    causal, window = case[-2:]
    q, k, v, do = _bwd_inputs(case, seed=1)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(
        q, k, v, causal, window, q_chunk=8, kv_chunk=8),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal, window)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, tdo, lse, causal, window)
    for a, b in zip(got, want):
        assert np.abs(_np(a) - np.asarray(b)).max() <= 2e-5


def test_flash_lse_is_the_row_logsumexp():
    q, k, v, _ = _bwd_inputs((1, 2, 3, 9, 23, 16, 8, True, 4), seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    _, lse = tfa.flash_attention_fwd(tq, tk, tv, True, 4)
    s = torch.einsum("bhgqd,bhkd->bhgqk", tq, tk) / 4.0
    mask = tfa.position_mask(9, 23, True, 4, "cpu")
    want = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    assert float((lse - want).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _ckpt_trees():
    """(JAX tree, port tree) of (params, opt_state) at ``tiny`` with a
    bf16 leaf beside the f32 ones."""
    cfg = jbuild("smollm_360m", "tiny")
    jp = jnn.unbox(jlm.init(jax.random.PRNGKey(0), cfg))
    jp["extra"] = {"bf16": (jnp.arange(24, dtype=jnp.float32) / 7.0
                            ).astype(jnp.bfloat16).reshape(4, 6)}
    js = jopt.init(jp)
    js = js._replace(step=jnp.int32(7),
                     m=jax.tree.map(lambda a: a + 0.25, js.m))
    tp = tnn.tree_map(lambda a: torch.from_numpy(np.array(
        a.astype(jnp.float32))).to(torch.bfloat16)
        if a.dtype == jnp.bfloat16 else torch.from_numpy(np.array(a)), jp)
    ts = topt.OptState(torch.tensor(7, dtype=torch.int32),
                       tnn.tree_map(lambda a: torch.from_numpy(
                           np.array(a)), js.m),
                       tnn.tree_map(lambda a: torch.from_numpy(
                           np.array(a)), js.v))
    return (jp, js), (tp, ts)


def _bits(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        return t.numpy().tobytes(), str(t.numpy().dtype)
    a = np.asarray(t)
    return a.tobytes(), str(a.dtype)


def _zeros_like(tree):
    return tnn.tree_map(torch.zeros_like, tree)


def test_checkpoint_jax_writes_port_restores(tmp_path):
    jtree, ttree = _ckpt_trees()
    jckpt.save(tmp_path, 7, jtree)
    like = (_zeros_like(ttree[0]),
            topt.OptState(torch.tensor(0, dtype=torch.int32),
                          _zeros_like(ttree[1].m), _zeros_like(ttree[1].v)))
    got, step = tckpt.restore(tmp_path, like)
    assert step == 7 and tckpt.latest_step(tmp_path) == 7
    assert isinstance(got[1], topt.OptState)
    assert got[0]["extra"]["bf16"].dtype == torch.bfloat16
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tnn.tree_flatten_with_path(got)
    assert len(jl) == len(tl)
    for (_, a), (_, b) in zip(jl, tl):
        assert _bits(b) == _bits(a)


def test_checkpoint_port_writes_jax_restores(tmp_path):
    jtree, ttree = _ckpt_trees()
    tckpt.save(tmp_path, 9, ttree)
    like = jax.tree.map(jnp.zeros_like, jtree)
    got, step = jckpt.restore(tmp_path, like)
    assert step == 9
    jl = jax.tree.leaves(got)
    tl = [t for _, t in tnn.tree_flatten_with_path(ttree)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert _bits(np.asarray(a)) == _bits(b)
    # both packages name and describe the leaves alike
    import json
    man = json.loads((tmp_path / "step_00000009" / "manifest.json")
                     .read_text())
    jnames, _, _ = jckpt._flatten(jtree)
    assert man["names"] == jnames
    assert "0/embed/table" in jnames and "1/.step" in jnames
    assert man["meta"]["0/extra/bf16"]["dtype"] == "bfloat16"


def test_checkpoint_integrity_and_retention(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for s in (1, 2, 3, 4):
        tckpt.save(tmp_path, s, tree, keep_last=2)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    assert (tmp_path / "LATEST").read_text() == "step_00000004"
    blob = tmp_path / "step_00000004" / "arrays_0.npz"
    data = bytearray(blob.read_bytes())
    data[len(data) // 2] ^= 0xFF
    blob.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corrupt"):
        tckpt.restore(tmp_path, tree)
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(tmp_path, {"b": tree["a"]}, step=3)
    _, t = tckpt.save(tmp_path, 5, tree, blocking=False)
    t.join()
    assert tckpt.latest_step(tmp_path) == 5


def test_port_checkpoint_reads_bf16_without_ml_dtypes():
    src = (ROOT / "src" / "repro_torch" / "checkpoint" / "checkpoint.py")
    roots = {a.name.split(".")[0] for node in ast.walk(ast.parse(
        src.read_text())) if isinstance(node, ast.Import)
        for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(ast.parse(
        src.read_text())) if isinstance(node, ast.ImportFrom)
        and node.module}
    assert "ml_dtypes" not in roots and "jax" not in roots
