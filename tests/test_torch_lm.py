"""Port parity of the LM serving slice: JAX ``lm.init`` ->
``params_from_numpy`` -> each package compiles its own tree -> the
port's ``ServingEngine(device="cpu")`` against the JAX package's
``ServingEngine``, whose jitted forwards (``serving/engine.py``) are the
oracle, under ``REPRO_PALLAS=jnp``.

Configs: ``smollm_360m.reduced()`` (4 layers, d 128, KVH 1, G 4) and
``build_cfg("smollm_360m", "tiny")`` (2 layers, KVH 2, G 2).

* Compiled bytes are equal, leaf for leaf, stacked ``layers`` leaves
  included, in ``int8``, ``cfmm`` and ``sparse_cfmm`` (tier 1).
* ``rmsnorm`` and ``apply_rope`` are within one bf16 ulp of the jitted
  JAX functions (bit-equal with jax 0.9.0; XLA's reductions and
  ``cos``/``sin`` may round otherwise in other versions); ``ffn`` within
  ``FFN_BOUND``: XLA rounds silu's ``exp`` to bf16
  and fuses the rest in f32, the port rounds silu once, and a one-ulp
  change of the down projection's input can flip its int8 code.
* Logits: every prefill and decode call of the two engines, fed the same
  tokens, agrees within ``LOGIT_BOUND``; greedy tokens are equal up to
  the first step where JAX's own margin between its top token and the
  port's is within twice that bound (there the tokens may part, and
  every later step sees other inputs).  The bound is not 0: bf16 rounds
  where XLA's fusion puts it, the jnp flash lowering rounds its scores
  and ``p.v`` to bf16 where the port follows the Pallas kernel (f32),
  and one flipped int8 activation code moves a layer's output by a
  step of its scale.  Measured: see ``LOGIT_BOUND`` in
tests/_torch_lm_parity.py, the harness these tests share with the
other LM configs' files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import (LOGIT_BOUND, compare_calls, flat_jax,
                              flat_port, run_engines, to_np)
from repro import nn as jnn
from repro.configs import smollm_360m as jsm
from repro.core import compiled_linear as jcl
from repro.launch import train as jtrain
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import engine as jeng
from repro_torch import nn as tnn
from repro_torch.configs import smollm_360m as tsm
from repro_torch.core import compiled_linear as tcl
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as teng

# max |d ffn| measured: 0.0166 (outputs up to about 0.7)
FFN_BOUND = 0.03
CASES = [("reduced", "int8"), ("reduced", "sparse_cfmm"), ("tiny", "int8"),
         ("tiny", "cfmm"), ("tiny", "sparse_cfmm")]
PROMPTS = (5, 13, 8)        # buckets 8, 16, 8
SLOTS, MAX_SEQ, MAX_NEW = 2, 32, 4


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


def _configs(name):
    if name == "reduced":
        return jsm.CONFIG.reduced(), tsm.CONFIG.reduced()
    return (jtrain.build_cfg("smollm_360m", "tiny"),
            tserve.build_cfg("smollm_360m", "tiny"))


@pytest.fixture(scope="module")
def trees():
    """{config: (JAX boxed tree, the port's boxed tree)}: the same f32
    weights on both sides."""
    out = {}
    for name in ("reduced", "tiny"):
        jcfg, _ = _configs(name)
        jt = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
        out[name] = (jt, tnn.params_from_numpy(jt))
    return out


@pytest.fixture(scope="module")
def compiled(trees):
    """(config, mode) -> (JAX boxed compiled tree, port's boxed compiled
    tree), compiled once per module."""
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            jt, tt = trees[name]
            cache[name, mode] = (jcl.compile_params(jt, mode=mode),
                                 tcl.compile_params(tt, mode=mode))
        return cache[name, mode]
    return get


def test_configs_match_jax():
    for name in ("reduced", "tiny"):
        jcfg, tcfg = _configs(name)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jsm.CONFIG) == dataclasses.asdict(tsm.CONFIG)
    sigs = tsm.CONFIG.layer_sigs()
    assert tlm.group_layers(sigs) == jlm.group_layers(sigs) == (0, 1, 32, 0)


def test_params_carry_stacked_layers_unchanged(trees):
    """``params_from_numpy`` keeps JAX's stacked template leaves, their
    ``("layers", ...)`` axes and kinds; the port's own ``lm.init`` builds
    the same tree (paths, shapes, axes, kinds) from a generator."""
    jt, tt = trees["reduced"]
    jf, tf = flat_jax(jt), flat_port(tt)
    assert jf.keys() == tf.keys()
    for k, jp in jf.items():
        tp = tf[k]
        assert (tp.axes, tp.kind) == (jp.axes, jp.kind), k
        np.testing.assert_array_equal(tp.value.numpy(), np.asarray(jp.value))
    q = tt["template"][0]["mixer"]["q"]
    assert q.axes == ("layers", "embed", "heads_q") and q.kind == "linear"
    assert tuple(q.value.shape) == (4, 128, 128)
    own = flat_port(tlm.init(torch.Generator().manual_seed(0),
                              tsm.CONFIG.reduced()))
    assert own.keys() == tf.keys()
    for k, p in own.items():
        assert (tuple(p.value.shape), p.axes, p.kind) == (
            tuple(tf[k].value.shape), tf[k].axes, tf[k].kind), k
    emb = own["['embed']['table']"].value
    assert 0.015 < float(emb.std()) < 0.025       # the 0.02 embed init


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm"])
def test_compiled_bytes_equal_jax(compiled, mode):
    """Tier 1: codes, scales, bitmap and values of every leaf — the
    stacked (layers, K, N) template leaves included — are the same
    bytes, under the same logical axes."""
    jc, tc = compiled("reduced", mode)
    jf, tf = flat_jax(jc), flat_port(tc)
    assert jf.keys() == tf.keys()
    n_stacked = 0
    for k, jp in jf.items():
        tp = tf[k]
        assert tp.axes == jp.axes, k
        a, b = np.asarray(jp.value), tp.value.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
        n_stacked += "['template']" in k and tp.axes[0] == "layers"
    assert n_stacked >= 7 * 2          # seven linears, two parts each


@pytest.fixture(scope="module")
def layer_inputs(trees):
    jt, tt = trees["reduced"]
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 128).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    return jt, tt, xj, xt


def _assert_within_bf16_ulp(want, got):
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= ulp)


def test_rmsnorm_and_rope_match_jax(layer_inputs):
    jt, tt, xj, xt = layer_inputs
    jp = jax.tree.map(lambda a: a[1], jnn.unbox(jt["template"][0]["ln1"]))
    tp = tlm._layer(tnn.unbox(tt["template"][0]["ln1"]), 1)
    tp = {"scale": tp["scale"] * 0.5 + 0.25}      # a non-trivial scale
    jp = {"scale": jnp.asarray(tp["scale"].numpy())}
    want = jax.jit(lambda p, x: jlayers.rmsnorm(p, x, 1e-6))(jp, xj)
    _assert_within_bf16_ulp(to_np(want), tlayers.rmsnorm(tp, xt, 1e-6).float())
    q = xt.reshape(2, 9, 4, 32)
    pos = np.arange(3, 12)[None].repeat(2, 0)
    want = jax.jit(jlayers.apply_rope)(jnp.asarray(q.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(pos))
    got = tlayers.apply_rope(q, torch.from_numpy(pos))
    _assert_within_bf16_ulp(to_np(want), got.float())


@pytest.mark.parametrize("mode", ["int8", "sparse_cfmm"])
def test_ffn_matches_jax(compiled, layer_inputs, mode):
    _, _, xj, xt = layer_inputs
    jc, tc = compiled("reduced", mode)
    jp = jax.tree.map(lambda a: a[0], jnn.unbox(jc["template"][0]["ffn"]))
    tp = tlm._layer(tnn.unbox(tc["template"][0]["ffn"]), 0)
    want = to_np(jax.jit(jlayers.ffn)(jp, xj))
    got = tlayers.ffn(tp, xt).float().numpy()
    assert float(np.abs(got - want).max()) <= FFN_BOUND


# ---------------------------------------------------------------------------
# The two engines, call by call
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(compiled):
    """(config, mode) -> the two engines' runs (tests/_torch_lm_parity.py
    ``run_engines``): per forward call its kind, the active rows and the
    last-position logits of both packages, and both engines' tokens."""
    runs = {}

    def get(name, mode):
        if (name, mode) not in runs:
            jcfg, tcfg = _configs(name)
            runs[name, mode] = run_engines(jcfg, tcfg, *compiled(name, mode),
                                           mode, PROMPTS, SLOTS, MAX_SEQ,
                                           MAX_NEW)
        return runs[name, mode]
    return get


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_prefill_and_decode_logits_match_jitted_jax(served, case):
    run = served(*case)
    worst, n_tok, _ = compare_calls(run)
    assert {kind for kind, _, _, _ in run["calls"]} == {"prefill", "decode"}
    assert n_tok >= len(PROMPTS) + 1    # every prefill and a decode step
    assert worst <= LOGIT_BOUND, (case, worst)


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_engine_greedy_tokens_match_jitted_jax(served, case):
    """Greedy tokens equal wherever JAX's margin exceeds twice the logit
    bound; with no step parted, the whole token streams are equal."""
    run = served(*case)
    _, n_tok, margins = compare_calls(run)
    assert all(m <= 2 * LOGIT_BOUND for m in margins), (case, margins)
    if not margins:
        assert n_tok == len(PROMPTS) * MAX_NEW
        assert run["port_tokens"] == run["jax_tokens"]


# ---------------------------------------------------------------------------
# Invariants inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_reduced(compiled):
    _, tc = compiled("reduced", "int8")
    return tsm.CONFIG.reduced(), tnn.unbox(tc)


def _prefill(cfg, params, toks, bucket=None, S=48):
    cache = tnn.unbox(tlm.cache_init(cfg, 1, S))
    L = len(toks)
    padded = np.zeros((1, bucket or L), np.int64)
    padded[0, :L] = toks
    batch = {"tokens": torch.from_numpy(padded)}
    if bucket is not None:
        batch["length"] = torch.tensor([L], dtype=torch.int32)
    return tlm.forward_prefill(params, batch, cfg, cache)


def test_bucketed_prefill_against_unpadded(port_reduced):
    """A bucketed (end-padded) prefill rewinds every length counter to
    the true length, sets ``pos``, and gives the unpadded prefill's
    logits and cache rows below the length within the bf16 bound.  Not
    bit for bit: in the compiled modes the pad rows share the
    tensor-wide activation scale of every linear (the JAX package's
    ``act_quant``), so they can move real rows' int8 codes — a property
    of the reference's design, recorded in ROADMAP queue C."""
    cfg, params = port_reduced
    toks = np.random.RandomState(3).randint(1, cfg.vocab, 13)
    la, ca = _prefill(cfg, params, toks)
    lb, cb = _prefill(cfg, params, toks, bucket=16)
    assert torch.equal(cb["pos"], torch.tensor([13], dtype=torch.int32))
    assert torch.equal(cb["template"][0]["length"],
                       torch.full((4,), 13, dtype=torch.int32))
    assert torch.equal(ca["template"][0]["length"],
                       cb["template"][0]["length"])
    assert float((la.float() - lb.float()).abs().max()) <= LOGIT_BOUND
    for key in ("k", "v"):
        a = ca["template"][0][key][:, :, :13].float()
        b = cb["template"][0][key][:, :, :13].float()
        assert float((a - b).abs().max()) <= 0.25 * float(a.abs().max())


def test_prefill_then_decode_matches_longer_prefill(port_reduced):
    """The port's analogue of tests/test_decode.py: a prefill of the
    first T - 3 tokens and three decode steps give the logits of the
    prefill of the first T - 3 .. T tokens, within the bf16 bound; the
    cache counters advance one per step."""
    cfg, params = port_reduced
    toks = np.random.RandomState(4).randint(1, cfg.vocab, 16)
    T = len(toks)
    logits, cache = _prefill(cfg, params, toks[:T - 3])
    got = [logits]
    for t in range(T - 3, T):
        logits, cache = tlm.forward_decode(
            params, {"token": torch.tensor([[int(toks[t])]])}, cfg, cache)
        got.append(logits)
    assert torch.equal(cache["pos"], torch.tensor([T], dtype=torch.int32))
    assert int(cache["template"][0]["length"][0]) == T
    for i, n in enumerate(range(T - 3, T + 1)):
        want, _ = _prefill(cfg, params, toks[:n])
        assert float((got[i].float() - want.float()).abs().max()) \
            <= LOGIT_BOUND, n


def test_merge_slot_cache_follows_jax_rules():
    """Rows land in their slot; stacked and scalar counters take the
    max; the shared cache is written in place."""
    full = {"k": torch.zeros(2, 3, 4), "length": torch.tensor([1, 1]),
            "pos": torch.tensor([5, 0]), "n": torch.tensor(2)}
    one = {"k": torch.ones(2, 1, 4), "length": torch.tensor([3, 0]),
           "pos": torch.tensor([7]), "n": torch.tensor(1)}
    k = full["k"]
    out = teng._merge_slot_cache(full, one, 1)
    assert out["k"] is k and torch.equal(k[:, 1], torch.ones(2, 4))
    assert torch.equal(k[:, [0, 2]], torch.zeros(2, 2, 4))
    assert out["length"].tolist() == [3, 1] and out["pos"].tolist() == [5, 7]
    assert int(out["n"]) == 2


def test_submit_rejects_overlong_prompts_and_budgets(port_reduced):
    cfg, params = port_reduced
    eng = teng.ServingEngine(cfg, params, mode="int8", batch_slots=1,
                             max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds the engine's max_seq"):
        eng.submit(teng.Request(rid=0, prompt=[1] * 17, max_new_tokens=1))
    with pytest.raises(ValueError, match="overrun the cache"):
        eng.submit(teng.Request(rid=1, prompt=[1] * 12, max_new_tokens=6))
    eng.submit(teng.Request(rid=2, prompt=[1] * 12, max_new_tokens=5))
    assert len(eng.queue) == 1


def test_bucket_len_matches_jax():
    for L in (1, 7, 8, 9, 100, 129, 1000, 1048):
        assert teng._bucket_len(L, 1048) == jeng._bucket_len(L, 1048)


