"""M-RoPE and the int8 KV cache in the port, against the JAX package, on
the CPU at Qwen2-VL-7B's ``reduced()`` shapes (4 layers, d 128, 4 heads
over 1 KV head of 32, M-RoPE sections (8, 4, 4), untied head), the JAX
side jitted under ``REPRO_PALLAS=jnp`` (its LM oracle, ROADMAP tier 4).

* ``apply_rope`` with three equal position streams equals standard RoPE
  bit for bit; with distinct streams it is within one bf16 ulp of the
  jitted JAX function (the port's RoPE tolerance, tests/test_torch_lm.py);
  sections that do not sum to head_dim / 2 raise in both packages.
* A prefill of a Qwen2-VL-style prompt (text, an image grid at 3-D
  positions, text) and four decode steps, dense weights, against the
  jitted JAX ``forward_prefill`` / ``forward_decode``: logits within the
  ``dense`` bound of tests/_torch_lm_parity.py (0.06).
* The int8 KV cache (``cache_init(kv_dtype=int8)``) on the same calls,
  against JAX's.  The first layer's codes and scales are byte-equal
  after the prefill and after every step, and so are the port's
  ``_kv_quant`` codes of JAX's own bf16 prefill keys and values at every
  layer (XLA rewrites ``/ 127.0`` as a multiply by f32(1/127) under
  ``jit``; the port multiplies so on every device).  Past the first layer
  the two caches' inputs differ: the stack's bf16 spread (the jnp flash
  lowering rounds scores and ``p.v`` to bf16, the port keeps f32, as the
  Pallas kernel) moves the bf16 keys and values there as well.  Measured
  (jax 0.9.0): 37-50 % of those codes differ, by up to 4 codes, where
  79-84 % of the bf16 cache's values differ.  The logits stay within the
  same bound.
* ``forward_train``'s loss and gradient with 3-D positions against
  ``jax.value_and_grad`` of the jitted JAX loss, with the gradient bound
  of tests/test_torch_train_lm.py and its loss bound scaled for an
  untied head (``UNTIED_LOSS_ATOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_parity import LOGIT_BOUND, flat_port, to_np
from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.training import train_step as tts

ARCH = "qwen2_vl_7b"
B, MAX_SEQ, STEPS = 2, 32, 4
# tests/test_torch_train_lm.py's gradient bound (relative L2 per leaf;
# measured here 0.019-0.022 with 3-D positions or text ones).  Its loss
# bound, 1e-3, was set on SmolLM's tied head (measured 3e-5 to 2.6e-4
# here); an untied head's logits are 4.4x as wide (tests/_torch_lm_
# parity.py), and the losses spread as much with text positions:
# StableLM-3B 9.0e-4 to 3.1e-3, Phi-3 2.1e-4 to 1.1e-3, Qwen2-VL 4.2e-4 to
# 1.3e-3 on text positions and 3.0e-4 to 2.7e-3 on 3-D ones (jax 0.9.0,
# three batches each).  Held to 1e-3 x 4.4, as the logit bounds are.
UNTIED_LOSS_ATOL, GRAD_REL_L2 = 4.4e-3, 0.05


@pytest.fixture(scope="module", autouse=True)
def _jnp_lowering_one_torch_thread():
    """The JAX side runs its jnp lowering; torch runs one thread beside
    XLA's pool (the two pools oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_PALLAS", "jnp")
            yield
    finally:
        torch.set_num_threads(threads)


def _assert_within_bf16_ulp(want, got):
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= ulp)


def vl_positions(text_before, grid, text_after):
    """Qwen2-VL's 3-D positions for one prompt: ``text_before`` text
    tokens at 0.. on every stream, an image of ``grid`` = (t, h, w)
    patches at (p + t, p + h, p + w) from p = text_before, then
    ``text_after`` text tokens from one past the image's largest
    position.  Returns (3, T) int32."""
    gt, gh, gw = grid
    text = np.arange(text_before)
    t, h, w = np.meshgrid(np.arange(gt), np.arange(gh), np.arange(gw),
                          indexing="ij")
    img = np.stack([t.ravel(), h.ravel(), w.ravel()]) + text_before
    start = int(img.max()) + 1
    after = np.arange(start, start + text_after)
    return np.concatenate([np.stack([text] * 3), img,
                           np.stack([after] * 3)], axis=1).astype(np.int32)


def prompt_positions():
    """(3, B, T + STEPS): two 20-token prompts (3 and 5 leading text
    tokens, a 1 x 3 x 4 image, 5 and 3 trailing) and the STEPS decode
    positions after each, every stream equal there."""
    rows = []
    for before, after in ((3, 5), (5, 3)):
        p = vl_positions(before, (1, 3, 4), after)
        nxt = p.max() + 1 + np.arange(STEPS, dtype=np.int32)
        rows.append(np.concatenate([p, np.stack([nxt] * 3)], axis=1))
    return np.stack(rows, axis=1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config(ARCH).reduced()
    tcfg = tget_config(ARCH).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    boxed = jax.jit(jlm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return (jcfg, tcfg, jnn.unbox(boxed),
            tnn.unbox(tnn.params_from_numpy(boxed)))


# ---------------------------------------------------------------------------
# The rotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D,sections,theta", [(32, (8, 4, 4), 1e6),
                                              (128, (16, 24, 24), 1e6)])
def test_equal_streams_are_standard_rope_bit_for_bit(dtype, D, sections,
                                                     theta):
    g = torch.Generator().manual_seed(D)
    x = torch.randn((2, 37, 3, D), generator=g).to(dtype)
    pos = torch.randint(0, 5000, (2, 37), generator=g, dtype=torch.int32)
    want = tlayers.apply_rope(x, pos, theta)
    got = tlayers.apply_rope(x, pos[None].expand(3, 2, 37), theta, sections)
    assert torch.equal(got, want)


@pytest.mark.parametrize("D,sections", [(32, (8, 4, 4)),
                                        (128, (16, 24, 24))])
def test_distinct_streams_match_jax(D, sections):
    rng = np.random.RandomState(D)
    x = rng.randn(2, 17, 4, D).astype(np.float32)
    pos = rng.randint(0, 3000, (3, 2, 17)).astype(np.int32)
    want = jax.jit(jlayers.apply_rope, static_argnums=(2, 3))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos), 1e6, sections)
    got = tlayers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(pos), 1e6, sections)
    _assert_within_bf16_ulp(to_np(want), got.float())
    # the streams reach the rotation: another stream moves the output
    other = tlayers.apply_rope(torch.from_numpy(x).to(torch.bfloat16),
                               torch.from_numpy(pos[[0, 0, 0]]), 1e6,
                               sections)
    assert not torch.equal(other, got)


def test_sections_not_covering_half_head_dim_raise():
    """Qwen2-VL's published sections (sum 64) at head_dim 32, as
    ``build_cfg("qwen2_vl_7b", "tiny")`` gives: both packages refuse."""
    x = np.zeros((1, 4, 2, 32), np.float32)
    pos = np.zeros((3, 1, 4), np.int32)
    with pytest.raises(AssertionError):
        jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                           (16, 24, 24))
    with pytest.raises(ValueError, match="do not sum"):
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           (16, 24, 24))
    with pytest.raises(ValueError, match="mrope_sections"):
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)


# ---------------------------------------------------------------------------
# Prefill and decode on 3-D positions, bf16 and int8 caches
# ---------------------------------------------------------------------------

def _flat_cache(tree, port):
    flat = flat_port(tree) if port else {
        jax.tree_util.keystr(p): v
        for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    # the port writes its cache in place: copy each call's state
    return {k: ((v.float() if v.dtype == torch.bfloat16 else v).numpy()
                .copy() if port else to_np(v)) for k, v in flat.items()
            if not k.endswith("['length']") and not k.endswith("['pos']")}


def _run_both(setup, kv_dtype):
    """Prefill T tokens at 3-D positions and decode STEPS steps in both
    packages.  Returns per call (JAX logits, port logits, JAX cache,
    port cache), numpy."""
    jcfg, tcfg, jp, tp = setup
    pos = prompt_positions()
    T = pos.shape[-1] - STEPS
    toks = np.random.RandomState(5).randint(1, jcfg.vocab, (B, T + STEPS))
    jcache = jnn.unbox(jlm.cache_init(
        jcfg, B, MAX_SEQ, kv_dtype=jnp.int8 if kv_dtype else None))
    tcache = tnn.unbox(tlm.cache_init(
        tcfg, B, MAX_SEQ, kv_dtype=torch.int8 if kv_dtype else None))
    jpre = jax.jit(lambda p, b, c: jlm.forward_prefill(p, b, jcfg, c))
    jdec = jax.jit(lambda p, b, c: jlm.forward_decode(p, b, jcfg, c))
    out = []
    for step in range(STEPS + 1):
        sl = slice(0, T) if step == 0 else slice(T + step - 1, T + step)
        key = "tokens" if step == 0 else "token"
        jb = {key: jnp.asarray(toks[:, sl]),
              "positions": jnp.asarray(pos[:, :, sl])}
        tb = {key: torch.from_numpy(toks[:, sl]),
              "positions": torch.from_numpy(pos[:, :, sl])}
        fn, tfn = (jpre, tlm.forward_prefill) if step == 0 else \
            (jdec, tlm.forward_decode)
        jl, jcache = fn(jp, jb, jcache)
        with torch.no_grad():
            tl, tcache = tfn(tp, tb, tcfg, tcache)
        out.append((to_np(jl[:, -1]), tl[:, -1].float().numpy(),
                    _flat_cache(jcache, False), _flat_cache(tcache, True)))
    return out


@pytest.fixture(scope="module")
def runs(setup):
    return {kv: _run_both(setup, kv) for kv in (False, True)}


def _layer0(flat, key, n):
    """Layer 0's rows below ``n`` of a stacked cache leaf."""
    return flat[f"['template'][0]['{key}']"][0, :, :n]


def test_mrope_prefill_and_decode_match_jitted_jax(runs):
    """JAX's tests/test_decode.py on 3-D positions, port against JAX: the
    prefill and every decode step within the dense bound; the first
    layer's bf16 cache rows equal JAX's (the later layers carry the
    stack's bf16 spread)."""
    n0 = prompt_positions().shape[-1] - STEPS
    for step, (jl, tl, jc, tc) in enumerate(runs[False]):
        assert np.isfinite(jl).all() and np.isfinite(tl).all()
        assert float(np.abs(jl - tl).max()) <= LOGIT_BOUND, step
        assert jc.keys() == tc.keys() and len(jc) == 2
        for key in ("k", "v"):
            np.testing.assert_array_equal(_layer0(tc, key, n0 + step),
                                          _layer0(jc, key, n0 + step))


def test_text_positions_do_not_equal_3d_ones(setup, runs):
    """The 3-D positions reach the served logits: the same prompt at text
    positions prefills to other logits."""
    jcfg, tcfg, _, tp = setup
    T = prompt_positions().shape[-1] - STEPS
    toks = np.random.RandomState(5).randint(1, jcfg.vocab, (B, T + STEPS))
    cache = tnn.unbox(tlm.cache_init(tcfg, B, MAX_SEQ))
    with torch.no_grad():
        tl, _ = tlm.forward_prefill(tp, {"tokens": torch.from_numpy(
            toks[:, :T])}, tcfg, cache)
    assert float(np.abs(tl[:, -1].float().numpy() - runs[False][0][1])
                 .max()) > LOGIT_BOUND


def test_int8_kv_cache_codes_and_scales_match_jitted_jax(runs):
    """The int8 cache against JAX's: the same leaves (codes ``k``/``v``
    int8, scales ``k_s``/``v_s`` bf16); the first layer's codes and
    scales byte-equal after the prefill and after every step, rows past
    the written length zero; and the port's quantizer on JAX's own bf16
    prefill keys and values gives JAX's codes and scales at every
    layer."""
    n0 = prompt_positions().shape[-1] - STEPS
    for step, (_, _, jc, tc) in enumerate(runs[True]):
        n = n0 + step
        assert jc.keys() == tc.keys()
        assert {k.rsplit("['", 1)[1] for k in jc} == {
            "k']", "v']", "k_s']", "v_s']"}
        for key in ("k", "v", "k_s", "v_s"):
            got = _layer0(tc, key, n)
            assert got.dtype == (np.int8 if len(key) == 1 else np.float32)
            np.testing.assert_array_equal(got, _layer0(jc, key, n))
            assert not tc[f"['template'][0]['{key}']"][:, :, n:].any()
        if step == 0:
            for key in ("k", "v"):
                d = np.abs(jc[f"['template'][0]['{key}']"][1:, :, :n]
                           .astype(np.int32)
                           - tc[f"['template'][0]['{key}']"][1:, :, :n])
                print(f"layers 1-3 {key}: {float((d != 0).mean()):.3f} of "
                      f"codes differ, by up to {int(d.max())}")
    # the quantizer on the oracle's own inputs: JAX's bf16 prefill rows
    # (the int8 run's prefill attends the same unquantized keys)
    _, _, jbf, _ = runs[False][0]
    _, _, j8, _ = runs[True][0]
    for key in ("k", "v"):
        rows = torch.tensor(jbf[f"['template'][0]['{key}']"][:, :, :n0])
        codes, scales = tattn._kv_quant(rows.to(torch.bfloat16))
        np.testing.assert_array_equal(
            codes.numpy(), j8[f"['template'][0]['{key}']"][:, :, :n0])
        np.testing.assert_array_equal(
            scales.float().numpy(),
            j8[f"['template'][0]['{key}_s']"][:, :, :n0])


def test_int8_kv_quantizer_matches_jitted_jax_on_bf16_keys():
    """``_kv_quant`` alone on bf16 keys, against JAX's under ``jit``:
    codes and scales byte-equal (XLA rewrites ``/ 127.0`` as a multiply
    by f32(1/127), which the port does on every device; the codes round
    half to even against the f32 scale)."""
    from repro.models import attention as jattn
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 65, 4, 128) * rng.rand(3, 65, 4, 1) * 4).astype(
        np.float32)
    x[0, 0, 0] = 0.0                              # amax 0: the 1e-6 floor
    x[0, 1, 0, :2] = (127.5 / 127.0, 1.0)         # a tie at the largest code
    jq, js = jax.jit(jattn._kv_quant)(jnp.asarray(x).astype(jnp.bfloat16))
    tq, ts = tattn._kv_quant(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(to_np(js), ts.float().numpy())
    assert ts.dtype == torch.bfloat16 and tq.dtype == torch.int8


def test_int8_kv_decode_logits_within_bound(runs):
    """The int8 cache's prefill attends its own unquantized keys: its
    logits equal the bf16 cache's; its decode steps within the dense
    bound of JAX's, and off the bf16 cache's (the codes are read)."""
    bf, q8 = runs[False], runs[True]
    np.testing.assert_array_equal(q8[0][1], bf[0][1])
    for step, (jl, tl, _, _) in enumerate(q8):
        assert np.isfinite(tl).all()
        assert float(np.abs(jl - tl).max()) <= LOGIT_BOUND, step
    assert max(float(np.abs(q8[s][1] - bf[s][1]).max())
               for s in range(1, STEPS + 1)) > 0


def test_cache_init_int8_builds_scale_leaves(setup):
    _, tcfg, _, _ = setup
    cache = tnn.unbox(tlm.cache_init(tcfg, B, MAX_SEQ, kv_dtype=torch.int8))
    leaf = cache["template"][0]
    L = tcfg.n_layers
    assert leaf["k"].dtype == leaf["v"].dtype == torch.int8
    assert leaf["k"].shape == (L, B, MAX_SEQ, tcfg.n_kv_heads, tcfg.head_dim)
    for s in ("k_s", "v_s"):
        assert leaf[s].dtype == torch.bfloat16
        assert leaf[s].shape == (L, B, MAX_SEQ, tcfg.n_kv_heads)


# ---------------------------------------------------------------------------
# Training on 3-D positions
# ---------------------------------------------------------------------------

def test_forward_train_loss_and_gradient_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    pos = prompt_positions()
    toks = np.random.RandomState(7).randint(1, jcfg.vocab, pos.shape[1:])
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "positions": jnp.asarray(pos)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "positions": torch.from_numpy(pos)}

    def loss_of(p):
        logits, aux = jlm.forward_train(p, jb, jcfg)
        return jlm.loss_fn(logits, jb["labels"], aux)

    (jloss, _), jg = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jp)
    tloss, _, tg = tts.value_and_grad(tp, tb, tcfg)
    assert abs(float(tloss) - float(jloss)) <= UNTIED_LOSS_ATOL
    jl = jax.tree_util.tree_flatten_with_path(jg)[0]
    tl = tnn.tree_flatten_with_path(tg)
    for (_, a), (path, t) in zip(jl, tl, strict=True):
        a, t = np.asarray(a, np.float32), t.float().numpy()
        rel = np.linalg.norm(t - a) / max(np.linalg.norm(a), 1e-30)
        assert rel <= GRAD_REL_L2, path
    # the positions reach the loss: text positions give another one
    plain = {k: v for k, v in tb.items() if k != "positions"}
    with torch.no_grad():
        other = tlm.loss_fn(tlm.forward_train(tp, plain, tcfg)[0],
                            plain["labels"])[0]
    assert float(other) != float(tloss)
