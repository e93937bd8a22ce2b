"""Port parity of MLA, DeepSeek-V2's multi-head latent attention
(``repro_torch/models/attention.py`` ``mla_*``), against the JAX
package's, under ``REPRO_PALLAS=jnp``.  JAX initialises the weights; the
port takes them through numpy; both see the same bf16 input.

* ``mla_forward`` at ``deepseek_v2_lite_16b.reduced()`` (d 128, 4 heads,
  kv_lora 64, qk_nope 32, qk_rope 16, v_dim 32): a 12-token prefill into
  the latent cache and three decode steps on it (the absorbed path), in
  ``dense``, ``int8`` and ``sparse_cfmm``, against the jitted JAX
  forward: outputs within ``PREFILL_BOUND`` / ``DECODE_BOUND``, and the
  latent cache (``c_kv``, ``k_rope``) and its length equal bit for bit
  after every call.
* ``packed_codes`` and ``dense_of`` give the JAX package's bytes for
  every linear leaf form: ``values`` (int8), ``codes`` (cfmm),
  ``bs_codes`` (bitserial), ``bitmap`` + ``values`` (sparse_cfmm, with
  and without the K % 8 pad) and a float leaf.
* The absorbed decode against the expanded path on the same cache, in
  f32: within ``ABSORBED_RTOL`` of max |out|.
* One MLA block at the published widths (d 2048, 16 heads, kv_lora 512,
  qk 128 + 64, v 128: 13.6 M parameters), a 64-token prefill and two
  decode steps in ``dense`` and ``int8``, against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.core import compiled_linear as jcl
from repro.models import attention as jattn
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import attention as tattn

ARCH = "deepseek_v2_lite_16b"
MODES = ("dense", "int8", "sparse_cfmm")
# max |dout| against the jitted JAX mla_forward.  Measured (jax 0.9.0,
# reduced(), 2 x 12 tokens, max |out| 1.6-3.1): prefill 0.0078 / 0.0137 /
# 0.0117 in dense / int8 / sparse_cfmm (the jnp flash lowering rounds its
# scores and p.v to bf16 where the port follows the Pallas kernel, in
# f32); the three decode steps 0.0 in every mode (the absorbed path is
# f32 einsums on both sides).  At the published widths (1 x 64 tokens,
# max |out| 2.9-3.0): prefill 0.0156 in both modes, decode 0.00195
# (dense: four of 36864 bf16 kv_down products round a step apart at
# K = 2048, see LATENT_ULP_SHARE) and 0.0 (int8).  Held with 2.5x
# headroom over the largest prefill reading and 5x over the decode's.
PREFILL_BOUND = 0.04
DECODE_BOUND = 0.01
# dense at the published widths: the share of latent cache entries that
# may differ from JAX's, each by one bf16 step.  Measured 4 of 36864
# kv_down products (1.1e-4): XLA's and torch's bf16 GEMMs sum K = 2048
# in other orders.  int8 products are exact int32 sums: 0 there.
LATENT_ULP_SHARE = 1e-3
# absorbed vs expanded decode on one cache, f32, relative to max |out|.
# Measured 2.5e-7 to 3.5e-7 (the same sums, associated otherwise).
ABSORBED_RTOL = 2e-6


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


def _configs(full=False):
    cfgs = tuple(get(ARCH) for get in (jget_config, tget_config))
    return cfgs if full else tuple(c.reduced() for c in cfgs)


@pytest.fixture(scope="module")
def blocks():
    """full -> (JAX cfg, port cfg, JAX boxed mixer, port boxed mixer)."""
    out = {}

    def get(full=False):
        if full not in out:
            jcfg, tcfg = _configs(full)
            jp = jattn.mla_init(jax.random.PRNGKey(0), jcfg)
            out[full] = (jcfg, tcfg, jp, tnn.params_from_numpy(jp))
        return out[full]
    return get


def _served(jp, tp, mode):
    if mode == "dense":
        return jnn.unbox(jp), tnn.unbox(tp)
    return (jnn.unbox(jcl.compile_params(jp, mode=mode)),
            tnn.unbox(tcl.compile_params(tp, mode=mode)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _run_both(jcfg, tcfg, jw, tw, B, T, steps, S, seed=0):
    """A T-token prefill and ``steps`` decode steps through both packages'
    ``mla_forward`` (JAX jitted).  Yields per call (kind, JAX out, port
    out, JAX cache, port cache)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T + steps, jcfg.d_model).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(_f32(xj)).to(torch.bfloat16)
    pos = np.tile(np.arange(T + steps, dtype=np.int32), (B, 1))
    jc = jnn.unbox(jattn.mla_cache_spec(jcfg, B, S))
    tc = tnn.unbox(tattn.mla_cache_spec(tcfg, B, S))
    fwd = jax.jit(lambda p, x, ps, c: jattn.mla_forward(p, x, jcfg, ps,
                                                         cache=c))
    spans = [(0, T)] + [(t, t + 1) for t in range(T, T + steps)]
    for a, b in spans:
        jo, jc = fwd(jw, xj[:, a:b], jnp.asarray(pos[:, a:b]), jc)
        to, tc = tattn.mla_forward(tw, xt[:, a:b], tcfg,
                                   torch.from_numpy(pos[:, a:b]), cache=tc)
        yield ("prefill" if a == 0 else "decode"), jo, to, jc, tc


@pytest.mark.parametrize("mode", MODES)
def test_mla_forward_and_latent_cache_match_jax(blocks, mode):
    jcfg, tcfg, jp, tp = blocks()
    jw, tw = _served(jp, tp, mode)
    kinds = []
    for kind, jo, to, jc, tc in _run_both(jcfg, tcfg, jw, tw, B=2, T=12,
                                          steps=3, S=32):
        assert to.dtype == torch.bfloat16 and tuple(to.shape) == jo.shape
        d = float(np.abs(_f32(jo) - _f32(to)).max())
        bound = PREFILL_BOUND if kind == "prefill" else DECODE_BOUND
        assert d <= bound, (mode, kind, d)
        assert int(tc["length"]) == int(jc["length"])
        for key in ("c_kv", "k_rope"):
            assert tc[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(_f32(tc[key]), _f32(jc[key]),
                                          err_msg=f"{mode} {kind} {key}")
        kinds.append(kind)
    assert kinds == ["prefill"] + ["decode"] * 3
    assert int(tc["length"]) == 15


@pytest.mark.parametrize("mode", ["int8", "cfmm", "sparse_cfmm",
                                  "bitserial"])
def test_packed_codes_and_dense_of_equal_jax(blocks, mode):
    """Every linear leaf of the mixer, and a K = 60 leaf whose bitmap
    form carries the K % 8 pad: the dense codes and the dequantised f32
    weight are JAX's bytes."""
    jcfg, tcfg, jp, tp = blocks()
    key = jax.random.PRNGKey(1)
    jp = dict(jp, odd=jnn.linear_param(key, 60, 24, ("embed", "ffn_in")))
    tp = dict(tp, odd=tnn.params_from_numpy({"w": jp["odd"]})["w"])
    jw, tw = _served(jp, tp, mode)
    names = [k for k in tw if k != "kv_norm"]
    assert set(names) == {"q", "kv_down", "k_up", "v_up", "o", "odd"}
    if mode == "sparse_cfmm":
        assert tw["odd"]["kdim"].k == 60
        assert tw["odd"]["bitmap"].shape[0] == 64 // 8
    for name in names:
        jc, tc = jcl.packed_codes(jw[name]), tcl.packed_codes(tw[name])
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc),
                                      err_msg=f"{mode} {name}")
        jd, td = jcl.dense_of(jw[name]), tcl.dense_of(tw[name])
        assert td.dtype == torch.float32 and tuple(td.shape) == jd.shape
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd),
                                      err_msg=f"{mode} {name}")


def test_dense_of_float_leaf_and_conv_leaf(blocks):
    """A float leaf dequantises to itself in f32; a conv leaf (stored in
    the kernels' tap layout) has no consumer and raises, naming the
    function."""
    _, _, jp, tp = blocks()
    w = tnn.unbox(tp)["k_up"]
    assert torch.equal(tcl.dense_of(w), w.float())
    assert tcl.dense_of(w.to(torch.bfloat16)).dtype == torch.float32
    conv = tcl.compile_params({"c": tnn.conv_param(
        torch.Generator().manual_seed(0), 8, 16, 3, 1, ("c_in", "c_out"))},
        mode="int8")
    with pytest.raises(NotImplementedError, match="packed_codes"):
        tcl.dense_of(tnn.unbox(conv)["c"])


@pytest.mark.parametrize("mode", MODES)
def test_absorbed_decode_matches_expanded_path(blocks, mode):
    """The decode step's attention (``mla_absorbed_attention``: k_up
    pulled through the query, v_up through the context) against the
    expanded path on the same latent cache: per-head keys ``c_kv @ k_up``
    beside the rotary key, values ``c_kv @ v_up``, the port's attention
    (``gqa_attention``, its plain flash on the CPU), all in f32."""
    jcfg, tcfg, jp, tp = blocks()
    _, tw = _served(jp, tp, mode)
    m, H, B, L, S = tcfg.mla, tcfg.n_heads, 2, 13, 32
    cache = tnn.unbox(tattn.mla_cache_spec(tcfg, B, S))
    g = torch.Generator().manual_seed(2)
    x = torch.randn((B, L, tcfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.arange(L, dtype=torch.int32)[None].expand(B, L)
    _, cache = tattn.mla_forward(tw, x, tcfg, pos, cache=cache)
    q_nope = torch.randn((B, 1, H, m.qk_nope), generator=g)
    q_rope = torch.randn((B, 1, H, m.qk_rope), generator=g)
    got = tattn.mla_absorbed_attention(tw, q_nope, q_rope, cache["c_kv"],
                                       cache["k_rope"], L, tcfg)
    cc, cr = cache["c_kv"][:, :L].float(), cache["k_rope"][:, :L].float()
    k_nope = (cc @ tcl.dense_of(tw["k_up"])).reshape(B, L, H, m.qk_nope)
    v = (cc @ tcl.dense_of(tw["v_up"])).reshape(B, L, H, m.v_dim)
    k = torch.cat([k_nope, cr[:, :, None].expand(B, L, H, m.qk_rope)], -1)
    want = tattn.gqa_attention(torch.cat([q_nope, q_rope], -1), k, v,
                               causal=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"{mode}: absorbed vs expanded, max |d| / max |out| = {rel:.3g}")
    assert rel <= ABSORBED_RTOL, (mode, rel)
    # a key past the length is not read
    cache["c_kv"][:, L:] = 100.0
    again = tattn.mla_absorbed_attention(tw, q_nope, q_rope, cache["c_kv"],
                                         cache["k_rope"], L, tcfg)
    assert torch.equal(again, got)


def test_cache_spec_keeps_bf16_for_int8():
    _, tcfg = _configs()
    spec = tnn.unbox(tattn.mla_cache_spec(tcfg, 2, 16, torch.int8))
    assert spec["c_kv"].dtype == spec["k_rope"].dtype == torch.bfloat16
    assert tuple(spec["c_kv"].shape) == (2, 16, 64)
    assert tuple(spec["k_rope"].shape) == (2, 16, 16)
    jspec = jattn.mla_cache_spec(_configs()[0], 2, 16, jnp.int8)
    assert {k: p.axes for k, p in jspec.items()} == \
        {k: p.axes for k, p in tattn.mla_cache_spec(tcfg, 2, 16).items()}


@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_published_width_block_matches_jax(blocks, mode):
    """One MLA mixer at DeepSeek-V2-Lite's widths: a 64-token prefill and
    two decode steps against JAX's; the latent cache equal bit for bit in
    ``int8``, and in ``dense`` but for ``LATENT_ULP_SHARE`` of entries
    one bf16 step apart."""
    jcfg, tcfg, jp, tp = blocks(full=True)
    n = sum(p.value.numel() for p in tnn.tree_leaves(
        tp, is_leaf=lambda x: isinstance(x, tnn.Param)))
    assert 13e6 < n < 14e6
    jw, tw = _served(jp, tp, mode)
    for kind, jo, to, jc, tc in _run_both(jcfg, tcfg, jw, tw, B=1, T=64,
                                          steps=2, S=72):
        d = float(np.abs(_f32(jo) - _f32(to)).max())
        bound = PREFILL_BOUND if kind == "prefill" else DECODE_BOUND
        print(f"{mode} {kind}: max |dout| {d:.4g}")
        assert d <= bound, (mode, kind, d)
        for key in ("c_kv", "k_rope"):
            a, b = _f32(jc[key]), _f32(tc[key])
            if mode == "int8":
                np.testing.assert_array_equal(b, a, err_msg=key)
                continue
            off = a != b
            print(f"{mode} {kind} {key}: {int(off.sum())} of {off.size} "
                  "entries one bf16 step apart")
            assert off.mean() <= LATENT_ULP_SHARE, (key, off.mean())
            step = np.abs(a) * 2.0 ** -7        # one bf16 step at |a|
            assert bool((np.abs(a - b) <= step)[off].all()), key
    assert int(tc["length"]) == 66
