"""Port parity of the recurrent mixers (``repro_torch/models/ssm.py``,
Mamba-1 and RWKV-6, and ``lm.rwkv_cm``) against the JAX package's
``models/ssm.py`` under ``REPRO_PALLAS=jnp``, at ``reduced()`` of
``jamba_v01_52b`` (Mamba: d 128, d_inner 256, d_state 8, dt_rank 8) and
``rwkv6_7b`` (RWKV: d 128, 4 heads of 32, decay lora 16).  JAX
initialises the weights; the port takes them through numpy.  Inputs are
bf16, made from a seed with numpy, as the LM feeds the mixers.

* The associative scan: the port's recursion against eager
  ``jax.lax.associative_scan`` of the same combine, bit for bit, at
  lengths 1 to 128 (odd, even, powers of two: 1, 2, 5, 8, 37, 128); the
  bf16 ``silu``, ``sigmoid`` and ``softplus`` against jitted ``jax.nn``,
  bit for bit.
* The chunked prefill (T = 20 at chunk 8; T = 37 and 777, which the
  default chunks of 128 and 64 do not divide) against the jitted JAX
  forward, in ``dense`` and ``int8``: y and the new state (Mamba ``conv``
  bf16 and ``ssm`` f32; RWKV ``shift`` bf16 and ``wkv`` f32), with the
  state dtypes equal.
* The ``T == 1`` decode step on a carried state (JAX's state after a
  prefill, carried across) against JAX's step.
* Each package's sequential reference (``mamba_ref``; RWKV one token a
  step) against its own chunked forward, and the port's against JAX's.
* ``rwkv_cm`` with and without a carried shift.
* JAX's chunked RWKV overflows to NaN where its pairs s >= t pass e^88
  (queue C in ROADMAP): the port selects those pairs away and is finite
  there, and within ``OVERFLOW_BOUND`` of the stepwise recurrence.

The bounds are max |dy| (y of max |y| 0.7-2.5) and max |dstate|,
measured with jax 0.9.0; the eager-JAX readings show where the port
follows JAX's op-by-op rounding exactly and the jitted forward's FMA
contraction (queue C) is what remains.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.configs.base import get_config as jget_config
from repro.core import compiled_linear as jcl
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import nn as tnn
from repro_torch.configs.base import get_config as tget_config
from repro_torch.core import compiled_linear as tcl
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ARCH = {"mamba": "jamba_v01_52b", "rwkv": "rwkv6_7b"}
FWD = {"mamba": (jssm.mamba_forward, tssm.mamba_forward),
       "rwkv": (jssm.rwkv6_forward, tssm.rwkv6_forward)}
INIT = {"mamba": jssm.mamba_init, "rwkv": jssm.rwkv6_init}
# (T, chunk): None keeps the default (128 for Mamba, 64 for RWKV)
PREFILLS = ((20, 8), (37, None), (777, None))
# max |dy| and max |dstate| against the jitted JAX forward, per mixer and
# mode.  Measured (jax 0.9.0) over PREFILLS, y of max |y| 0.9-3.0:
# Mamba dense y 0.0039-0.0078 (1 bf16 ulp), int8 0.0127-0.0234 (a
# flipped activation code); the f32 ssm state 1.8e-4-2.3e-4, as far as
# JAX's jitted forward is from its eager one (XLA contracts the scan's
# a2*b1 + b2 into an FMA; the port against eager JAX reads 3e-5 / 2e-7
# at T = 20).  RWKV y 6e-5-0.0039 in dense, 0 in int8 (0.0156, 1 ulp at
# |y| > 2, on the finite rows at T = 777); wkv 1.4e-6-1.5e-5.  The bf16
# states (Mamba conv, RWKV shift) are equal.  Held with 2x headroom.
Y_BOUND = {("mamba", "dense"): 0.016, ("mamba", "int8"): 0.047,
           ("rwkv", "dense"): 0.031, ("rwkv", "int8"): 0.031}
STATE_BOUND = {"mamba": 5e-4, "rwkv": 4e-5}
# the T == 1 step on JAX's carried state: measured y 0.002 / 0.0039
# (Mamba dense / int8) and 0 (RWKV), states within STATE_BOUND; the
# port's mamba_ref against JAX's 0.0039
STEP_BOUND = 0.008
# one-token-a-step against chunked, within the port: JAX's test_ssm.py
# holds JAX's to 3e-2 (Mamba) and 4e-2 (RWKV); the port's measure 0 at
# T = 20 and 0.0078 on the rows where JAX is finite at T = 777
SEQ_BOUND = {"mamba": 0.016, "rwkv": 0.016}
# where JAX's chunk is NaN, the port's against the stepwise recurrence:
# measured 0.137 (max |y| 3.3): the mid-chunk reference's clip at +-60
# inflates the pairs whose decay spread passes it, in JAX's chunk as in
# the port's
OVERFLOW_BOUND = 0.3


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


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def mixers():
    """(kind, mode) -> (JAX config, port config, JAX unboxed tree, port
    unboxed tree): JAX's init, carried across; in ``int8`` each package
    compiles its own copy."""
    out = {}

    def get(kind, mode="dense"):
        if (kind, mode) not in out:
            jcfg = jget_config(ARCH[kind]).reduced()
            tcfg = tget_config(ARCH[kind]).reduced()
            jp = INIT[kind](jax.random.PRNGKey(0), jcfg)
            tp = tnn.params_from_numpy(jp)
            if mode != "dense":
                jp = jcl.compile_params(jp, mode=mode)
                tp = tcl.compile_params(tp, mode=mode)
            out[kind, mode] = (jcfg, tcfg, jnn.unbox(jp), tnn.unbox(tp))
        return out[kind, mode]
    return get


def _x(T, d, seed=0, B=2):
    x = np.random.RandomState(seed).randn(B, T, d).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _state_to_port(state):
    return {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in state.items()}


# ---------------------------------------------------------------------------
# The associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 8, 37, 128])
def test_associative_scan_bit_exact_against_eager_jax(n):
    """h_t = a_t h_{t-1} + b_t by the odd/even recursion, along axis 1
    of (B, n, di, N) f32, random a in (0.5, 1) and b: the same bits as
    eager ``jax.lax.associative_scan`` (each combine's product and sum
    rounded on its own)."""
    rng = np.random.RandomState(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.randn(2, n, 3, 4).astype(np.float32)

    def comb(x, y):
        a1, b1 = x
        a2, b2 = y
        return a1 * a2, a2 * b1 + b2

    ja, jb = jax.lax.associative_scan(comb, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    ta, tb = tssm.associative_scan(tssm._linear_comb, (torch.from_numpy(a),
                                                       torch.from_numpy(b)),
                                   axis=1)
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("name", ["silu", "sigmoid", "softplus"])
def test_bf16_activations_bit_exact_against_jitted_jax(name):
    """``ssm.silu``/``sigmoid``/``softplus`` on 100000 bf16 values (std 3,
    with 0, +-inf and NaN): the same bits as the jitted ``jax.nn``
    function, which XLA computes op by op in f32, each op rounded back to
    bf16."""
    x = np.random.RandomState(7).randn(100000).astype(np.float32) * 3
    x[:4] = [0.0, np.inf, -np.inf, np.nan]
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = to_np(jax.jit(getattr(jax.nn, name))(xj))
    got = to_np(getattr(tssm, name)(torch.from_numpy(x).to(torch.bfloat16)))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Chunked prefill and the T == 1 step against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prefills(mixers):
    """(kind, mode, T, chunk) -> (JAX y, JAX state, port y, port state),
    one jit per JAX forward."""
    out = {}

    def get(kind, mode, T, chunk):
        key = (kind, mode, T, chunk)
        if key not in out:
            jcfg, tcfg, jp, tp = mixers(kind, mode)
            jf, tf = FWD[kind]
            kw = {} if chunk is None else {"chunk": chunk}
            xj, xt = _x(T, jcfg.d_model)
            yj, sj = jax.jit(lambda p, x: jf(p, x, jcfg, **kw))(jp, xj)
            yt, st = tf(tp, xt, tcfg, **kw)
            out[key] = (yj, sj, yt, st)
        return out[key]
    return get


def _cases():
    for kind in ("mamba", "rwkv"):
        for mode in ("dense", "int8"):
            for T, chunk in PREFILLS:
                if kind == "rwkv" and T == 777:
                    continue            # JAX overflows: the test below
                yield kind, mode, T, chunk


@pytest.mark.parametrize("kind,mode,T,chunk", list(_cases()))
def test_chunked_prefill_matches_jitted_jax(prefills, kind, mode, T, chunk):
    yj, sj, yt, st = prefills(kind, mode, T, chunk)
    assert yt.dtype == torch.bfloat16 and tuple(yt.shape) == yj.shape
    dy = float(np.abs(to_np(yj) - to_np(yt)).max())
    print(f"{kind}/{mode} T={T} chunk={chunk}: max|dy| {dy:.4g} "
          f"(max|y| {float(np.abs(to_np(yj)).max()):.3g})")
    assert dy <= Y_BOUND[kind, mode], dy
    assert set(st) == set(sj)
    for k in sj:
        assert str(st[k].dtype).split(".")[-1] == str(sj[k].dtype), k
        assert tuple(st[k].shape) == sj[k].shape, k
        ds = float(np.abs(to_np(sj[k]) - to_np(st[k])).max())
        print(f"  state {k}: max|d| {ds:.3g}")
        bound = 0.0 if sj[k].dtype == jnp.bfloat16 else STATE_BOUND[kind]
        assert ds <= bound, (k, ds)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_decode_step_on_a_carried_state_matches_jax(mixers, prefills, kind,
                                                    mode):
    """One ``T == 1`` step from JAX's state after a 37-token prefill,
    the state carried across: y and the advanced state."""
    jcfg, tcfg, jp, tp = mixers(kind, mode)
    jf, tf = FWD[kind]
    _, sj, _, _ = prefills(kind, mode, 37, None)
    xj, xt = _x(1, jcfg.d_model, seed=1)
    yj, sj2 = jax.jit(lambda p, x, s: jf(p, x, jcfg, state=s))(jp, xj, sj)
    yt, st2 = tf(tp, xt, tcfg, state=_state_to_port(sj))
    dy = float(np.abs(to_np(yj) - to_np(yt)).max())
    ds = [float(np.abs(to_np(sj2[k]) - to_np(st2[k])).max()) for k in sj2]
    print(f"{kind}/{mode} step: max|dy| {dy:.4g}, states {ds}")
    assert dy <= STEP_BOUND, dy
    for k in sj2:
        assert str(st2[k].dtype).split(".")[-1] == str(sj2[k].dtype), k
        ds = float(np.abs(to_np(sj2[k]) - to_np(st2[k])).max())
        bound = 0.0 if sj2[k].dtype == jnp.bfloat16 else STATE_BOUND[kind]
        assert ds <= bound, (k, ds)


def _stepwise(kind, tf, tp, tcfg, xt):
    """One ``T == 1`` call a token from zero state: ``mamba_ref``, or
    RWKV's stepwise loop (JAX's test_ssm.py builds it the same way)."""
    if kind == "mamba":
        return tssm.mamba_ref(tp, xt, tcfg)
    state = tnn.unbox(tssm.rwkv6_state_spec(tcfg, xt.shape[0]))
    outs = []
    for t in range(xt.shape[1]):
        y, state = tf(tp, xt[:, t:t + 1], tcfg, state=state)
        outs.append(y)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_sequential_reference_against_chunked_and_jax(mixers, prefills,
                                                      kind):
    """The port's one-token-a-step reference against its chunked forward
    (T = 20 at chunk 8), as JAX's test_ssm.py holds JAX's; and, for
    Mamba, against JAX's jitted ``mamba_ref``."""
    jcfg, tcfg, jp, tp = mixers(kind)
    _, _, yt, _ = prefills(kind, "dense", 20, 8)
    xj, xt = _x(20, jcfg.d_model)
    seq = _stepwise(kind, FWD[kind][1], tp, tcfg, xt)
    d = float((seq.float() - yt.float()).abs().max())
    print(f"{kind}: sequential vs chunked {d:.4g}")
    assert d <= SEQ_BOUND[kind], d
    if kind == "mamba":
        ref = jax.jit(lambda p, x: jssm.mamba_ref(p, x, jcfg))(jp, xj)
        d = float(np.abs(to_np(ref) - to_np(seq)).max())
        print(f"mamba_ref vs JAX's {d:.4g}")
        assert d <= STEP_BOUND, d


def test_rwkv_chunk_is_finite_where_jax_overflows(mixers):
    """At T = 777, JAX's chunked RWKV is NaN at some positions (the pairs
    s >= t overflow f32 before the mask multiplies them by 0), where the
    stepwise recurrence is finite.  The port is finite everywhere, equal
    to JAX within ``Y_BOUND`` where JAX is finite, and within
    ``OVERFLOW_BOUND`` of the stepwise recurrence where it is not."""
    jcfg, tcfg, jp, tp = mixers("rwkv")
    xj, xt = _x(777, jcfg.d_model, B=1)
    yj, sj = jax.jit(lambda p, x: jssm.rwkv6_forward(p, x, jcfg))(jp, xj)
    yt, st = tssm.rwkv6_forward(tp, xt, tcfg)
    yj, yp = to_np(yj), to_np(yt)
    bad = ~np.isfinite(yj)
    assert bad.any() and np.isfinite(yp).all()
    assert np.abs(yj[~bad] - yp[~bad]).max() <= Y_BOUND["rwkv", "dense"]
    seq = to_np(_stepwise("rwkv", tssm.rwkv6_forward, tp, tcfg, xt))
    assert np.isfinite(seq).all()
    d = np.abs(seq - yp)
    print(f"JAX NaN at {bad.sum()} of {bad.size}; port vs stepwise "
          f"{d[~bad].max():.4g} (JAX finite), {d[bad].max():.4g} (JAX NaN)")
    assert d[~bad].max() <= SEQ_BOUND["rwkv"]
    assert d[bad].max() <= OVERFLOW_BOUND
    # the state takes no intra-chunk pair: finite in JAX too
    assert np.abs(to_np(sj["wkv"]) - to_np(st["wkv"])).max() <= \
        STATE_BOUND["rwkv"]


# ---------------------------------------------------------------------------
# RWKV channel-mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mode", ["dense", "int8"])
def test_rwkv_channel_mix_matches_jax(carried, mode):
    """``rwkv_cm`` on a bf16 (2, 13, d) input, with zero or a carried
    (2, 1, d) bf16 shift: y and the new shift."""
    jcfg = jget_config("rwkv6_7b").reduced()
    jp = jlm.rwkv_cm_init(jax.random.PRNGKey(3), jcfg)
    tp = tnn.params_from_numpy(jp)
    if mode != "dense":
        jp, tp = jcl.compile_params(jp, mode=mode), tcl.compile_params(
            tp, mode=mode)
    jp, tp = jnn.unbox(jp), tnn.unbox(tp)
    xj, xt = _x(13, jcfg.d_model, seed=5)
    sj, stt = (_x(1, jcfg.d_model, seed=6) if carried else (None, None))
    yj, nj = jax.jit(lambda p, x, s: jlm.rwkv_cm(p, x, state=s))(jp, xj, sj)
    yt, nt = tlm.rwkv_cm(tp, xt, state=stt)
    assert yt.dtype == torch.bfloat16 and nt.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(nj), to_np(nt))
    dy = float(np.abs(to_np(yj) - to_np(yt)).max())
    print(f"rwkv_cm {mode} carried={carried}: max|dy| {dy:.4g}")
    assert dy <= Y_BOUND["rwkv", mode], dy


def test_state_specs_match_jax():
    """The cache leaves of a Mamba and an RWKV layer: shapes, dtypes and
    logical axes equal JAX's ``block_cache_init``."""
    for kind in ("mamba", "rwkv"):
        jcfg = jget_config(ARCH[kind]).reduced()
        tcfg = tget_config(ARCH[kind]).reduced()
        sig = dict(kind=kind, moe=False, attn_type=None, index=0)
        jc = jlm.block_cache_init(jcfg, sig, 3, 16)
        tc = tlm.block_cache_init(tcfg, sig, 3, 16)
        jf = jax.tree_util.tree_flatten_with_path(
            jc, is_leaf=lambda x: isinstance(x, jnn.Param))[0]
        tf = {}

        def walk(t, path=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}['{k}']")
            else:
                tf[path] = t
        walk(tc)
        assert {jax.tree_util.keystr(p) for p, _ in jf} == set(tf)
        for p, leaf in jf:
            t = tf[jax.tree_util.keystr(p)]
            assert tuple(t.value.shape) == leaf.value.shape
            assert str(t.value.dtype).split(".")[-1] == str(leaf.value.dtype)
            assert t.axes == leaf.axes
