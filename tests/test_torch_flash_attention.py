"""Port parity of the flash-attention plain version
(``repro_torch.kernels.flash_attention.flash_attention_plain``, which the
wrapper runs for CPU tensors and the CUDA kernel is held against on the
card) with the JAX package: its jitted jnp ``models.attention
.flash_attention`` (the lowering ``ops.flash_attention`` takes off the
TPU) and its naive oracle ``kernels.ref.flash_attention_ref``.

The sweep is ``tests/test_kernels.py``'s (causal / window / G / Dv at
B = 1, KVH = 2, Tq = 128, Tk = 256, D = 32), plus a Tq that is no tile
multiple, a single query row, and the LM's own head shape.  Inputs are
made with numpy from a seed.  Tolerances, from what these cases measure:

* f32: 1e-5 absolute against both — the same math summed in another
  order (measured: at most 1.2e-6).
* bf16: 2e-2 absolute plus 2**-6 relative (two output ulps) against
  both (measured with jax 0.9.0: 7.4e-3 against the oracle, 1.6e-2 —
  one ulp of an output in [2, 4) — against the jnp lowering).  The two
  JAX functions round in other places than the Pallas kernel the port
  follows: the jnp lowering rounds the scores and the unnormalised
  ``p.v`` to bf16 (where XLA's fusion keeps them so, which may change
  between XLA versions), the oracle never rounds ``p``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = {"float32": (1e-5, 0.0), "bfloat16": (2e-2, 2.0 ** -6)}  # atol, rtol
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Beside XLA's CPU thread pool, torch's own pool oversubscribes the
    cores and slows these small ops by an order of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, KVH, G, Tq, Tk, D, Dv, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, KVH, G, Tq, D).astype(np.float32),
            rng.randn(B, KVH, Tk, D).astype(np.float32),
            rng.randn(B, KVH, Tk, Dv).astype(np.float32))


def _jax_ref(q, k, v, causal, window):
    """``kernels.ref.flash_attention_ref`` per (kv head, group), in f32."""
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    qf = jnp.asarray(q, jnp.float32).reshape(B, KVH * G, Tq, D)
    kf = jnp.repeat(jnp.asarray(k, jnp.float32), G, axis=1)
    vf = jnp.repeat(jnp.asarray(v, jnp.float32), G, axis=1)
    out = jref.flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return np.asarray(out).reshape(B, KVH, G, Tq, Dv)


_jnp_flash = jax.jit(jattn.flash_attention, static_argnames=("causal",
                                                              "window"))


def _check(shape, causal, window, dtype, seed, against_jnp=True):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _inputs(*shape, seed)
    # both sides see the same values in the working type
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv, causal, window)
    assert got.dtype == tdt and tuple(got.shape) == shape[:4] + (shape[-1],)
    got = got.float().numpy()
    rounded = [t.float().numpy() for t in (tq, tk, tv)]
    want = _jax_ref(*rounded, causal, window)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if against_jnp:
        jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in rounded)
        want_jnp = np.asarray(_jnp_flash(jq, jk, jv, causal=causal,
                                         window=window).astype(jnp.float32))
        np.testing.assert_allclose(got, want_jnp, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,G,Dv", [
    (True, None, 1, 32), (True, None, 4, 32), (False, None, 2, 32),
    (True, 64, 2, 32), (True, None, 2, 16)])
def test_plain_matches_jax_over_kernel_sweep(causal, window, G, Dv, dtype):
    _check((1, 2, G, 128, 256, 32, Dv), causal, window, dtype,
           seed=G * 7 + Dv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal,window", [
    ((2, 1, 3, 37, 100, 16, 16), True, None),    # Tq no tile multiple
    ((1, 2, 2, 1, 77, 16, 8), True, 5),          # one query row, window
    ((1, 5, 3, 64, 64, 64, 64), True, None),     # SmolLM's head shape
    ((1, 1, 4, 40, 40, 48, 32), False, 16),      # Dv != D, no causal
])
def test_plain_matches_jax_ragged_shapes(shape, causal, window, dtype):
    _check(shape, causal, window, dtype, seed=sum(shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_non_causal_long_keys_matches_oracle(dtype):
    """Non-causal, Tk = 1500: held against ``flash_attention_ref`` only.
    The JAX jnp lowering pads K/V with zero keys to a multiple of its
    1024-key chunk and only the causal mask hides them, so non-causal it
    counts the pad keys (a fact about the reference, ROADMAP queue C);
    the port masks every key at or past Tk."""
    _check((1, 1, 2, 8, 1500, 16, 16), False, None, dtype, seed=3,
           against_jnp=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (2, 2, 1, 48, 24, 32, 32),     # a decoder longer than its clip
    (1, 2, 3, 77, 40, 16, 8),      # ragged, G = 3, Dv != D
])
def test_plain_non_causal_queries_past_keys_match_jax(shape, dtype):
    """Non-causal with no window, every query sees every key, so Tq > Tk
    is a shape like any other (the encoder-decoder's cross-attention over
    a clip with fewer frames than the decoder has tokens): the plain
    version against both JAX functions, as the kernels take it on the
    card (tests/test_torch_kernels_cuda.py)."""
    _check(shape, False, None, dtype, seed=sum(shape))


_jnp_flash_chunked = jax.jit(jattn.flash_attention,
                             static_argnames=("causal", "kv_chunk"))


def test_jnp_lowering_counts_its_zero_key_pad_past_one_chunk():
    """Records a fact about the reference at Whisper's lengths: at T_enc
    = 1100 frames (reduced widths: 4 heads of 32), non-causal, the port's
    plain version equals JAX's jnp flash read in one 1100-key chunk, and
    differs from JAX's default 1024-key chunks, which pad 948 zero keys
    that no mask hides and every softmax then counts.  So the CPU parity
    tests keep T_enc <= 1024, where JAX's chunk is the whole key axis,
    and the card holds Whisper's 1500 frames against the port's own plain
    forward."""
    q, k, v = _inputs(1, 4, 1, 1100, 1100, 32, 32, seed=1100)
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=False).numpy()
    one_chunk = np.asarray(_jnp_flash_chunked(
        *map(jnp.asarray, (q, k, v)), causal=False, kv_chunk=1100))
    default = np.asarray(_jnp_flash_chunked(
        *map(jnp.asarray, (q, k, v)), causal=False, kv_chunk=1024))
    atol, rtol = TOL["float32"]
    np.testing.assert_allclose(got, one_chunk, rtol=rtol, atol=atol)
    # the 948 pad keys add exp(0 - m) each to every row's denominator
    assert float(np.abs(got - default).max()) > 100 * atol
    assert float(np.abs(default).mean()) < float(np.abs(got).mean())


def test_ref_matches_jax_ref():
    rng = np.random.RandomState(5)
    q = rng.randn(1, 3, 24, 16).astype(np.float32)
    k = rng.randn(1, 3, 40, 16).astype(np.float32)
    v = rng.randn(1, 3, 40, 8).astype(np.float32)
    for causal, window in [(True, None), (False, None), (True, 7)]:
        got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal, window=window)
        want = jref.flash_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_gqa_attention_layout_matches_jax():
    """The model-level wrapper's layout (q (B, T, H, D), k/v (B, T, KVH,
    D)) and the 4-D (B, H, T, D) form of ``flash_attention``."""
    rng = np.random.RandomState(9)
    q = rng.randn(2, 12, 6, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    got = tattn.gqa_attention(*map(torch.from_numpy, (q, k, v)))
    want = jax.jit(jattn.gqa_attention)(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    q4 = rng.randn(1, 2, 10, 16).astype(np.float32)
    k4 = rng.randn(1, 2, 10, 16).astype(np.float32)
    got4 = tattn.flash_attention(*map(torch.from_numpy, (q4, k4, k4)))
    want4 = jattn.flash_attention(*map(jnp.asarray, (q4, k4, k4)))
    assert tuple(got4.shape) == (1, 2, 10, 16)
    np.testing.assert_allclose(got4.numpy(), np.asarray(want4), rtol=0,
                               atol=1e-5)


# The tensor-core backward (csrc/flash_attention_bwd.cu, ``mma``) feeds p
# and ds (f32 in the function) to the dv, dq and dk products as bf16
# operands: each as two, hi = bf16(x) and lo = bf16(x - hi), with f32
# sums.  Its card tolerance is FLASH_BWD_TOL's bf16 bound (chip_smoke.py,
# tests/test_torch_kernels_cuda.py): 1e-2 absolute plus 2**-7 relative.
MMA_BWD_TOL = (1e-2, 2.0 ** -7)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _split(t):
    """What two bf16 operands carry of ``t``: hi + lo."""
    hi = _bf(t)
    return hi + _bf(t - hi)


def _mma_bwd_replay(q, k, v, o, dout, lse, causal, window, operand=_split):
    """``flash_attention_bwd_plain`` with the ``mma`` backward's rounding
    points: ``operand`` (the split, or one bf16 rounding) applied to p and
    to ds (from the f32 p) before the dv, dq and dk products."""
    Tq, D = q.shape[-2:]
    Tk = k.shape[2]
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) / D ** 0.5
    mask = tfa.position_mask(Tq, Tk, causal, window, "cpu")
    p = torch.exp(s - lse[..., None]).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", operand(p), df)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", df, vf)
    ds = operand(p * (dp - torch.sum(df * o.float(), dim=-1, keepdim=True)))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) / D ** 0.5
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) / D ** 0.5
    return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))


def _bwd_case(B, KVH, G, Tq, Tk, D, Dv, causal, window, operand):
    """Per output (dq, dk, dv), the replay's largest error over its
    bound, against the plain version on the same bf16 inputs."""
    rng = np.random.RandomState(B + G + Tq + D)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   .to(torch.bfloat16) for shape in (
                       (B, KVH, G, Tq, D), (B, KVH, Tk, D),
                       (B, KVH, Tk, Dv), (B, KVH, G, Tq, Dv)))
    o, lse = tfa.flash_attention_plain(q, k, v, causal, window, True)
    want = tfa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal, window)
    got = _mma_bwd_replay(q, k, v, o, do, lse, causal, window, operand)
    atol, rtol = MMA_BWD_TOL
    return [float(((a.float() - b.float()).abs()
                   / (atol + rtol * b.float().abs())).max())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("B,KVH,G,Tq,Tk,D,Dv,causal,window", [
    (1, 2, 3, 256, 256, 64, 64, True, None),      # SmolLM's head shape
    (1, 2, 1, 100, 100, 80, 80, True, None),      # StableLM-3B
    (1, 1, 4, 96, 96, 128, 128, True, None),      # Phi-3-medium
    (1, 2, 1, 50, 130, 192, 128, True, None),     # MLA, Tq < Tk
    (1, 1, 4, 256, 256, 256, 256, True, 128),     # Gemma3: G = 4, window
    (2, 1, 4, 33, 33, 256, 256, True, 5),         # a window in a tile
    (1, 2, 2, 40, 70, 64, 64, False, None),       # non-causal
    (1, 1, 32, 33, 50, 128, 128, True, 3),        # G = 32, few keys a row
    (1, 1, 32, 40, 40, 256, 256, True, 2),
])
def test_mma_bwd_rounding_within_the_card_tolerance(B, KVH, G, Tq, Tk, D,
                                                    Dv, causal, window):
    """The ``mma`` backward's rounding points, replayed in plain PyTorch
    on bf16 inputs, stay within the card's bf16 tolerance of
    ``flash_attention_bwd_plain`` (at most 0.7 of it: the rest is the
    outputs' own bf16 rounding): the bound the kernel is held to on the
    card can hold."""
    worst = _bwd_case(B, KVH, G, Tq, Tk, D, Dv, causal, window, _split)
    assert max(worst) <= 0.7, worst


def test_one_bf16_rounding_of_p_and_ds_would_miss_the_bound():
    """Why the split: p and ds rounded once to bf16 (2**-9 relative a
    term) miss the bound where a key is seen by few rows with large p --
    a window of 2 over G = 32 groups -- in all three outputs."""
    worst = _bwd_case(1, 1, 32, 40, 40, 256, 256, True, 2, _bf)
    assert min(worst) > 1.0, worst
