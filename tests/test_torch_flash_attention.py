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
