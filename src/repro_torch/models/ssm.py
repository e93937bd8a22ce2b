"""State-space / linear-recurrence blocks: Mamba-1 (Jamba) and RWKV-6
(ports ``repro/models/ssm.py``).

Both run in chunked form, as in the JAX package: a loop over chunks that
carries the recurrent state, and within a chunk Mamba's associative scan
(the same odd/even recursion as ``jax.lax.associative_scan``, so the f32
products round alike) and RWKV's intra-chunk matrices.  A one-token call
(``T == 1``, the decode step) advances the state directly.

The projections go through ``apply_linear``, so the compiled serve modes
run them on the port's int8 kernels; the recurrences are activation-state
math in plain PyTorch, as JAX computes them in ``jnp`` outside any Pallas
kernel.  Rounding points follow the JAX code: the projections and the
causal conv1d in the input's dtype (bf16 in the LM), the scans in f32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear
from repro_torch.models.layers import rmsnorm, rmsnorm_init


# ---------------------------------------------------------------------------
# Activations with XLA's rounding points: on the CPU it computes a bf16
# ``jax.nn`` activation op by op in f32, each op rounded back to bf16
# ---------------------------------------------------------------------------

def _rounder(x):
    return lambda t: t.to(x.dtype).float()


def sigmoid(x):
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), rounded at each op."""
    r = _rounder(x)
    return r(1.0 / r(1.0 + r(torch.exp(r(-x.float()))))).to(x.dtype)


def silu(x):
    """``jax.nn.silu``: x * sigmoid(x), rounded at each op."""
    return (x.float() * sigmoid(x).float()).to(x.dtype)


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): max(x, 0) +
    log1p(exp(-|x|)), rounded at each op; NaN passes."""
    r, xf = _rounder(x), x.float()
    y = r(r(torch.clamp_min(xf, 0.0))
          + r(torch.log1p(r(torch.exp(r(-r(xf.abs())))))))
    return torch.where(torch.isnan(xf), xf, y).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM), Jamba flavour: d_state=16, conv=4, expand=2
# ---------------------------------------------------------------------------

def mamba_init(gen, cfg):
    s = cfg.ssm
    d, di, N, R = cfg.d_model, s.d_inner, s.d_state, s.dt_rank
    dev = gen.device if gen is not None else torch.device("cpu")
    # S4D-real initialization for A; dt bias for softplus in [1e-3, 0.1]
    A = np.tile(np.arange(1, N + 1, dtype=np.float32), (di, 1))
    dt = np.exp(np.random.RandomState(0).uniform(
        np.log(1e-3), np.log(0.1), size=di)).astype(np.float32)
    dt_bias = dt + np.log(-np.expm1(-dt))  # inverse softplus
    return {
        "in_proj": nn.linear_param(gen, d, 2 * di, ("embed", "mamba_inner")),
        "conv_w": nn.param(gen, (s.d_conv, di), (None, "mamba_inner"),
                           scale=1.0 / np.sqrt(s.d_conv)),
        "conv_b": nn.param(gen, (di,), ("mamba_inner",), init="zeros"),
        "x_proj": nn.linear_param(gen, di, R + 2 * N, ("mamba_inner", None)),
        "dt_proj": nn.linear_param(gen, R, di, (None, "mamba_inner")),
        "dt_bias": nn.Param(torch.from_numpy(dt_bias).to(dev),
                            ("mamba_inner",)),
        "A_log": nn.Param(torch.from_numpy(np.log(A)).to(dev),
                          ("mamba_inner", None)),
        "D": nn.param(gen, (di,), ("mamba_inner",), init="ones"),
        "out_proj": nn.linear_param(gen, di, d, ("mamba_inner", "embed")),
    }


def associative_scan(fn, elems, axis: int):
    """``jax.lax.associative_scan(fn, elems, axis)`` for a tuple of
    tensors, by the same recursion (jax 0.9.0): combine adjacent pairs,
    scan the half-length sequence, fill the even positions from it, and
    interleave.  ``fn(earlier, later)`` takes and returns tuples."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.ndim
        idx[axis] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                 tuple(sl(e, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn(tuple(sl(e, 0, -1) for e in odd),
                  tuple(sl(e, 2, None, 2) for e in elems))
    else:
        even = fn(odd, tuple(sl(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis)
                 for e, r in zip(elems, even))
    return tuple(_interleave(a, b, axis) for a, b in zip(even, odd))


def _interleave(a, b, axis):
    """a[0], b[0], a[1], b[1], ... along ``axis`` (len(a) is len(b) or
    one more)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, None, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, None, 2)
    out[tuple(idx)] = b
    return out


def _linear_comb(x, y):
    """h_t = a_t h_{t-1} + b_t composed: (a1, b1) then (a2, b2)."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _mamba_scan_chunked(a, b, h0, chunk):
    """h_t = a_t * h_{t-1} + b_t over time.  a, b: (B, T, di, N), T a
    multiple of ``chunk``.  Returns (hs (B, T, di, N), h_last)."""
    T = a.shape[1]
    h, hs = h0, []
    for c in range(T // chunk):
        ac = a[:, c * chunk:(c + 1) * chunk]
        bc = b[:, c * chunk:(c + 1) * chunk].clone()
        # fold carried state into the first step
        bc[:, 0] = bc[:, 0] + ac[:, 0] * h
        _, hc = associative_scan(_linear_comb, (ac, bc), axis=1)
        h = hc[:, -1]
        hs.append(hc)
    return torch.cat(hs, dim=1), h


def mamba_forward(p, x, cfg, state=None, qat=False, chunk=128):
    """x: (B, T, d).  state: dict(conv (B, d_conv-1, di), ssm (B, di, N))
    for decode; None for a fresh sequence.  Returns (y, new_state)."""
    s = cfg.ssm
    B, T, _ = x.shape
    N, R = s.d_state, s.dt_rank
    xz = apply_linear(p["in_proj"], x, qat)
    xi, z = torch.chunk(xz, 2, dim=-1)                # (B, T, di)

    # depthwise causal conv1d (k = d_conv)
    if state is not None:
        conv_in = torch.cat([state["conv"].to(xi.dtype), xi], dim=1)
    else:
        conv_in = F.pad(xi, (0, 0, s.d_conv - 1, 0))
    new_conv = conv_in[:, -(s.d_conv - 1):]
    # the taps' products summed in f32 in tap order and rounded to x's
    # dtype (XLA's bf16 einsum), then the bias and silu
    w = p["conv_w"].to(xi.dtype).float()
    acc = conv_in[:, 0:T].float() * w[0]
    for i in range(1, s.d_conv):
        acc = acc + conv_in[:, i:i + T].float() * w[i]
    xi = silu(acc.to(xi.dtype) + p["conv_b"].to(xi.dtype))

    proj = apply_linear(p["x_proj"], xi, qat)
    dt_r, Bc, Cc = torch.split(proj, [R, N, N], dim=-1)
    dt = softplus(apply_linear(p["dt_proj"], dt_r, qat)
                  + p["dt_bias"].to(xi.dtype))
    A = -torch.exp(p["A_log"].float())                           # (di, N)
    dtf = dt.float()
    a = torch.exp(dtf[..., None] * A)                            # (B,T,di,N)
    b = (dtf * xi.float())[..., None] * Bc.float()[:, :, None, :]

    h0 = (state["ssm"].float() if state is not None
          else torch.zeros((B, s.d_inner, N), device=x.device))
    if T == 1:
        h = a[:, 0] * h0 + b[:, 0]
        hs, h_last = h[:, None], h
    else:
        pad = (-T) % chunk
        if pad:
            a = F.pad(a, (0, 0, 0, 0, 0, pad), value=1.0)
            b = F.pad(b, (0, 0, 0, 0, 0, pad))
        hs, h_last = _mamba_scan_chunked(a, b, h0, min(chunk, T + pad))
        hs = hs[:, :T]
        if pad:  # true last state is at original T
            h_last = hs[:, -1]
    y = torch.einsum("btdn,btn->btd", hs, Cc.float())
    y = y + xi.float() * p["D"].float()
    y = (y * silu(z.float())).to(x.dtype)
    out = apply_linear(p["out_proj"], y, qat)
    new_state = {"conv": new_conv.to(torch.bfloat16),
                 "ssm": h_last.float()}
    return out, new_state


def mamba_ref(p, x, cfg):
    """Exact sequential reference (tests): one ``T == 1`` step a token."""
    B, T, _ = x.shape
    state = nn.unbox(mamba_state_spec(cfg, B, device=x.device))
    ys = []
    for t in range(T):
        y, state = mamba_forward(p, x[:, t:t + 1], cfg, state=state)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)


def mamba_state_spec(cfg, B, device="cpu"):
    s = cfg.ssm
    return {
        "conv": nn.Param(torch.zeros((B, s.d_conv - 1, s.d_inner),
                                     dtype=torch.bfloat16, device=device),
                         ("batch", None, "mamba_inner_s")),
        "ssm": nn.Param(torch.zeros((B, s.d_inner, s.d_state),
                                    device=device),
                        ("batch", "mamba_inner_s", None)),
    }


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch"): data-dependent decay, per-head 64x64 state
# ---------------------------------------------------------------------------

def rwkv6_init(gen, cfg):
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    H = d // hd
    lora = cfg.ssm.decay_lora
    return {
        # token-shift mix coefficients (static part; data-dependent lora)
        "mu": nn.param(gen, (5, d), (None, "embed"), scale=0.5),
        "mix_lora_a": nn.linear_param(gen, d, 5 * 32, ("embed", None)),
        "mix_lora_b": nn.param(gen, (5, 32, d), (None, None, "embed"),
                               scale=0.05),
        "r": nn.linear_param(gen, d, d, ("embed", "heads_q")),
        "k": nn.linear_param(gen, d, d, ("embed", "heads_q")),
        "v": nn.linear_param(gen, d, d, ("embed", "heads_q")),
        "g": nn.linear_param(gen, d, d, ("embed", "heads_q")),
        "w_lora_a": nn.linear_param(gen, d, lora, ("embed", None)),
        "w_lora_b": nn.linear_param(gen, lora, d, (None, "heads_q")),
        "w_bias": nn.param(gen, (d,), ("embed",), init="zeros"),
        "u": nn.param(gen, (H, hd), ("heads_s", None), scale=0.5),
        "ln_x": rmsnorm_init(gen, d),
        "o": nn.linear_param(gen, d, d, ("heads_q", "embed")),
    }


def _rwkv_chunk(r, k, v, w, u, S0, chunk):
    """Chunked WKV.  r, k, v: (B, H, T, D); w: (B, H, T, D) decay in
    (0, 1); u: (H, D) bonus; T a multiple of ``chunk``.  Returns y
    (B, H, T, D), S_last (B, H, D, D)."""
    T = r.shape[2]
    mask = (torch.arange(chunk)[:, None] > torch.arange(chunk)[None, :]
            ).to(r.device)
    S, ys = S0, []
    for c in range(T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = r[:, :, sl], k[:, :, sl], v[:, :, sl], w[:, :, sl]
        logw = torch.log(torch.clamp_min(wc, 1e-38))
        cw = torch.cumsum(logw, dim=2)                # inclusive
        # inter-chunk: state contribution (decay up to t-1 -> exclusive)
        dec_q = torch.exp(cw - logw)                  # prod_{r<t} w_r
        y_inter = torch.einsum("bhtd,bhde->bhte", rc * dec_q, S)
        # intra-chunk pairs s < t through a mid-chunk reference (f32
        # stability); the clip only guards vanishing tails
        m_ref = cw[:, :, chunk // 2][:, :, None, :]   # (B,H,1,D)
        r_t = rc * torch.exp(torch.clamp(cw - logw - m_ref, -60.0, 60.0))
        k_s = kc * torch.exp(torch.clamp(m_ref - cw, -60.0, 60.0))
        # the pairs s >= t are selected away, where JAX multiplies by the
        # mask: their factors can reach e^120 and overflow f32, and JAX's
        # inf * 0 is NaN there (ROADMAP queue C); the pairs s < t are the
        # same products
        a = torch.where(mask, torch.einsum("bhtd,bhsd->bhts", r_t, k_s),
                        0.0)
        a_diag = torch.einsum("bhtd,bhtd,hd->bht", rc, kc, u)  # s == t
        y_intra = (torch.einsum("bhts,bhsd->bhtd", a, vc)
                   + a_diag[..., None] * vc)
        # S' = diag(prod w) S + sum_s (prod_{r>s} w o k_s) v_s
        dec_tail = torch.exp(cw[:, :, -1:, :] - cw)   # prod_{r>s} w_r
        S = (S * torch.exp(cw[:, :, -1])[..., None]
             + torch.einsum("bhsd,bhse->bhde", kc * dec_tail, vc))
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=2), S


def rwkv6_forward(p, x, cfg, state=None, qat=False, chunk=64):
    """x: (B, T, d).  state: dict(shift (B, 1, d), wkv (B, H, D, D))."""
    hd = cfg.ssm.head_dim
    B, T, d = x.shape
    H = d // hd
    xf = x.float()
    if state is not None:
        prev = torch.cat([state["shift"].float(), xf[:, :-1]], dim=1)
    else:
        prev = F.pad(xf, (0, 0, 1, 0))[:, :-1]
    new_shift = xf[:, -1:]
    # data-dependent token-shift mix (ddlerp)
    mu = p["mu"].float()
    base = xf + (prev - xf) * 0.5
    lora = torch.tanh(apply_linear(p["mix_lora_a"], base.to(x.dtype), qat))
    lora = lora.reshape(B, T, 5, 32).float()
    dyn = torch.einsum("btfk,fkd->btfd", lora, p["mix_lora_b"].float())
    mixed = xf[:, :, None] + (prev - xf)[:, :, None] * \
        (mu[None, None] + dyn)                        # (B,T,5,d)
    xr, xk, xv, xw, xg = [mixed[:, :, i].to(x.dtype) for i in range(5)]

    def heads(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    r = heads(apply_linear(p["r"], xr, qat))
    k = heads(apply_linear(p["k"], xk, qat))
    v = heads(apply_linear(p["v"], xv, qat))
    g = silu(apply_linear(p["g"], xg, qat))
    w_raw = (apply_linear(p["w_lora_b"],
                          torch.tanh(apply_linear(p["w_lora_a"], xw, qat)),
                          qat)
             + p["w_bias"].to(x.dtype))
    w = heads(torch.exp(-torch.exp(w_raw.float())))   # decay in (0,1)
    rf, kf, vf = r.float(), k.float(), v.float()
    u = p["u"].float()

    S0 = (state["wkv"].float() if state is not None
          else torch.zeros((B, H, hd, hd), device=x.device))
    if T == 1:
        rt, kt, vt, wt = rf[:, :, 0], kf[:, :, 0], vf[:, :, 0], w[:, :, 0]
        y = (torch.einsum("bhd,bhde->bhe", rt, S0)
             + torch.einsum("bhd,bhd,hd,bhe->bhe", rt, kt, u, vt))
        S_last = S0 * wt[..., None] + kt[..., None] * vt[:, :, None]
        y = y[:, :, None]
    else:
        pad = (-T) % chunk
        if pad:  # decay-1, k = 0 steps: the state passes them exactly
            rf, kf, vf = (F.pad(t, (0, 0, 0, pad)) for t in (rf, kf, vf))
            w = F.pad(w, (0, 0, 0, pad), value=1.0)
        y, S_last = _rwkv_chunk(rf, kf, vf, w, u, S0,
                                min(chunk, rf.shape[2]))
        y = y[:, :, :T]
    y = y.transpose(1, 2).reshape(B, T, d).to(x.dtype)
    y = rmsnorm(p["ln_x"], y) * g
    out = apply_linear(p["o"], y, qat)
    new_state = {"shift": new_shift.to(torch.bfloat16),
                 "wkv": S_last.float()}
    return out, new_state


def rwkv6_state_spec(cfg, B, device="cpu"):
    hd = cfg.ssm.head_dim
    H = cfg.d_model // hd
    return {
        "shift": nn.Param(torch.zeros((B, 1, cfg.d_model),
                                      dtype=torch.bfloat16, device=device),
                          ("batch", None, "embed_s")),
        "wkv": nn.Param(torch.zeros((B, H, hd, hd), device=device),
                        ("batch", "heads_s", None, None)),
    }
