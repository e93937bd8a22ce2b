"""Attention: GQA full/sliding-window attention with the flash kernel on
prefill, and decode against preallocated KV caches (ports the GQA part
of ``repro/models/attention.py``).

Prefill attention goes through ``ops.flash_attention``: the CUDA
flash-attention kernel for CUDA tensors (the port of the Pallas kernel
the JAX module names as its TPU schedule), its plain version for CPU
tensors.  Decode's single query row attends in plain PyTorch
(``decode_attention``), as in the JAX package, which has no kernel for
it.  QK^T and AV are activation x activation products, so the paper's
constant-parameter technique does not apply to them; every projection
routes through ``apply_linear``.

Caches are dicts of ``k``/``v`` ``(B, S_max, KVH, D)`` on the device and
a ``length`` counter kept on the host (it only decides where to write
and which keys are valid, so reading it needs no device sync).
``gqa_forward`` writes the prompt (prefill) or the new token (decode)
into ``k``/``v`` IN PLACE and returns the same tensors with the new
``length`` — JAX returns updated copies.

MLA (DeepSeek-V2's latent attention) caches the normalised latent
``c_kv (B, S_max, kv_lora)`` and the shared rotary key ``k_rope
(B, S_max, qk_rope)``, written in place the same way.  Its prefill
expands them into per-head keys and values and runs the flash kernel at
D = qk_nope + qk_rope, Dv = v_dim; its decode step never expands the
cache: ``k_up`` is pulled through the query and ``v_up`` through the
context (the absorbed path, in f32, plain PyTorch as in the JAX
package).

The int8 KV cache (``gqa_cache_spec(dtype=torch.int8)``) stores ``k``/``v``
as per-(token, head) symmetric int8 codes with bf16 scales ``k_s``/``v_s``
``(B, S_max, KVH)`` (``_kv_quant``).  A prefill writes the prompt's codes
and attends its own unquantized k and v; a decode step appends its codes
and dequantizes the cache in f32 (``decode_attention(scales=...)``), as
the JAX package does.  MLA's latent cache stays bf16 under int8, as in
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear, dense_of
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_init

NEG_INF = -1e30
_A8 = "is not ported (ROADMAP A8)"


# ---------------------------------------------------------------------------
# Flash attention (prefill)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, causal=True, window=None,
                    q_chunk=1024, kv_chunk=1024):
    """Streaming-softmax attention, GQA-native.

    q: (B, H, T, D) or (B, KVH, G, T, D); k: (B, KVH, Tk, D);
    v: (B, KVH, Tk, Dv).  K/V are never expanded across query groups.
    ``q_chunk``/``kv_chunk`` are the JAX lowering's chunk sizes; the
    kernel picks its own tiles, so they are accepted and unused."""
    del q_chunk, kv_chunk
    squeeze_g = q.ndim == 4
    if squeeze_g:
        q = q[:, :, None]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out[:, :, 0] if squeeze_g else out


def gqa_attention(q, k, v, causal=True, window=None):
    """q: (B, Tq, H, D); k: (B, Tk, KVH, D); v: (B, Tk, KVH, Dv)."""
    B, Tq, H, D = q.shape
    KVH = k.shape[2]
    Dv = v.shape[-1]
    G = H // KVH
    qg = q.reshape(B, Tq, KVH, G, D).permute(0, 2, 3, 1, 4)  # B,KVH,G,T,D
    o = flash_attention(qg, k.transpose(1, 2), v.transpose(1, 2), causal,
                        window)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dv)


# ---------------------------------------------------------------------------
# GQA block (init / forward / decode)
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg):
    d, H, KVH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "q": nn.linear_param(gen, d, H * D, ("embed", "heads_q")),
        "k": nn.linear_param(gen, d, KVH * D, ("embed", "heads_kv")),
        "v": nn.linear_param(gen, d, KVH * D, ("embed", "heads_kv")),
        "o": nn.linear_param(gen, H * D, d, ("heads_q", "embed")),
    }
    if cfg.qk_norm:
        p["qn"] = rmsnorm_init(gen, D)
        p["kn"] = rmsnorm_init(gen, D)
    return p


def gqa_forward(p, x, cfg, positions, window=None, causal=True,
                cache=None, cross_kv=None, qat=False):
    """Returns (out, new_cache).  cache: dict(k, v: (B, S_max, KVH, D),
    length: host int32 scalar; with int8 k/v also k_s, v_s: (B, S_max,
    KVH) bf16) — None for a cacheless forward; T == 1 with a cache is a
    decode step (append), T > 1 a prefill (write the whole prompt from
    position 0).  ``positions``: (B, T), or (3, B, T) under M-RoPE."""
    if cross_kv is not None:
        raise NotImplementedError(f"encoder-decoder cross attention {_A8}")
    B, T, d = x.shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_linear(p["q"], x, qat).reshape(B, T, H, D)
    k = apply_linear(p["k"], x, qat).reshape(B, T, KVH, D)
    v = apply_linear(p["v"], x, qat).reshape(B, T, KVH, D)
    if "qn" in p:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    if cfg.pos in ("rope", "mrope"):
        sections = cfg.mrope_sections if cfg.pos == "mrope" else None
        q = apply_rope(q, positions, cfg.rope_theta, sections)
        k = apply_rope(k, positions, cfg.rope_theta, sections)

    new_cache = None
    if cache is not None:
        rows = {"k": k, "v": v}
        if cache["k"].dtype == torch.int8:  # codes and bf16 scales
            (rows["k"], rows["k_s"]), (rows["v"], rows["v_s"]) = \
                _kv_quant(k), _kv_quant(v)
        # decode appends at the shared length counter; a prefill writes
        # the whole prompt from position 0
        decode = T == 1
        start = int(cache["length"]) if decode else 0
        for key, val in rows.items():
            cache[key][:, start:start + T] = val
        new_cache = {**cache, "length": cache["length"] + 1 if decode
                     else torch.tensor(T, dtype=torch.int32)}
        if decode:
            scales = (cache["k_s"], cache["v_s"]) if "k_s" in cache else None
            out = decode_attention(q, cache["k"], cache["v"], start + 1,
                                   window, scales)
            return (apply_linear(p["o"], out.reshape(B, 1, H * D), qat),
                    new_cache)
    o = gqa_attention(q, k, v, causal=causal, window=window)
    return apply_linear(p["o"], o.reshape(B, T, H * D), qat), new_cache


# f32(1 / 127): XLA rewrites the quantizer's ``/ 127.0`` as a multiply by
# it under jit (the JAX oracle), so the port multiplies on every device
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _kv_quant(x):
    """Per-(token, head) symmetric int8: x (B, T, KVH, D) -> codes, scales.

    The codes are rounded (half to even, as ``jnp.round``) against the f32
    scale; the scale is stored in bf16, and dequantization reads that
    rounded scale, as in the JAX package.  ``x / scale`` is a true division
    (tensor by tensor, on the card too)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp_min(amax, 1e-6) * _INV_127         # (B, T, KVH)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def decode_attention(q, ck, cv, length, window=None, scales=None):
    """Single-token attention against the cache, in f32.  q: (B, 1, H, D);
    ck/cv: (B, S_max, KVH, D); keys at positions < ``length`` (a host
    int) are valid.  ``scales``: (k_s, v_s) (B, S_max, KVH) bf16 when the
    cache holds int8 codes, dequantized in f32 as ``code * scale``."""
    B, S, KVH, D = ck.shape
    H = q.shape[2]
    G = H // KVH
    qh = q.reshape(B, KVH, G, D)
    if scales is not None:
        ck = ck.float() * scales[0].float()[..., None]
        cv = cv.float() * scales[1].float()[..., None]
    # jnp.sqrt(D), an f32 value, as a device tensor: a true division on
    # the card too (CUDA divides by a Python scalar via its reciprocal)
    sqrt_d = torch.tensor(float(np.sqrt(np.float32(D))), device=q.device)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), ck.float()) / sqrt_d
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    valid = pos < length
    if window is not None:
        valid &= pos >= length - window
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, cv.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def gqa_cache_spec(cfg, B, S_max, dtype=torch.bfloat16, device="cpu"):
    KVH, D = cfg.n_kv_heads, cfg.head_dim
    axes = ("batch", "kv_seq", "heads_kv_sharded", None)
    spec = {
        "k": nn.Param(torch.zeros((B, S_max, KVH, D), dtype=dtype,
                                  device=device), axes),
        "v": nn.Param(torch.zeros((B, S_max, KVH, D), dtype=dtype,
                                  device=device), axes),
        "length": nn.Param(torch.zeros((), dtype=torch.int32), ()),
    }
    if dtype == torch.int8:  # per-(token, head) dequant scales
        for s in ("k_s", "v_s"):
            spec[s] = nn.Param(torch.zeros((B, S_max, KVH),
                                           dtype=torch.bfloat16,
                                           device=device),
                               ("batch", "kv_seq", "heads_kv_sharded"))
    return spec


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2), absorbed decode path
# ---------------------------------------------------------------------------

def mla_init(gen, cfg):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "q": nn.linear_param(gen, d, H * (m.qk_nope + m.qk_rope),
                             ("embed", "heads_q")),
        "kv_down": nn.linear_param(gen, d, m.kv_lora + m.qk_rope,
                                   ("embed", "kv_lora")),
        "kv_norm": rmsnorm_init(gen, m.kv_lora),
        "k_up": nn.linear_param(gen, m.kv_lora, H * m.qk_nope,
                                ("kv_lora", "heads_q")),
        "v_up": nn.linear_param(gen, m.kv_lora, H * m.v_dim,
                                ("kv_lora", "heads_q")),
        "o": nn.linear_param(gen, H * m.v_dim, d, ("heads_q", "embed")),
    }


def mla_forward(p, x, cfg, positions, cache=None, qat=False):
    """Returns (out, new_cache).  cache: dict(c_kv (B, S_max, kv_lora),
    k_rope (B, S_max, qk_rope), length: host int32 scalar) or None.  With
    a cache, T == 1 is a decode step (the absorbed path), T > 1 a prefill
    (written from position 0, then the expanded path, as without a
    cache)."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    q = apply_linear(p["q"], x, qat).reshape(B, T, H, m.qk_nope + m.qk_rope)
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    down = apply_linear(p["kv_down"], x, qat)
    # rmsnorm's own eps (1e-6), not cfg.norm_eps, as the JAX package
    c_kv = rmsnorm(p["kv_norm"], down[..., :m.kv_lora])        # (B,T,lora)
    k_rope = apply_rope(down[..., None, m.kv_lora:], positions,
                        cfg.rope_theta)[:, :, 0]               # (B,T,rope)

    new_cache = None
    if cache is not None:
        cc, cr = cache["c_kv"], cache["k_rope"]
        if T == 1:  # decode: append at the shared length counter
            idx = int(cache["length"])
            cc[:, idx:idx + 1] = c_kv.to(cc.dtype)
            cr[:, idx:idx + 1] = k_rope.to(cr.dtype)
            new_cache = {"c_kv": cc, "k_rope": cr,
                         "length": cache["length"] + 1}
            o = mla_absorbed_attention(p, q_nope, q_rope, cc, cr, idx + 1,
                                       cfg)
            out = o.reshape(B, 1, H * m.v_dim).to(x.dtype)
            return apply_linear(p["o"], out, qat), new_cache
        cc[:, :T] = c_kv.to(cc.dtype)   # prefill: write the whole prompt
        cr[:, :T] = k_rope.to(cr.dtype)
        new_cache = {"c_kv": cc, "k_rope": cr,
                     "length": torch.tensor(T, dtype=torch.int32)}
    # expanded path (prefill, or no cache): per-head keys and values; the
    # shared rotary key is copied to every head (the kernel reads a real
    # tensor, never a stride-0 view)
    k_nope = apply_linear(p["k_up"], c_kv, qat).reshape(B, T, H, m.qk_nope)
    v = apply_linear(p["v_up"], c_kv, qat).reshape(B, T, H, m.v_dim)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, T, H, m.qk_rope)],
                  dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    o = gqa_attention(qf, k, v, causal=True)
    return (apply_linear(p["o"], o.reshape(B, T, H * m.v_dim), qat),
            new_cache)


def mla_absorbed_attention(p, q_nope, q_rope, cc, cr, length, cfg):
    """One query row against the latent cache, in f32, without expanding
    it: the scores are ``(q_nope . k_up) . c_kv + q_rope . k_rope`` over
    sqrt(qk_nope + qk_rope), the output ``(softmax . c_kv) . v_up``.
    q_nope (B, 1, H, qk_nope), q_rope (B, 1, H, qk_rope); cc/cr the
    caches; keys at positions < ``length`` (a host int) are valid.
    Returns (B, 1, H, v_dim) f32."""
    m = cfg.mla
    H = cfg.n_heads
    k_up = dense_of(p["k_up"]).reshape(m.kv_lora, H, m.qk_nope)
    qa = torch.einsum("bthn,lhn->bthl", q_nope.float(), k_up)  # (B,1,H,lora)
    s = (torch.einsum("bthl,bsl->bhts", qa, cc.float())
         + torch.einsum("bthr,bsr->bhts", q_rope.float(), cr.float()))
    # jnp.sqrt(192), an f32 value, as a device tensor (see decode_attention)
    sqrt_d = torch.tensor(float(np.sqrt(np.float32(m.qk_nope + m.qk_rope))),
                          device=s.device)
    s = s / sqrt_d
    valid = torch.arange(cc.shape[1], device=s.device) < length
    w = torch.softmax(s.masked_fill(~valid, NEG_INF), dim=-1)
    ctx = torch.einsum("bhts,bsl->bthl", w, cc.float())
    v_up = dense_of(p["v_up"]).reshape(m.kv_lora, H, m.v_dim)
    return torch.einsum("bthl,lhv->bthv", ctx, v_up)


def mla_cache_spec(cfg, B, S_max, dtype=torch.bfloat16, device="cpu"):
    """The latent cache.  An int8 request keeps bf16, as the JAX package
    does: the latent is already the compressed form."""
    if dtype == torch.int8:
        dtype = torch.bfloat16
    m = cfg.mla
    axes = ("batch", "kv_seq", None)
    return {
        "c_kv": nn.Param(torch.zeros((B, S_max, m.kv_lora), dtype=dtype,
                                     device=device), axes),
        "k_rope": nn.Param(torch.zeros((B, S_max, m.qk_rope), dtype=dtype,
                                       device=device), axes),
        "length": nn.Param(torch.zeros((), dtype=torch.int32), ()),
    }
