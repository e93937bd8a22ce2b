"""Shared LM layers: norms, rotary positions, the FFN, the embedding and
the LM head (ports ``repro/models/layers.py``).

Every matmul weight is an ``nn.linear_param``, so the paper's
constant-parameter compilation (core/compiled_linear.py) applies to all
of them.  Rounding points follow the JAX code: norms compute in f32 and
cast back to the input's type; RoPE's ``cos``/``sin`` are computed in f32
and cast to ``x.dtype`` before the rotation.  M-RoPE (Qwen2-VL) rotates
each section of the frequency axis by its own position stream.  The
encoder-decoder adds ``sinusoidal_positions`` instead.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(gen, d):
    return {"scale": nn.param(gen, (d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)


def layernorm_init(gen, d):
    return {"scale": nn.param(gen, (d,), ("embed",), init="ones"),
            "bias": nn.param(gen, (d,), ("embed",), init="zeros")}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               mrope_sections: tuple | None = None) -> torch.Tensor:
    """x: (B, T, H, D); positions: (B, T) int, or (3, B, T) for M-RoPE.

    M-RoPE (Qwen2-VL): the frequency axis is split into
    ``mrope_sections``, each rotated by its own position stream
    (temporal / height / width).  Each section's angles are the same f32
    products as standard RoPE's, so three equal streams give the standard
    rotation bit for bit.  Sections that do not cover D/2 raise, as the
    JAX package asserts."""
    D = x.shape[-1]
    freqs = torch.tensor(rope_freqs(D, theta), dtype=torch.float32,
                         device=x.device)                        # (D/2,)
    if positions.ndim == 3:                                      # M-RoPE
        if mrope_sections is None:
            raise ValueError("3-D positions need mrope_sections")
        sec = np.cumsum((0,) + tuple(mrope_sections))
        if sec[-1] != D // 2:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do "
                             f"not sum to head_dim / 2 = {D // 2}")
        angles = torch.cat(
            [positions[i].float()[..., None] * freqs[sec[i]:sec[i + 1]]
             for i in range(len(mrope_sections))], dim=-1)       # (B,T,D/2)
    else:
        angles = positions.float()[..., None] * freqs            # (B,T,D/2)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal_positions(T: int, d: int) -> np.ndarray:
    """The encoder-decoder's absolute positions: (T, d) f32, sin on the
    even columns and cos on the odd ones (the JAX package's numpy table,
    cast to the activations' type where it is added)."""
    pos = np.arange(T)[:, None]
    dim = np.arange(0, d, 2)[None, :] / d
    ang = pos / (10000.0 ** dim)
    out = np.zeros((T, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


# ---------------------------------------------------------------------------
# FFN (SwiGLU / GeGLU / plain)
# ---------------------------------------------------------------------------

_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
         "relu": F.relu}


def ffn_init(gen, d, d_ff, gated=True, suffix=("ffn_in", "ffn_out")):
    p = {"down": nn.linear_param(gen, d_ff, d, (suffix[1], "embed"))}
    if gated:
        p["gate"] = nn.linear_param(gen, d, d_ff, ("embed", suffix[0]))
    p["up"] = nn.linear_param(gen, d, d_ff, ("embed", suffix[0]))
    return p


def ffn(p, x, act="silu", qat=False):
    actf = _ACTS[act]
    up = apply_linear(p["up"], x, qat)
    if "gate" in p:
        h = actf(apply_linear(p["gate"], x, qat)) * up
    else:
        h = actf(up)
    return apply_linear(p["down"], h, qat)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(gen, vocab, d):
    return {"table": nn.param(gen, (vocab, d), ("vocab", "embed"),
                              scale=0.02)}


def embed(p, tokens):
    return p["table"][tokens]


def lm_head_init(gen, d, vocab):
    return {"w": nn.linear_param(gen, d, vocab, ("embed", "vocab"))}


def lm_head(params, x, tied_embed=None, qat=False):
    """Logits in ``x.dtype``.  The tied head is ``x @ table.T`` with the
    table cast to ``x.dtype``, as in the JAX package; the product of the
    two rounded operands is summed in f32 (a torch matmul, not a kernel
    of the port) and rounded once to ``x.dtype``.  ``qat`` reaches the
    untied head only, as in the JAX package."""
    if tied_embed is not None:
        w = tied_embed.to(x.dtype).float()
        return (x.float() @ w.t()).to(x.dtype)
    return apply_linear(params["w"], x, qat)
