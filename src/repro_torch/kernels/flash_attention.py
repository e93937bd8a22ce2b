"""GQA flash attention — CUDA kernel wrapper and plain version (ports
``repro/kernels/flash_attention.py``).

Replaces ``flash_attention_pallas`` (repro/kernels/flash_attention.py:84).
On the main path it is every prefill's attention in the LM
(models/attention.py ``gqa_attention`` -> ``ops.flash_attention``): for
SmolLM-360M q is ``(1, 5, 3, T, 64)`` bf16, causal, with T the prompt's
bucket, one launch per layer.  Decode does not use it (its one query row
goes through the plain ``decode_attention``).

The kernel (``csrc/flash_attention.cu``) computes what the Pallas kernel
computes: f32 scores ``q.k * 1/sqrt(D)``, masks by absolute position
(queries at the end of the keys), an online softmax with f32 ``m``/``l``,
``p`` rounded to v's type before ``p.v``, and ``acc / max(l, 1e-30)`` in
v's type.  One block per (q tile of all G groups, batch x kv head), so
each staged K/V tile serves every query group; tiles above the diagonal
or left of the window are skipped; ragged edges are masked, never
padded.  It takes f32 and bf16, any Tq <= Tk, G <= 32 and D, Dv <= 256
(Dv may differ from D).

What bounds it on an H100: at the served shapes, operations (the score
and ``p.v`` flops of the visible tiles at 989 TFLOP/s bf16) over bytes
(q, k, v and o once at 3.35 TB/s).  This first kernel does f32 FMAs on
the CUDA cores, so it sits well above that bound (PERF.md).

For a CPU tensor the wrapper runs ``flash_attention_plain``; for a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._cuda import F32, I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                    (P,) * 4 + (I,) * 9 + (F32, P))
NEG_INF = -1e30
MAX_G = 32          # a block holds 32 query rows: bq = 32 // G positions
MAX_D = 256


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


def position_mask(Tq: int, Tk: int, causal: bool, window, device):
    """(Tq, Tk) bool: which keys each query sees, by absolute position
    (query i sits at key position Tk - Tq + i)."""
    qpos = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: f32 scores,
    one softmax over all keys, ``p`` rounded to v's type before ``p.v``
    summed in f32, the output in v's type.

    q (B, KVH, G, Tq, D); k (B, KVH, Tk, D); v (B, KVH, Tk, Dv)."""
    Tq, D = q.shape[-2:]
    Tk = k.shape[2]
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * _scale(D)
    mask = position_mask(Tq, Tk, causal, window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return (o / torch.clamp_min(l, 1e-30)).to(v.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """GQA attention, queries at the end of the keys.

    q (B, KVH, G, Tq, D); k (B, KVH, Tk, D); v (B, KVH, Tk, Dv); f32 or
    bf16, all one type.  Returns (B, KVH, G, Tq, Dv) in v's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: f32 or bf16, got {q.dtype}")
    if not (1 <= Tq <= Tk and G <= MAX_G and D <= MAX_D and Dv <= MAX_D):
        raise ValueError(f"flash_attention: needs Tq <= Tk, G <= {MAX_G}, "
                         f"D, Dv <= {MAX_D}; got Tq={Tq} Tk={Tk} G={G} "
                         f"D={D} Dv={Dv}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    check_cuda("q", q, q.dtype)
    check_cuda("k", k, q.dtype, (B, KVH, Tk, D))
    check_cuda("v", v, q.dtype, (B, KVH, Tk, Dv))
    out = torch.empty((B, KVH, G, Tq, Dv), dtype=v.dtype, device=q.device)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B * KVH, G, Tq, Tk, D,
                  Dv, int(causal), -1 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), _scale(D))
    return out
