"""GQA flash attention — CUDA kernel wrapper and plain version (ports
``repro/kernels/flash_attention.py``).

Replaces ``flash_attention_pallas`` (repro/kernels/flash_attention.py:84).
On the main path it is every prefill's attention in the LM
(models/attention.py ``gqa_attention`` -> ``ops.flash_attention``): for
SmolLM-360M q is ``(1, 5, 3, T, 64)`` bf16, causal, with T the prompt's
bucket, one launch per layer.  Decode does not use it (its one query row
goes through the plain ``decode_attention``).

The kernels (``csrc/flash_attention.cu``) compute what the Pallas kernel
computes: f32 scores ``q.k * 1/sqrt(D)``, masks by absolute position
(queries at the end of the keys), an online softmax with f32 ``m``/``l``,
``p`` rounded to v's type before ``p.v``, and ``acc / max(l, 1e-30)`` in
v's type.  A block holds a q tile of all G groups of one batch x kv
head, so each staged K/V tile serves every query group; tiles above the
diagonal or left of the window are skipped; ragged edges are masked,
never padded.  They take f32 and bf16, any Tq <= Tk, G <= 32 and D,
Dv <= 256 (Dv may differ from D).

What bounds it on an H100: at the served shapes, operations (the score
and ``p.v`` flops of the visible pairs at 989 TFLOP/s bf16) over bytes
(q, k, v and o once at 3.35 TB/s).  ``variant`` is the rule that picks
the kernel: ``mma`` (bf16 with D and Dv each 16, 32, 64 or 128, every
served shape) runs both products on the tensor cores (``mma.sync``
m16n8k16, 64-row q tiles, 64-key K/V tiles in a two-stage ``cp.async``
ring); ``fma`` (f32, whose 2e-5 tolerance TF32 would not hold, and the
bf16 shapes outside that rule, such as D = 192 or 256) is the CUDA-core
kernel with f32 FMAs.

For a CPU tensor the wrapper runs ``flash_attention_plain``; for a CUDA
tensor it launches a kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._cuda import F32, I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                    (P,) * 4 + (I,) * 10 + (F32, P))
NEG_INF = -1e30
MAX_G = 32          # the fma kernel's block holds 32 query rows
MAX_D = 256
MMA_D = (16, 32, 64, 128)   # the mma kernel's instances (Q and the output
                            # in registers: D = 256 would not fit)
VARIANTS = {"fma": 0, "mma": 1}


def _scale(D: int) -> float:
    return 1.0 / (D ** 0.5)


def variant(dtype: torch.dtype, D: int, Dv: int) -> str:
    """Which kernel takes a call: ``mma`` (tensor cores) for bf16 with D
    and Dv each 16, 32, 64 or 128, else ``fma`` (CUDA cores)."""
    if dtype == torch.bfloat16 and D in MMA_D and Dv in MMA_D:
        return "mma"
    return "fma"


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
    kind = variant(q.dtype, D, Dv)
    if kind == "mma":                    # the kernel copies 16-byte rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty((B, KVH, G, Tq, Dv), dtype=v.dtype, device=q.device)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), B * KVH, G, Tq, Tk, D,
                  Dv, int(causal), -1 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), VARIANTS[kind], _scale(D))
    return out
