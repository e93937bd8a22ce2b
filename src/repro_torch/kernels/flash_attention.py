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

The backward (``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd``)
replaces no Pallas kernel: it is the gradient the JAX package takes by
XLA's autodiff of its chunked attention (repro/models/attention.py:57)
under ``jax.value_and_grad`` (repro/training/train_step.py:30).  The
forward hands it each row's f32 log-sum-exp (the forward kernels write
it when asked: one float per row, nothing else changes, and the serve
paths do not ask), so the backward rebuilds ``p = exp(s * scale - lse)``
without a second pass for the softmax statistics.  It computes dq, dk
and dv in the inputs' type from f32 sums, dk and dv summed over the G
query heads of a KV head, with the forward's masks; two kernels, one
writing dq (and the row sums ``delta = dout . o``), one dk and dv, each
output written by one block, so no float atomics and the same bits on
every run.  On the training path each attention layer runs the forward
twice per step (once more under the layer remat) and the backward once.
``FlashAttention`` is the autograd ``Function`` that joins the two;
``ops.flash_attention`` takes it when q, k or v needs a gradient.

For a CPU tensor the wrappers run ``flash_attention_plain`` and
``flash_attention_bwd_plain``; for a CUDA tensor they launch a kernel or
raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._cuda import F32, I, P, CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("flash_attention", "flash_attention_launch",
                    (P,) * 5 + (I,) * 10 + (F32, P))
BWD_KERNEL = CudaKernel("flash_attention_bwd", "flash_attention_bwd_launch",
                        (P,) * 10 + (I,) * 9 + (F32, P))
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
                          causal: bool = True, window=None,
                          return_lse: bool = False):
    """The kernel's function in plain PyTorch, on any device: f32 scores,
    one softmax over all keys, ``p`` rounded to v's type before ``p.v``
    summed in f32, the output in v's type.  ``return_lse`` also returns
    each row's f32 log-sum-exp ``m + log(max(l, 1e-30))``, (B, KVH, G,
    Tq), as the forward kernels write it for the backward.

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
    out = (o / torch.clamp_min(l, 1e-30)).to(v.dtype)
    if return_lse:
        return out, (m + torch.log(torch.clamp_min(l, 1e-30)))[..., 0]
    return out


def flash_attention_bwd_plain(q, k, v, o, dout, lse, causal: bool = True,
                              window=None):
    """The backward kernels' function in plain PyTorch, in f32 from the
    saved tensors: ``p = exp(s * scale - lse)`` on the visible pairs,
    ``dv = p^T dout``, ``ds = p * (dout v^T - rowsum(dout * o))``,
    ``dq = scale * ds k``, ``dk = scale * ds^T q``, dk and dv summed over
    the G query heads.  Returns (dq, dk, dv) in the inputs' types."""
    Tq, D = q.shape[-2:]
    Tk = k.shape[2]
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * _scale(D)
    mask = position_mask(Tq, Tk, causal, window, q.device)
    p = torch.exp(s - lse.float()[..., None]).masked_fill(~mask, 0.0)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, df)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", df, vf)
    delta = torch.sum(df * o.float(), dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * _scale(D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * _scale(D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, name="flash_attention"):
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: f32 or bf16, got {q.dtype}")
    if not (1 <= Tq <= Tk and G <= MAX_G and D <= MAX_D and Dv <= MAX_D):
        raise ValueError(f"{name}: needs Tq <= Tk, G <= {MAX_G}, "
                         f"D, Dv <= {MAX_D}; got Tq={Tq} Tk={Tk} G={G} "
                         f"D={D} Dv={Dv}")
    check_cuda("q", q, q.dtype)
    check_cuda("k", k, q.dtype, (B, KVH, Tk, D))
    check_cuda("v", v, q.dtype, (B, KVH, Tk, Dv))


def _forward(q, k, v, causal, window, with_lse: bool):
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    _check(q, k, v)
    kind = variant(q.dtype, D, Dv)
    if kind == "mma":                    # the kernel copies 16-byte rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty((B, KVH, G, Tq, Dv), dtype=v.dtype, device=q.device)
    lse = (torch.empty((B, KVH, G, Tq), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), B * KVH, G,
                  Tq, Tk, D, Dv, int(causal),
                  -1 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), VARIANTS[kind], _scale(D))
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """GQA attention, queries at the end of the keys.

    q (B, KVH, G, Tq, D); k (B, KVH, Tk, D); v (B, KVH, Tk, Dv); f32 or
    bf16, all one type.  Returns (B, KVH, G, Tq, Dv) in v's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    return _forward(q, k, v, causal, window, with_lse=False)[0]


def flash_attention_fwd(q, k, v, causal: bool = True, window=None):
    """``flash_attention`` that also returns each row's f32 log-sum-exp
    (B, KVH, G, Tq), for the backward: ``(out, lse)``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window,
                                     return_lse=True)
    return _forward(q, k, v, causal, window, with_lse=True)


def flash_attention_bwd(q, k, v, o, dout, lse, causal: bool = True,
                        window=None):
    """dq, dk, dv of ``flash_attention`` at ``dout``, from the forward's
    inputs, output and log-sum-exp; in the inputs' types."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, dout, lse, causal,
                                         window)
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    _check(q, k, v, "flash_attention_bwd")
    check_cuda("o", o, q.dtype, (B, KVH, G, Tq, Dv))
    check_cuda("dout", dout, q.dtype, (B, KVH, G, Tq, Dv))
    check_cuda("lse", lse, torch.float32, (B, KVH, G, Tq))
    delta = torch.empty_like(lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    BWD_KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), ptr(dout), ptr(lse),
                      ptr(delta), ptr(dq), ptr(dk), ptr(dv), B * KVH, G, Tq,
                      Tk, D, Dv, int(causal),
                      -1 if window is None else int(window),
                      int(q.dtype == torch.bfloat16), _scale(D))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward keeps q, k, v,
    the output and the log-sum-exp; the backward is one
    ``flash_attention_bwd`` call.  On CPU tensors both are the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, ctx.causal, ctx.window)
        return dq, dk, dv, None, None
