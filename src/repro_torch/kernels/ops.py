"""The conv, matmul and attention ops (ports the ``conv2d``,
``conv2d_dw``, ``cfmm_matmul``, ``sparse_cfmm_matmul``,
``block_sparse_matmul`` and ``flash_attention`` parts of
``repro/kernels/ops.py``).

Each op prepares its kernel's arguments and calls the kernel's wrapper,
which dispatches by the tensor's device alone: the plain PyTorch version
for a CPU tensor, the CUDA kernel for a CUDA tensor.

Numerics follow the JAX package's jitted lowering, which is what its
serving path and ``reference_logits`` run: XLA rewrites ``amax / 127.0``
as ``amax * f32(1/127)`` inside a jit, while ``y / s_y`` stays a true
division; the Collector's ``acc * scale + bias`` is one fused
multiply-add (kernels/ref.py ``fma_f32``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import block_sparse
from repro_torch.kernels.cfmm_matmul import cfmm_matmul as _cfmm_kernel
from repro_torch.kernels.conv_depthwise import conv2d_dw as _dw_kernel
from repro_torch.kernels.conv_implicit import conv2d_implicit
from repro_torch.kernels.conv_sparse import conv2d_sparse
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_kernel
from repro_torch.kernels.sparse_matvec import sparse_matvec

_flash_grad = FlashAttention.apply

INV_127 = 1.0 / 127.0      # rounds to XLA's folded f32(1/127) constant


def requant_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127`` as the jitted JAX lowering computes it."""
    inv = torch.tensor(INV_127, dtype=torch.float32, device=amax.device)
    return torch.clamp_min(amax, 1e-12) * inv


def cfmm_matmul(x_q: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32, exact (or f32 with the
    per-column scale applied once)."""
    return _cfmm_kernel(x_q.contiguous(), codes.contiguous(), scale)


def sparse_cfmm_matmul(x_q: torch.Tensor, bitmap: torch.Tensor,
                       values: torch.Tensor,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
    """Bitmap-packed sparse matmul; int32 out (or f32 with scale)."""
    if bitmap.shape[0] * 8 != x_q.shape[1]:
        # K padded to a multiple of 8 at compile time (masked tail rows);
        # zero int8 activations are exact, so pad x to match
        pad = bitmap.shape[0] * 8 - x_q.shape[1]
        assert 0 < pad < 8, (bitmap.shape, x_q.shape)
        x_q = F.pad(x_q, (0, pad))
    acc = sparse_matvec(x_q.contiguous(), bitmap, values)
    return acc if scale is None else acc.float() * scale


def block_sparse_matmul(x: torch.Tensor, w,
                        block_kn: tuple = (128, 128)) -> torch.Tensor:
    """x (M, K) @ w (K, N), skipping all-zero constant (bk, bn) blocks.

    ``w`` is a constant (a tensor on any device, or an array): the block
    mask and the active blocks come from its host copy, and zero blocks
    are never launched (the paper's dropped MACs).  The weights are cast
    to x's type before the product (in bf16 they round first); the sum
    is f32 and rounds once to x's type.  Output columns whose block column
    has no active block are exact zeros; a wholly empty mask returns zeros
    without a launch.  Ragged M is masked in the kernel, not padded.
    x is f32 or bf16: for int8 x the JAX op returns int8, wrapped under
    one lowering and saturated under the other (ROADMAP queue C), so the
    port refuses integer x."""
    if not x.is_floating_point():
        raise NotImplementedError(
            f"block_sparse_matmul takes f32 or bf16 x, got {x.dtype}")
    bk, bn = block_kn
    K, N = w.shape
    if K % bk or N % bn:
        raise AssertionError(((K, N), block_kn))     # the JAX op's assert
    if x.ndim != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w {(K, N)}")
    p = block_sparse.pack_blocks(w, (bk, bn), x.dtype, x.device)
    if p.n_active == 0:
        return torch.zeros((x.shape[0], N), dtype=x.dtype, device=x.device)
    return block_sparse.block_sparse_matmul(x.contiguous(), p.w_blocks,
                                            p.meta, p.offsets, p.block_kn,
                                            p.n_blocks_n)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """GQA-native flash attention.

    q: (B, KVH, G, Tq, D); k: (B, KVH, Tk, D); v: (B, KVH, Tk, Dv).  The
    JAX op pads to whole Pallas tiles (``_largest_tile``); the CUDA kernel
    masks its ragged edges itself, so no tile search or pad is needed.
    When autograd needs a gradient of q, k or v it goes through the
    ``FlashAttention`` function (forward with the log-sum-exp, the
    backward kernel); otherwise it is the forward alone, as served."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _flash_grad(q, k, v, causal, window)
    return _flash_kernel(q, k, v, causal, window)


def conv2d(x_q: torch.Tensor, codes, k: int, stride: int, *, x_scale,
           w_scale: torch.Tensor, gamma: torch.Tensor | None = None,
           beta: torch.Tensor | None = None,
           shortcut: torch.Tensor | None = None, relu: bool = True,
           quant_out: bool = False, zero_count: int | None = None):
    """Fused implicit-GEMM int8 SAME conv + Collector.

    x_q:     (N, H, W, c_in) int8 activations; x_scale their scale — a
             scalar (per-tensor domain) or an ``(N,)`` per-row vector
             (one domain per image).  With a per-row x_scale, quant_out
             emits a per-row y_scale.
    codes:   (k*k*c_in, c_out) int8 weight codes in the compiled
             spatial-major tap order (``compile_params`` stores every conv
             leaf so), OR a packed ``(bitmap, values)`` pair in the same
             layout (sparse_cfmm).
    w_scale: per-output-channel dequant scale, broadcastable to (c_out,)
    gamma/beta: folded-BN scale and bias
    shortcut:   optional f32 (N, h_out, w_out, c_out) residual, or an
                int8 ``(codes, scale)`` pair (scalar or per-row scale):
                the dequantized identity shortcut, fused into the
                epilogue as ``fma(codes, scale, y)``
    quant_out:  round the output back to int8 -> (y_q int8, y_scale);
                otherwise returns f32 (N, h_out, w_out, c_out).
    zero_count: opt-in activation-sparsity profiling — the coarse_in
                group size to count zeros at.  Appends
                ``ref.zero_counts_ref``'s dict to the return: ``(y, zc)``
                or ``(y_q, y_scale, zc)``.  On the card the conv kernels
                count in their epilogue where the group size divides their
                64-channel tile and c_out, else the counts are recounted
                on ``y`` (kernels/conv_implicit.py); ``y`` and ``y_q`` are
                the same with it or without.
    """
    C = x_q.shape[3]
    packed = isinstance(codes, (tuple, list))
    if packed:
        bitmap, values = codes
        n_out = bitmap.shape[1]
        assert bitmap.shape[0] * 8 == -(-C * k * k // 8) * 8, (
            bitmap.shape, C, k)
    else:
        n_out = codes.shape[1]
        assert codes.shape[0] == C * k * k, (codes.shape, C, k)
    eff_rows, eff_bias, sc, per_row = _collector_args(
        x_q, x_scale, w_scale, gamma, beta, shortcut, n_out)
    x_q = x_q.contiguous()
    kw = dict(k=k, stride=stride, relu=relu, profile_g=zero_count)
    if packed:
        out = conv2d_sparse(x_q, bitmap, values, eff_rows, eff_bias, sc,
                            **kw)
    else:
        out = conv2d_implicit(x_q, codes.contiguous(), eff_rows, eff_bias,
                              sc, **kw)
    return _tail(out, per_row, quant_out, zero_count)


def conv2d_dw(x_q: torch.Tensor, values: torch.Tensor, k: int, stride: int,
              *, x_scale, w_scale: torch.Tensor,
              gamma: torch.Tensor | None = None,
              beta: torch.Tensor | None = None, shortcut=None,
              relu: bool = True, quant_out: bool = False,
              zero_count: int | None = None):
    """Fused depthwise int8 SAME conv + Collector: the depthwise sibling
    of ``conv2d``, with the same arguments, Collector and requant tail.
    ``values`` is the compiled tap-major ``(k*k, C)`` int8 weight.

    zero_count: opt-in activation-sparsity profiling — the coarse_in group
    size to count zeros at.  Appends ``ref.zero_counts_ref``'s dict to the
    return: ``(y, zc)`` or ``(y_q, y_scale, zc)``.  On the card the kernel
    counts in its epilogue where its plan's channel slice is a multiple of
    the group size, else the counts are recounted on ``y``
    (kernels/conv_depthwise.py); ``y`` and ``y_q`` are the same with it
    or without."""
    C = x_q.shape[3]
    assert tuple(values.shape) == (k * k, C), (tuple(values.shape), k, C)
    eff_rows, eff_bias, sc, per_row = _collector_args(
        x_q, x_scale, w_scale, gamma, beta, shortcut, C)
    out = _dw_kernel(x_q.contiguous(), values.contiguous(), eff_rows,
                     eff_bias, sc, k=k, stride=stride, relu=relu,
                     profile_g=zero_count)
    return _tail(out, per_row, quant_out, zero_count)


def _collector_args(x_q, x_scale, w_scale, gamma, beta, shortcut,
                    n_out: int):
    """The Collector operands of a conv launch: one dequant * BN row per
    image ``(N, n_out)`` (per-row domains index it by image, a per-tensor
    scalar repeats the same row), the bias, the shortcut (an f32 map, or
    an int8 ``(codes, scale[row])`` pair), and whether x_scale is
    per-row."""
    N, dev = x_q.shape[0], x_q.device
    x_s = torch.as_tensor(x_scale, dtype=torch.float32, device=dev)
    col_scale = w_scale.reshape(-1).float()
    if gamma is not None:
        col_scale = col_scale * gamma.float()
    eff_rows = (x_s.reshape(-1, 1) * col_scale.reshape(1, -1)).expand(
        N, n_out).contiguous()
    eff_bias = (torch.zeros((n_out,), dtype=torch.float32, device=dev)
                if beta is None else beta.float().contiguous())
    if isinstance(shortcut, (tuple, list)):   # int8 (codes, scale) pair
        q_sc, s_sc = shortcut
        s_sc = torch.as_tensor(s_sc, dtype=torch.float32, device=dev)
        sc = (q_sc.contiguous(), s_sc.reshape(-1).expand(N).contiguous())
    else:
        sc = None if shortcut is None else shortcut.float().contiguous()
    return eff_rows, eff_bias, sc, x_s.ndim >= 1


def _tail(out: tuple, per_row: bool, quant_out: bool, zero_count):
    """A conv op's return from its kernel's ``(y, amax[, zc])``: ``y`` or
    the requantized ``(y_q, s_y)``, then the zero-count dict with
    ``zero_count``."""
    y = out[0]
    res = _requant(y, out[1], per_row) if quant_out else y
    if zero_count is None:
        return res
    return (*res, out[2]) if quant_out else (y, out[2])


def _requant(y: torch.Tensor, amax_rows: torch.Tensor, per_row: bool):
    """The requant tail: activations go straight back to int8; under
    per-row domains s_y is (N,) — one independent scale per image."""
    s_y = requant_scale(amax_rows if per_row else torch.amax(amax_rows))
    s_b = s_y.reshape(-1, 1, 1, 1) if per_row else s_y
    y_q = torch.clamp(torch.round(y / s_b), -127, 127).to(torch.int8)
    return y_q, s_y
