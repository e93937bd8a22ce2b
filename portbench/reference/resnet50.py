"""Plain reference of the served ResNet50: the constant-parameter compile
and the compiled forward, in plain PyTorch, from the float weights the
benchmark made.

It imports nothing of the program.  Its arithmetic is the paper's
Compiled NN as the program documents it (W-INT7 per output channel,
A-INT8 with one scale per image on every unit edge, int32 products, the
Collector's ``acc * scale + bias`` rounded once to f32), written out
again here so that the yardstick does not move when the program does:

* weights: per-column top-``keep_k`` pruning (``sparse_cfmm``) with ties
  broken by a double stable argsort, then symmetric INT7 codes
  ``clip(round(w / (amax / 63)), -63, 63)``;
* activations: ``q = clip(round(x / s), -127, 127)`` with
  ``s = max(amax_row, 1e-12) * f32(1/127)``;
* convolutions: every integer product summed in float64 (exact for these
  shapes), SAME padding, then the Collector;
* the head: the global average pool as a running fused multiply-add over
  the pixels in order, times ``f32(1 / (H * W))``, then the per-row
  quantized linear.

``act_qmax`` and ``w_qmax`` set the integer ranges; the benchmark's
control passes 7 and 7 (int4) to compute the same network one precision
below the configuration's.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# (name, blocks, mid channels, feature hw) per stage: He et al.,
# arXiv:1512.03385, Table 1 (ResNet-50); out = expansion * mid
STAGES = (("conv2_x", 3, 64, 56), ("conv3_x", 4, 128, 28),
          ("conv4_x", 6, 256, 14), ("conv5_x", 3, 512, 7))

ACT_QMAX = 127
W_QMAX = 63


@dataclasses.dataclass(frozen=True)
class Conv:
    """One convolution: its weight is ``(c_in * k * k, c_out)`` with the
    patch rows channel-major (c_in slowest, then kh, kw)."""

    name: str
    c_in: int
    c_out: int
    k: int
    stride: int
    relu: bool = True


@dataclasses.dataclass(frozen=True)
class Block:
    """A bottleneck block: ``a`` (1x1, carries the stride), ``b`` (3x3),
    ``c`` (1x1, adds the shortcut), and a projection ``sc`` or None for
    the identity."""

    name: str
    a: Conv
    b: Conv
    c: Conv
    sc: Conv | None


def architecture(width_mult: float = 1.0, expansion: int = 4):
    """(stem conv, [blocks]) of ResNet50 at ``width_mult``: channel
    counts ``max(8, int(c * width_mult))``."""
    w0 = max(8, int(64 * width_mult))
    stem = Conv("stem", 3, w0, 7, 2)
    blocks, in_ch = [], w0
    for si, (name, n_blocks, mid, _) in enumerate(STAGES):
        mid_c = max(8, int(mid * width_mult))
        out_c = max(8, int(mid * expansion * width_mult))
        for b in range(n_blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            u = f"{name}.{b}"
            blocks.append(Block(
                u,
                Conv(f"{u}.a", in_ch, mid_c, 1, stride),
                Conv(f"{u}.b", mid_c, mid_c, 3, 1),
                Conv(f"{u}.c", mid_c, out_c, 1, 1),
                Conv(f"{u}.sc", in_ch, out_c, 1, stride, relu=False)
                if b == 0 else None))
            in_ch = out_c
    return stem, blocks


def convs(width_mult: float = 1.0, expansion: int = 4) -> list:
    """Every conv in dataflow order."""
    stem, blocks = architecture(width_mult, expansion)
    out = [stem]
    for blk in blocks:
        out += [c for c in (blk.sc, blk.a, blk.b, blk.c) if c is not None]
    return out


def keep_rows(k_rows: int, sparsity: float) -> int:
    """Weights kept per output column under ``sparse_cfmm``: the share
    ``1 - sparsity`` of the column, rounded, at least 8, up to a
    multiple of 8, at most the column."""
    keep = max(8, int(round(k_rows * (1.0 - sparsity))))
    return min(k_rows, ((keep + 7) // 8) * 8)


# ---------------------------------------------------------------------------
# Compile
# ---------------------------------------------------------------------------

def quantize_columns(w: torch.Tensor, qmax: int):
    """Symmetric per-column codes of ``w`` (K, N) and their (1, N) scale."""
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / torch.full_like(amax, qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax)
    return q, scale


def prune_columns(w: torch.Tensor, keep: int) -> torch.Tensor:
    """Zero all but the ``keep`` largest |w| of each column."""
    ranks = torch.argsort(torch.argsort(-torch.abs(w), dim=0, stable=True),
                          dim=0, stable=True)
    return torch.where(ranks < keep, w, torch.zeros_like(w))


def compile_weight(w: torch.Tensor, mode: str, sparsity: float | None,
                   w_qmax: int = W_QMAX) -> dict:
    """A float weight (K, N) -> {"codes": float64 integer codes (K, N),
    "scale": f32 (1, N)}.  ``sparsity`` is read under ``sparse_cfmm``
    alone."""
    w = w.float()
    if mode == "sparse_cfmm":
        if sparsity is None:
            raise ValueError("sparse_cfmm needs a sparsity")
        w = prune_columns(w, keep_rows(w.shape[0], sparsity))
    elif mode != "int8":
        raise ValueError(f"the reference serves int8 and sparse_cfmm, "
                         f"not {mode!r}")
    q, scale = quantize_columns(w, w_qmax)
    return {"codes": q.double(), "scale": scale.float()}


def compile_network(weights: dict, mode: str, sparsity: float | None,
                    w_qmax: int = W_QMAX) -> dict:
    """``weights``: {conv name: {"w", "scale", "bias"}, "head": {"w"}}."""
    out = {}
    for name, leaf in weights.items():
        c = dict(leaf)
        c["w"] = compile_weight(leaf["w"], mode, sparsity, w_qmax)
        out[name] = c
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 operands rounded once to f32: the f64 sum of
    the exact f64 product, with a double-rounding tie resolved by the
    sign of the f64 addition's error (TwoSum)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    tie = (d != 0) & ((r.double() + nb.double()) * 0.5 == s)
    fix = tie & (e != 0) & ((e > 0) == (d > 0))
    return torch.where(fix, nb, r)


def quant_rows(x: torch.Tensor, qmax: int = ACT_QMAX):
    """Per-row activation codes (as f32 integers) and the (N,) scale."""
    amax = torch.amax(torch.abs(x.float()), dim=tuple(range(1, x.ndim)))
    inv = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    s = torch.clamp_min(amax, 1e-12) * inv
    q = torch.clamp(torch.round(x.float() / s.reshape((-1,) + (1,) *
                                                      (x.ndim - 1))),
                    -qmax, qmax)
    return q, s


def same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2, out


def pad_same(x: torch.Tensor, k: int, stride: int, value=0.0):
    _, H, W, _ = x.shape
    lo_h, hi_h, h_out = same_pads(H, k, stride)
    lo_w, hi_w, w_out = same_pads(W, k, stride)
    if lo_h or hi_h or lo_w or hi_w:
        x = F.pad(x, (0, 0, lo_w, hi_w, lo_h, hi_h), value=value)
    return x, h_out, w_out


def int_conv(q: torch.Tensor, codes: torch.Tensor, k: int,
             stride: int) -> torch.Tensor:
    """Integer SAME conv of NHWC codes ``q`` with channel-major weight
    codes ``(C * k * k, n)``, summed exactly in float64."""
    N, _, _, C = q.shape
    n = codes.shape[1]
    w = codes.reshape(C, k, k, n)
    xp, h_out, w_out = pad_same(q, k, stride)
    xp = xp.double()
    acc = torch.zeros((N * h_out * w_out, n), dtype=torch.float64,
                      device=q.device)
    for dy in range(k):
        for dx in range(k):
            sl = xp[:, dy:dy + (h_out - 1) * stride + 1:stride,
                    dx:dx + (w_out - 1) * stride + 1:stride, :]
            acc += sl.reshape(-1, C) @ w[:, dy, dx, :]
    return acc.reshape(N, h_out, w_out, n)


def conv(leaf: dict, spec: Conv, q: torch.Tensor, s: torch.Tensor,
         shortcut=None) -> torch.Tensor:
    """Conv + Collector: ``fma(acc, s_row * (w_scale * gamma), beta)``,
    then the shortcut (an f32 map added, or an identity ``(q, s)`` pair
    fused as ``fma(q, s_row, y)``), then ReLU."""
    acc = int_conv(q, leaf["w"]["codes"], spec.k, spec.stride)
    col = leaf["w"]["scale"].reshape(-1) * leaf["scale"].float()
    eff = (s.reshape(-1, 1) * col.reshape(1, -1))[:, None, None, :]
    y = fma_f32(acc.float(), eff, leaf["bias"].float())
    if isinstance(shortcut, tuple):
        sq, ss = shortcut
        y = fma_f32(sq, ss.reshape(-1, 1, 1, 1), y)
    elif shortcut is not None:
        y = y + shortcut
    return torch.clamp_min(y, 0.0) if spec.relu else y


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    xp, _, _ = pad_same(x, k, stride, value=float("-inf"))
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def head_pool(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    N, H, W, C = q.shape
    qf = q.reshape(N, H * W, C)
    sr = s.reshape(-1, 1).expand(N, C)
    acc = torch.zeros((N, C), dtype=torch.float32, device=q.device)
    for i in range(H * W):
        acc = fma_f32(qf[:, i], sr, acc)
    return acc * torch.tensor(1.0 / (H * W), dtype=torch.float32,
                              device=q.device)


@torch.no_grad()
def forward(compiled: dict, x: torch.Tensor, width_mult: float = 1.0,
            expansion: int = 4, act_qmax: int = ACT_QMAX) -> torch.Tensor:
    """Logits (N, classes) of f32 NHWC images ``x``."""
    stem, blocks = architecture(width_mult, expansion)
    q, s = quant_rows(x, act_qmax)
    h = max_pool(conv(compiled[stem.name], stem, q, s))
    q, s = quant_rows(h, act_qmax)
    for blk in blocks:
        if blk.sc is not None:
            sc = conv(compiled[blk.sc.name], blk.sc, q, s)
        else:
            sc = (q, s)
        y = conv(compiled[blk.a.name], blk.a, q, s)
        y = conv(compiled[blk.b.name], blk.b, *quant_rows(y, act_qmax))
        y = conv(compiled[blk.c.name], blk.c, *quant_rows(y, act_qmax),
                 shortcut=sc)
        q, s = quant_rows(y, act_qmax)
    pooled = head_pool(q, s)
    hq, hs = quant_rows(pooled, act_qmax)
    head = compiled["head"]["w"]
    acc = hq.double() @ head["codes"]
    return acc.float() * (hs.reshape(-1, 1) * head["scale"].reshape(1, -1))


def logits(weights: dict, x: torch.Tensor, *, mode: str,
           sparsity: float | None = None, width_mult: float = 1.0,
           expansion: int = 4, block: int = 16,
           act_qmax: int = ACT_QMAX, w_qmax: int = W_QMAX) -> torch.Tensor:
    """Compile ``weights`` and run ``x`` through in blocks of ``block``
    rows (a row's logits depend on its own pixels alone)."""
    with torch.no_grad():
        compiled = compile_network(weights, mode, sparsity, w_qmax)
        outs = [forward(compiled, x[i:i + block], width_mult, expansion,
                        act_qmax) for i in range(0, x.shape[0], block)]
    return torch.cat(outs)
