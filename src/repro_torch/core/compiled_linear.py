"""CompiledLinear — constant-parameter compilation and the compiled
forward of linear and conv leaves (ports ``repro/core/compiled_linear.py``).

Per serve mode a compiled weight leaf is:

  int8         {'values': int8, 'scale'}    W-INT7 A-INT8, int8 products
  cfmm         {'codes': int8, 'scale'}     same storage; the head runs
               the cfmm_matmul kernel (kernels/cfmm_matmul.py)
  sparse_cfmm  {'bitmap': uint8, 'values': int8, 'scale'}
               bitmap-packed constant sparsity, (1-s)*8 + 1 bits/param;
               K pads up to a multiple of 8 with masked all-zero rows
  bitserial    {'bs_codes': int8, 'scale'}  the head is the bit-plane
               matmul (core/cfmm.py ``bitserial_matmul``)
  dense        the float leaf itself, not compiled: ``x @ W`` in x's
               dtype (the float reference the other modes are held to)

Every conv leaf is stored in the conv kernels' spatial-major tap layout
(row = tap*c_in + c) and carries its ``ConvGeom``; the layout permute
runs here, once.  Conv leaves keyed ``codes``/``bs_codes`` feed the dense
conv kernel like ``values``: as int8 operands they are the same codes.
Depthwise leaves store dense tap-major ``(k*k, C)`` int8 ``values`` plus
a per-channel scale in every serve mode (K = k*k rows: a bitmap saves
nothing there).  Stacked leaves ``(layers, K, N)`` compile slice by
slice into stacked compiled leaves, each allocated once.  The bytes are
equal to the JAX package's for the same float weights (tested).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core import cfmm
from repro_torch.core.quantize import (INT8_ACT_MAX, fake_quant_int7,
                                      quantize_int7)
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.bitmap import expand_bitmap_tile

SERVE_MODES = ("dense", "int8", "cfmm", "sparse_cfmm", "bitserial")


def act_quant(x: torch.Tensor, *, per_row: bool = False):
    """Dynamic INT8 activation quantization (the Collector saturates and
    rounds activations to 8 bits, paper SS II-D.4).

    ``per_row=False``: one tensor-wide scalar scale.  ``per_row=True``:
    one scale per leading-axis row (scale shape ``(N,)``), so a row's
    codes never depend on its batch neighbours.  The scale is
    ``amax * f32(1/127)``, as in the JAX package's jitted forward.
    """
    ax = torch.abs(x.float())
    amax = torch.amax(ax, dim=tuple(range(1, x.ndim))) if per_row \
        else torch.amax(ax)
    scale = ops.requant_scale(amax)
    s_b = scale.reshape((-1,) + (1,) * (x.ndim - 1)) if per_row else scale
    q = torch.clamp(torch.round(x.float() / s_b), -INT8_ACT_MAX,
                    INT8_ACT_MAX).to(torch.int8)
    return q, scale


@dataclasses.dataclass(frozen=True)
class ConvGeom:
    """Static (k, stride, c_in) geometry riding a compiled conv weight."""

    k: int
    stride: int
    c_in: int
    dw: bool = False


@dataclasses.dataclass(frozen=True)
class KDim:
    """Unpadded K of an off-%8 *linear* bitmap leaf (stored with
    ceil(K/8)*8 rows by the pad_rows8 rule)."""

    k: int


# ---------------------------------------------------------------------------
# Bitmap packing
# ---------------------------------------------------------------------------

def balanced_prune_codes(w: torch.Tensor, keep_k: int):
    """Keep the top-``keep_k`` |w| entries per column; quantize to INT7.
    The double stable argsort breaks ties as the JAX package's does."""
    ranks = torch.argsort(torch.argsort(-torch.abs(w), dim=0, stable=True),
                          dim=0, stable=True)
    pruned = torch.where(ranks < keep_k, w, torch.zeros_like(w))
    return quantize_int7(pruned, axis=-1)


def bitmap_pack(codes: torch.Tensor, keep_k: int):
    """int8 codes (K, N) with <= keep_k nonzeros/col -> (bitmap, values).

    bitmap: (K/8, N) uint8, little-endian bit j of row r = mask[8r+j].
    values: (keep_k, N) int8, nonzeros in ascending row order.
    """
    K, N = codes.shape
    assert K % 8 == 0, f"K={K} must be divisible by 8"
    mask = codes != 0
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1   # rank within col
    keep = mask & (pos < keep_k)                          # the rest drop
    # every entry scatters to its rank's row; zeros and dropped ones to
    # row keep_k, which is cut off (no boolean indexing: the shapes stay
    # static, so a meta tensor packs too)
    rows = torch.where(keep, pos, keep_k)
    values = torch.zeros((keep_k + 1, N), dtype=torch.int8,
                         device=codes.device)
    values = values.scatter_(0, rows, codes)[:keep_k]
    bits = mask.reshape(K // 8, 8, N).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32,
                                 device=codes.device)).reshape(1, 8, 1)
    bitmap = (bits * weights).sum(dim=1).to(torch.uint8)
    return bitmap, values


def bitmap_unpack(bitmap: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Inverse of bitmap_pack -> dense int8 codes (K, N)."""
    base = torch.zeros((1, bitmap.shape[1]), dtype=torch.int32,
                       device=bitmap.device)
    return expand_bitmap_tile(bitmap, values, base, values.shape[0])[0]


def pad_rows8(codes: torch.Tensor) -> torch.Tensor:
    """Pad the K axis up to a multiple of 8 with all-zero (masked) rows."""
    pad = (-codes.shape[0]) % 8
    if pad == 0:
        return codes
    return torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])


def dense_of(w, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a linear weight leaf, of any form, back to a dense
    ``(K, N)`` tensor: ``codes * scale`` in ``dtype``, as the JAX package
    orders it.  MLA's absorbed decode consumes ``k_up`` and ``v_up`` so:
    algebraically, not as a plain product (models/attention.py)."""
    if isinstance(w, nn.Param):
        w = w.value
    if not isinstance(w, dict):
        return w.to(dtype)
    return packed_codes(w).to(dtype) * w["scale"].to(dtype)


def packed_codes(w: dict) -> torch.Tensor:
    """Dense int8 codes ``(K, N)`` of a packed linear leaf: ``values``,
    ``codes`` or ``bs_codes`` as stored; a bitmap leaf expands
    (``bitmap_unpack``) and drops the rows ``pad_rows8`` added.  Conv
    leaves (stored in the kernels' spatial-major tap layout) have no
    consumer here yet and raise."""
    if "geom" in w:
        raise NotImplementedError("packed_codes of a conv leaf is not "
                                  "ported: only MLA's linear leaves use it")
    if "bitmap" in w:
        dense = bitmap_unpack(w["bitmap"], w["values"])
        if "kdim" in w:                # strip the K % 8 pad
            dense = dense[:w["kdim"].k]
        return dense
    return w.get("codes", w.get("bs_codes", w.get("values")))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_linear(w, x: torch.Tensor, qat: bool = False,
                 per_row: bool = False) -> torch.Tensor:
    """y = x @ W for any compiled or dense weight leaf.  Preserves
    x.dtype.

    A dense leaf (a tensor, or a ``Param`` holding one) is the plain
    product ``x @ W`` with W cast to x's dtype on each call, as the JAX
    package computes it (a ``jnp.matmul`` outside any kernel): no
    activation quantization, and no second copy of the weights kept in
    x's dtype.  ``qat=True`` on a dense leaf first fake-quantizes the f32
    weight on its last axis (``fake_quant_int7``: INT7 numerics forward,
    a straight-through gradient), then multiplies in x's dtype; a
    compiled leaf ignores ``qat``, as in the JAX package.

    ``x`` is ``(..., K)`` in any float type (the LM feeds bf16
    ``(B, T, d)``): the leading axes flatten into the rows of one
    ``(M, K)`` product and come back on the way out.
    ``per_row=True`` quantizes each flattened input row under its own
    INT8 domain — the compiled ResNet head uses it so a request's logits
    never depend on which rows share its microbatch.  Every mode's int32
    product is exact: on the card the ``int8`` and ``cfmm`` products run
    the ``cfmm_matmul`` kernel (one int8 x int8 -> int32 GEMM on the same
    INT7 codes, stored under ``values`` and ``codes``) and ``sparse_cfmm``
    the sparse kernel, all summing in int32; the plain versions on the
    CPU, and the bit-serial product everywhere, sum in float64
    (kernels/ref.py).
    """
    if isinstance(w, nn.Param):
        w = w.value
    if not isinstance(w, dict):                    # dense
        if qat:
            w = fake_quant_int7(w.float(), axis=-1)
        return torch.matmul(x, w.to(x.dtype))
    assert "geom" not in w, "compiled conv leaf: use apply_conv"
    lead = tuple(x.shape[:-1])
    x_q, s_x = act_quant(x.reshape(-1, x.shape[-1]), per_row=per_row)
    if "bitmap" in w:                              # sparse_cfmm
        acc = ops.sparse_cfmm_matmul(x_q, w["bitmap"], w["values"])
    elif "bs_codes" in w:                          # bitserial
        acc = cfmm.bitserial_matmul(x_q, w["bs_codes"])
    elif "codes" in w:                             # cfmm
        acc = ops.cfmm_matmul(x_q, w["codes"])
    else:                                          # int8
        acc = ops.cfmm_matmul(x_q, w["values"])
    s_row = s_x.reshape(-1, 1) if per_row else s_x
    y = acc.float() * (s_row * w["scale"].reshape(1, -1))
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


def apply_conv(w: dict, x_q: torch.Tensor, x_scale, *, gamma=None,
               beta=None, shortcut=None, relu: bool = True,
               quant_out: bool = False, zero_count: int | None = None):
    """Fused conv forward for a compiled conv leaf (carries its geometry).

    Dispatch rides the leaf: depthwise leaves go to the depthwise
    kernel; ``bitmap`` leaves hand the packed pair to the bitmap-native
    sparse conv kernel; ``values``/``codes``/``bs_codes`` leaves feed the
    dense implicit-GEMM kernel.  Returns f32 NHWC, or (int8, scale) with
    quant_out (see kernels.ops.conv2d).  ``zero_count`` opts into
    activation-sparsity profiling: the zero-count dict is appended to the
    return, observation only.
    """
    geom = w["geom"]
    if geom.dw:
        return ops.conv2d_dw(x_q, w["values"], geom.k, geom.stride,
                             x_scale=x_scale, w_scale=w["scale"],
                             gamma=gamma, beta=beta, shortcut=shortcut,
                             relu=relu, quant_out=quant_out,
                             zero_count=zero_count)
    if "bitmap" in w:
        codes = (w["bitmap"], w["values"])
    else:
        codes = w.get("values", w.get("codes", w.get("bs_codes")))
    return ops.conv2d(x_q, codes, geom.k, geom.stride, x_scale=x_scale,
                      w_scale=w["scale"], gamma=gamma, beta=beta,
                      shortcut=shortcut, relu=relu, quant_out=quant_out,
                      zero_count=zero_count)


# ---------------------------------------------------------------------------
# Compilation (training tree -> constant-parameter serving tree)
# ---------------------------------------------------------------------------

def _leaf_axes(kind: str, lead, in_ax, out_ax):
    if kind in ("scale", "values"):
        return lead + (None, out_ax)
    return lead + (in_ax, out_ax)        # bitmap: rows = ceil(in/8)


def _compile_leaf(p: nn.Param, mode: str, sparsity: float) -> dict:
    """One weight leaf.  A stacked leaf ``(*lead, K, N)`` (the LM's
    ``layers`` axis) compiles slice by slice into outputs allocated at
    their stacked shapes, as the JAX package vmaps ``_compile_leaf_2d``
    over the leading axes."""
    w = p.value.float()
    lead, in_ax, out_ax = tuple(p.axes[:-2]), p.axes[-2], p.axes[-1]
    dw = nn.dwconv_geom_of(p.kind)
    if dw is not None:           # depthwise: dense tap-major in every mode
        assert w.ndim == 2, f"stacked depthwise leaves unsupported: " \
            f"{tuple(w.shape)}"
        k, stride = dw
        assert w.shape[0] == k * k, (tuple(w.shape), p.kind)
        qt = quantize_int7(w, axis=-1)             # per-channel scale
        return {"values": nn.Param(qt.values, (in_ax, out_ax)),
                "scale": nn.Param(qt.scale.reshape(1, -1), (None, out_ax)),
                "geom": ConvGeom(k, stride, 1, dw=True)}
    geom = nn.conv_geom_of(p.kind)
    conv_k = geom[0] if geom is not None else None
    K = w.shape[-2]
    w2d = w.reshape((-1,) + tuple(w.shape[-2:]))
    # each output is allocated once at its stacked shape and filled slice
    # by slice: a list of slices and a stack would hold the largest leaf
    # twice (DeepSeek-V2-Lite's int8 expert leaf is 4.5 GiB)
    out = None
    for i, wi in enumerate(w2d):
        one = _compile_leaf_2d(wi, mode, sparsity, conv_k)
        if out is None:
            out = {k: torch.empty((len(w2d),) + tuple(v.shape),
                                  dtype=v.dtype, device=v.device)
                   for k, v in one.items()}
        if w.device.type == "meta":      # no data: one slice gives shapes
            break
        for k, v in one.items():
            out[k][i].copy_(v)
    out = {k: v.reshape(tuple(w.shape[:-2]) + tuple(v.shape[1:]))
           for k, v in out.items()}
    packed = {k: nn.Param(v, _leaf_axes(k, lead, in_ax, out_ax))
              for k, v in out.items()}
    if geom is not None:                           # conv weights stay
        k, stride = geom                           # self-describing
        packed["geom"] = ConvGeom(k, stride, K // (k * k))
    elif mode == "sparse_cfmm" and K % 8 != 0:
        packed["kdim"] = KDim(K)                   # unpadded K (pad_rows8)
    return packed


def _compile_leaf_2d(w: torch.Tensor, mode: str, sparsity: float,
                     conv_k: int | None = None) -> dict:
    K = w.shape[0]
    if mode == "sparse_cfmm":
        keep_k = max(8, int(round(K * (1.0 - sparsity))))
        keep_k = min(K, ((keep_k + 7) // 8) * 8)
        qt = balanced_prune_codes(w, keep_k)
        codes = qt.values
        if conv_k is not None:   # pack in the kernels' spatial-major order
            codes = kref.to_spatial_major(codes, conv_k,
                                          K // (conv_k * conv_k))
        bitmap, values = bitmap_pack(pad_rows8(codes), keep_k)
        return {"bitmap": bitmap, "values": values,
                "scale": qt.scale.reshape(1, -1)}
    qt = quantize_int7(w, axis=-1)
    codes = qt.values
    if conv_k is not None:       # the one conv weight-layout shuffle
        codes = kref.to_spatial_major(codes, conv_k, K // (conv_k * conv_k))
    key = {"int8": "values", "bitserial": "bs_codes"}.get(mode, "codes")
    return {key: codes.contiguous(), "scale": qt.scale.reshape(1, -1)}


def compile_params(params, mode: str = "sparse_cfmm", sparsity: float = 0.8):
    """Convert a trained param tree to its Compiled-NN serving form.

    Only linear- and conv-kind leaves are packed; norms and biases stay
    as they are.  Compiled conv leaves gain a static ``geom`` entry.
    ``dense`` returns ``params`` as they are.
    """
    if mode not in SERVE_MODES:
        raise ValueError(f"serve mode {mode!r}: the port has {SERVE_MODES}")
    if mode == "dense":
        return params

    def visit(p):
        if isinstance(p, nn.Param) and nn.compilable(p.kind) \
                and p.value.ndim >= 2:
            return _compile_leaf(p, mode, sparsity)
        return p

    return nn.tree_map(visit, params, is_leaf=lambda x: isinstance(x, nn.Param))


def ensure_compiled(params, mode: str, sparsity: float):
    """The serving engine's front door: a boxed training tree compiles
    (and unboxes) to its constant-parameter form; an already-compiled
    unboxed tree passes through untouched (``out is params``)."""
    boxed = any(isinstance(l, nn.Param) for l in nn.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, nn.Param)))
    return nn.unbox(compile_params(params, mode=mode, sparsity=sparsity)) \
        if boxed else params
