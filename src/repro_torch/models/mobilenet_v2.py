"""MobileNetV2 — inverted residuals and depthwise convs as a Compiled NN
(ports ``repro/models/mobilenet_v2.py``, compiled path).

Two structural features exercise paths ResNet50 never touches:

* **depthwise 3x3 convs** (groups == channels) compile to the depthwise
  kernel (kernels/conv_depthwise.py) through the ``dwconv`` Param kind;
* **linear bottlenecks**: the projection conv has no ReLU but still
  emits a quantized edge — symmetric int8 needs only max|y|, which the
  Collector epilogue already computes.

Block structure (t = expansion, Table 2 of the MobileNetV2 paper):
expand 1x1 (skipped when t == 1) -> depthwise 3x3 (stride) -> project
1x1 (linear), with the identity shortcut riding the project conv's
Collector whenever stride == 1 and c_in == c_out.  As in the JAX package,
plain ReLU stands in for ReLU6.  ``apply`` on an unboxed float tree runs
the dense reference forward (resnet's ``_conv_apply`` for the dense
convs, ``_dw_apply`` for the depthwise ones).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear
from repro_torch.kernels.ref import _shift_slice, pad_same_nhwc
from repro_torch.models.graph import Graph, Node, apply_graph
from repro_torch.models.resnet import _conv_apply, _conv_init

# (expansion t, out channels c, repeats n, first stride s) — Table 2.
MOBILENET_V2_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _ch(c: int, w: float) -> int:
    """Width-scaled channel count, floored to a multiple of 8."""
    return max(8, (int(c * w) // 8) * 8)


@dataclasses.dataclass(frozen=True)
class MobileNetV2Config:
    width_mult: float = 1.0
    num_classes: int = 1000
    in_hw: int = 224

    # the serving stack drives a model through this trio
    def graph(self) -> Graph:
        return mobilenet_v2_graph(self)

    def init(self, gen: torch.Generator):
        return init(gen, self)

    def apply(self, params, x):
        return apply(params, x, self)


def block_specs(cfg: MobileNetV2Config) -> list:
    """Flattened per-block (t, c_in, c_mid, c_out, stride) chain."""
    out = []
    in_ch = _ch(32, cfg.width_mult)
    for t, c, n, s in MOBILENET_V2_BLOCKS:
        for i in range(n):
            c_out = _ch(c, cfg.width_mult)
            out.append((t, in_ch, t * in_ch, c_out, s if i == 0 else 1))
            in_ch = c_out
    return out


def _dw_init(gen, c, k, stride):
    return {
        "w": nn.dwconv_param(gen, c, k, stride, ("conv_in", "conv_out")),
        "scale": nn.param(gen, (c,), ("conv_out",), init="ones"),
        "bias": nn.param(gen, (c,), ("conv_out",), init="zeros"),
    }


def _dw_apply(p, x, k, stride, relu=True):
    """Dense-path depthwise conv over the tap-major ``(k*k, C)`` weight
    + separate Collector ops: the float reference of the compiled
    depthwise kernel.  The JAX package runs XLA's grouped conv here; the
    port sums the k*k SAME-shifted slices times their taps in plain
    torch (no cuDNN, so no TF32 on the card)."""
    w = p["w"].value if isinstance(p["w"], nn.Param) else p["w"]
    xp, h_out, w_out = pad_same_nhwc(x, k, stride)
    y = None
    for t in range(k * k):
        tap = _shift_slice(xp, t // k, t % k, h_out, w_out, stride) * w[t]
        y = tap if y is None else y + tap
    y = y * p["scale"] + p["bias"]
    return torch.relu(y) if relu else y


def init(gen: torch.Generator, cfg: MobileNetV2Config):
    """The boxed training tree, the JAX package's structure and shapes,
    with values drawn from ``gen`` on the CPU."""
    specs = block_specs(cfg)
    params = {"stem": _conv_init(gen, 3, _ch(32, cfg.width_mult), 3,
                                 stride=2)}
    blocks = []
    for t, c_in, c_mid, c_out, stride in specs:
        blk = {}
        if t != 1:
            blk["ex"] = _conv_init(gen, c_in, c_mid, 1)
        blk["dw"] = _dw_init(gen, c_mid, 3, stride)
        blk["pj"] = _conv_init(gen, c_mid, c_out, 1)
        blocks.append(blk)
    params["blocks"] = blocks
    tail_ch = _ch(1280, cfg.width_mult)
    params["tail"] = _conv_init(gen, specs[-1][3], tail_ch, 1)
    params["head"] = {"w": nn.linear_param(gen, tail_ch, cfg.num_classes,
                                           ("embed", "classes"))}
    return params


def mobilenet_v2_graph(cfg: MobileNetV2Config) -> Graph:
    """MobileNetV2 as a conv-DAG: stem 3x3/s2, inverted-residual blocks
    (expand -> depthwise -> linear project, the identity shortcut riding
    the project conv's epilogue), the 1x1 tail conv and the pooled head.
    Every conv emits a quantized edge (``quant_out``).  Unit names equal
    the JAX package's."""
    specs = block_specs(cfg)
    nodes = [
        Node("image", "input"),
        Node("stem_in", "quant", ("image",), unit="stem"),
        Node("stem", "conv", ("stem_in",), path=("stem",), k=3, stride=2,
             c_in=3, c_out=_ch(32, cfg.width_mult), quant_out=True),
    ]
    prev = "stem"
    for j, (t, c_in, c_mid, c_out, stride) in enumerate(specs):
        u = f"block{j+1}"
        src = prev
        if t != 1:
            nodes.append(Node(f"{u}/ex", "conv", (prev,),
                              path=("blocks", j, "ex"), k=1, c_in=c_in,
                              c_out=c_mid, quant_out=True, unit=u))
            src = f"{u}/ex"
        nodes.append(Node(f"{u}/dw", "dwconv", (src,),
                          path=("blocks", j, "dw"), k=3, stride=stride,
                          c_in=c_mid, c_out=c_mid, quant_out=True, unit=u))
        sc = None
        if stride == 1 and c_in == c_out:      # identity shortcut
            sc = f"{u}/id"
            nodes.append(Node(sc, "dequant", (prev,), unit=u))
        nodes.append(Node(f"{u}/pj", "conv", (f"{u}/dw",),
                          path=("blocks", j, "pj"), k=1, c_in=c_mid,
                          c_out=c_out, relu=False, quant_out=True,
                          shortcut=sc, unit=u))
        prev = f"{u}/pj"
    nodes.append(Node("tail", "conv", (prev,), path=("tail",), k=1,
                      c_in=specs[-1][3], c_out=_ch(1280, cfg.width_mult),
                      quant_out=True, unit="tail"))
    nodes.append(Node("head", "head", ("tail",), path=("head",)))
    return Graph("mobilenet_v2", tuple(nodes), cfg.in_hw, 3,
                 cfg.num_classes)


def apply(params, x: torch.Tensor, cfg: MobileNetV2Config) -> torch.Tensor:
    """x: (B, H, W, 3) f32 -> logits (B, num_classes) on x's device.
    Compiled params (``compiled_linear.ensure_compiled``) run the graph;
    an unboxed float tree runs the dense reference forward."""
    if isinstance(params["stem"]["w"], dict):      # compiled constant params
        return apply_graph(mobilenet_v2_graph(cfg), params, x)
    h = _conv_apply(params["stem"], x, 3, stride=2)
    for p, (t, c_in, c_mid, c_out, stride) in zip(params["blocks"],
                                                  block_specs(cfg)):
        h0 = h
        y = _conv_apply(p["ex"], h, 1) if "ex" in p else h
        y = _dw_apply(p["dw"], y, 3, stride)
        y = _conv_apply(p["pj"], y, 1, relu=False)
        h = y + h0 if (stride == 1 and c_in == c_out) else y
    h = _conv_apply(params["tail"], h, 1)
    pooled = torch.mean(h, dim=(1, 2))
    return apply_linear(params["head"]["w"], pooled)
