"""ResNet50 — the paper's own network as a Compiled NN (ports
``repro/models/resnet.py``, compiled path).

Residual blocks follow the paper's Fig 1 decomposition: the Kernel is the
convolution MACs and the Non-Kernel is everything else — bias add,
per-channel scaling (folded BatchNorm), ReLU, rounding to 8 bits, and the
shortcut add (the last Collector in each block adds the shortcut,
SS II-D.4).

``resnet_graph`` builds the conv-DAG (models/graph.py): stem conv +
maxpool, bottleneck blocks whose shortcut rides the last conv's Collector
epilogue, classifier head.  ``graph.compile_graph`` cuts it into pipeline
units with producer-side per-row int8 quantization on every unit edge.
Weights are constant int8 codes (dense or bitmap-packed) in the kernels'
spatial-major tap layout carrying their geometry; each conv is ONE fused
kernel launch.  ``apply`` on an unboxed float tree runs the dense
reference forward instead (``_conv_apply``: im2col and one
``torch.matmul`` per conv, the Collector as separate ops), the float
baseline the compiled path is held to.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear
from repro_torch.core.fpga_model import ConvLayerSpec
from repro_torch.kernels.ref import pad_same_nhwc
from repro_torch.models.graph import (Graph, Node, _max_pool_same,
                                      apply_graph)

# (blocks, mid_channels, out_channels, feature hw) per stage — Table I.
RESNET50_STAGES = [
    ("conv2_x", 3, 64, 256, 56),
    ("conv3_x", 4, 128, 512, 28),
    ("conv4_x", 6, 256, 1024, 14),
    ("conv5_x", 3, 512, 2048, 7),
]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    width_mult: float = 1.0
    num_classes: int = 1000
    in_hw: int = 224
    expansion: int = 4          # bottleneck out/mid ratio (Table I: 4)

    def __post_init__(self):
        if self.expansion < 1:
            raise ValueError(
                f"expansion must be a positive integer, got {self.expansion}")

    def stage(self, i):
        name, blocks, mid, _, hw = RESNET50_STAGES[i]
        w = self.width_mult
        return (name, blocks, max(8, int(mid * w)),
                max(8, int(mid * self.expansion * w)), hw)

    # the serving stack drives a model through this trio
    def graph(self) -> Graph:
        return resnet_graph(self)

    def init(self, gen: torch.Generator):
        return init(gen, self)

    def apply(self, params, x):
        return apply(params, x, self)


def table1(expansion: int = 4) -> dict:
    """Reproduce Table I exactly from the architecture definition."""
    rows = {}
    for name, _, mid, out, hw in RESNET50_STAGES:
        if out != expansion * mid:
            raise ValueError(
                f"table1: stage {name} has out={out} but expansion*mid = "
                f"{expansion}*{mid} = {expansion * mid}; Table I's "
                "param/MAC algebra assumes out == expansion*mid")
        in_ch = out  # mid-stage block input = stage output channels
        params = in_ch * mid + mid * mid * 9 + mid * out
        macs = params * hw * hw
        rows[name] = dict(
            channel_count=f"{mid}/{out}",
            hw=f"{hw}x{hw}",
            param_count_k=round(params / 1000),
            total_macs_m=round(macs / 1e6),
            mac_per_param=hw * hw,
        )
    return rows


def conv_blocks_for(cfg: ResNetConfig) -> list[list[ConvLayerSpec]]:
    """All conv layers grouped by block — block 0 is the stem, then the
    residual blocks in dataflow order, with feature sizes following the
    model's SAME/stride chain from ``cfg.in_hw``."""
    w0 = max(8, int(64 * cfg.width_mult))
    h = -(-cfg.in_hw // 2)                       # stride-2 stem conv
    blocks = [[ConvLayerSpec("conv1", 3, w0, 7, h, stride=2)]]
    h = -(-h // 2)                               # stride-2 maxpool
    in_ch = w0
    for i in range(4):
        name, n_blocks, mid, out, _ = cfg.stage(i)
        if name != "conv2_x":
            h = -(-h // 2)                       # stage-entry stride
        for b in range(n_blocks):
            layers = [
                ConvLayerSpec(f"{name}_{b+1}_a", in_ch, mid, 1, h),
                ConvLayerSpec(f"{name}_{b+1}_b", mid, mid, 3, h),
                ConvLayerSpec(f"{name}_{b+1}_c", mid, out, 1, h),
            ]
            if b == 0:  # projection shortcut
                layers.append(ConvLayerSpec(f"{name}_{b+1}_sc", in_ch, out, 1, h))
            blocks.append(layers)
            in_ch = out
    return blocks


def resnet50_conv_blocks() -> list[list[ConvLayerSpec]]:
    """All conv layers grouped by residual block (for the Fig 7 planner)."""
    return conv_blocks_for(ResNetConfig())


def _conv_init(gen, c_in, c_out, k, stride=1):
    return {
        "w": nn.conv_param(gen, c_in, c_out, k, stride,
                           ("conv_in", "conv_out")),
        "scale": nn.param(gen, (c_out,), ("conv_out",), init="ones"),
        "bias": nn.param(gen, (c_out,), ("conv_out",), init="zeros"),
    }


def _conv_apply(p, x, k, stride=1, relu=True, shortcut=None):
    """Dense path: im2col conv + separate Collector ops (scale, bias,
    shortcut, ReLU), the float reference the fused compiled path is held
    to.  A patch's features are channel-major (c_in slowest, then kh,
    kw): the dense weight's row order, and the order
    ``jax.lax.conv_general_dilated_patches`` gives.  ``F.unfold`` on
    NCHW gives that order; the SAME padding (more at the end for stride
    2) is explicit, so the unfold pads nothing."""
    if k > 1:
        xp, h_out, w_out = pad_same_nhwc(x, k, stride)
        cols = F.unfold(xp.permute(0, 3, 1, 2), k, stride=stride)
        patches = cols.transpose(1, 2).reshape(x.shape[0], h_out, w_out,
                                               cols.shape[1])
    else:
        patches = x[:, ::stride, ::stride, :]
    y = apply_linear(p["w"], patches)
    y = y * p["scale"] + p["bias"]
    if shortcut is not None:
        y = y + shortcut
    return torch.relu(y) if relu else y


def _block_stride(name: str, b: int) -> int:
    return 2 if (b == 0 and name != "conv2_x") else 1


def init(gen: torch.Generator, cfg: ResNetConfig):
    """The boxed training tree, the JAX package's structure and shapes,
    with values drawn from ``gen`` on the CPU."""
    w0 = max(8, int(64 * cfg.width_mult))
    params = {"stem": _conv_init(gen, 3, w0, 7, stride=2)}
    in_ch = w0
    for i in range(4):
        name, n_blocks, mid, out, _ = cfg.stage(i)
        stage = []
        for b in range(n_blocks):
            stride = _block_stride(name, b)
            blk = {
                "a": _conv_init(gen, in_ch, mid, 1, stride=stride),
                "b": _conv_init(gen, mid, mid, 3),
                "c": _conv_init(gen, mid, out, 1),
            }
            if b == 0:
                blk["sc"] = _conv_init(gen, in_ch, out, 1, stride=stride)
            stage.append(blk)
            in_ch = out
        params[name] = stage
    params["head"] = {"w": nn.linear_param(gen, in_ch, cfg.num_classes,
                                           ("embed", "classes"))}
    return params


def resnet_graph(cfg: ResNetConfig) -> Graph:
    """ResNet50 as a conv-DAG: the stem unit (quant -> 7x7/s2 conv ->
    maxpool -> quant), one unit per bottleneck block — the projection
    (b==0) or identity-dequant shortcut feeding the c-conv's Collector
    epilogue, a/b convs emitting int8 in-block (quant_out), a
    producer-side quant on the block edge — and the classifier head.
    Unit names ("stem", "conv2_x_1", ..., "head") equal the JAX
    package's."""
    w0 = max(8, int(64 * cfg.width_mult))
    nodes = [
        Node("image", "input"),
        Node("stem_in", "quant", ("image",), unit="stem"),
        Node("stem", "conv", ("stem_in",), path=("stem",), k=7, stride=2,
             c_in=3, c_out=w0),
        Node("stem_pool", "pool", ("stem",), k=3, stride=2),
        Node("stem_q", "quant", ("stem_pool",)),
    ]
    prev, in_ch = "stem_q", w0
    for i in range(4):
        name, n_blocks, mid, out, _ = cfg.stage(i)
        for b in range(n_blocks):
            u = f"{name}_{b+1}"
            stride = _block_stride(name, b)
            if b == 0:                       # projection shortcut (no ReLU)
                sc = f"{u}/sc"
                nodes.append(Node(sc, "conv", (prev,), path=(name, b, "sc"),
                                  k=1, stride=stride, c_in=in_ch, c_out=out,
                                  relu=False, unit=u))
            else:                            # identity: dequant the block input
                sc = f"{u}/id"
                nodes.append(Node(sc, "dequant", (prev,), unit=u))
            nodes.append(Node(f"{u}/a", "conv", (prev,), path=(name, b, "a"),
                              k=1, stride=stride, c_in=in_ch, c_out=mid,
                              quant_out=True))
            nodes.append(Node(f"{u}/b", "conv", (f"{u}/a",),
                              path=(name, b, "b"), k=3, c_in=mid, c_out=mid,
                              quant_out=True))
            nodes.append(Node(f"{u}/c", "conv", (f"{u}/b",),
                              path=(name, b, "c"), k=1, c_in=mid, c_out=out,
                              shortcut=sc))
            nodes.append(Node(f"{u}/q", "quant", (f"{u}/c",)))
            prev, in_ch = f"{u}/q", out
    nodes.append(Node("head", "head", (prev,), path=("head",)))
    return Graph("resnet50", tuple(nodes), cfg.in_hw, 3, cfg.num_classes)


def apply(params, x: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """x: (B, H, W, 3) f32 -> logits (B, num_classes) on x's device.
    Compiled params (``compiled_linear.ensure_compiled``) run the graph;
    an unboxed float tree runs the dense reference forward."""
    if isinstance(params["stem"]["w"], dict):      # compiled constant params
        return apply_graph(resnet_graph(cfg), params, x)
    h = _conv_apply(params["stem"], x, 7, stride=2)
    h = _max_pool_same(h, 3, 2)
    for i in range(4):
        name = cfg.stage(i)[0]
        for b, blk in enumerate(params[name]):
            stride = _block_stride(name, b)
            sc = (_conv_apply(blk["sc"], h, 1, stride, relu=False)
                  if "sc" in blk else h)
            y = _conv_apply(blk["a"], h, 1, stride)
            y = _conv_apply(blk["b"], y, 3)
            h = _conv_apply(blk["c"], y, 1, relu=True, shortcut=sc)
    pooled = torch.mean(h, dim=(1, 2))
    return apply_linear(params["head"]["w"], pooled)
