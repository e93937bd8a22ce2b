"""RepVGG-A0 — structural re-parameterization as compile-time branch
fusion (ports ``repro/models/repvgg.py``, compiled path).

Training-time RepVGG blocks have three parallel branches — a 3x3 conv, a
1x1 conv and (when stride == 1 and c_in == c_out) an identity — each with
its own folded-BN per-channel scale and bias.  Convolution is linear, so
``fuse_params`` folds them into ONE 3x3 conv ahead of time:

    Wf = W3*g3 + embed(W1*g1) + embed(I*gid),   bf = b3 + b1 + bid

where ``embed`` places a 1x1 weight on the 3x3 kernel's center tap: in
the channel-major flat layout (c_in*k*k, c_out) those are rows ``4::9``.
The fold is f32 elementwise algebra done op by op, as the JAX package
does it eagerly, so the fused tree is byte-equal to the JAX package's.
As there, the 1x1 branch of a stride-2 block is DEFINED as its
center-tap embedding.  The fused network is a sequential chain of 3x3
quant-out convs, served through the compiled graph.  ``apply`` on an
unboxed float tree runs a dense reference forward: the fused 3x3 chain,
or the unfused three branches (3x3, the 1x1 as its centre-tap 3x3
embedding, the identity's scale and bias), so the fold can be held
against the branches it replaces.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import nn
from repro_torch.core.compiled_linear import apply_linear
from repro_torch.models.graph import Graph, Node, apply_graph
from repro_torch.models.resnet import _conv_apply, _conv_init

# (out channels, blocks) per stage — RepVGG-A0; the first block of every
# stage has stride 2 (input stage included: 224 -> 112 at the stem block).
REPVGG_A0_STAGES = [(48, 1), (48, 2), (96, 4), (192, 14), (1280, 1)]


def _ch(c: int, w: float) -> int:
    """Width-scaled channel count (not rounded to 8, as in the JAX
    package: at width 0.25 the stem has K = 27 and later blocks 108)."""
    return max(8, int(c * w))


@dataclasses.dataclass(frozen=True)
class RepVGGConfig:
    width_mult: float = 1.0
    num_classes: int = 1000
    in_hw: int = 224

    def graph(self) -> Graph:
        return repvgg_graph(self)

    def init(self, gen: torch.Generator):
        return init(gen, self)

    def fuse(self, params):
        return fuse_params(params, self)

    def apply(self, params, x):
        return apply(params, x, self)


def block_specs(cfg: RepVGGConfig) -> list:
    """Flattened per-block (name, c_in, c_out, stride, identity) chain."""
    out, in_ch = [], 3
    for i, (c, n) in enumerate(REPVGG_A0_STAGES):
        c_out = _ch(c, cfg.width_mult)
        for b in range(n):
            stride = 2 if b == 0 else 1
            ident = stride == 1 and in_ch == c_out
            out.append((f"stage{i+1}_{b+1}", in_ch, c_out, stride, ident))
            in_ch = c_out
    return out


def init(gen: torch.Generator, cfg: RepVGGConfig):
    """Unfused three-branch params, blocks[j] = {conv3, conv1[, id]}: the
    JAX package's structure and shapes, values drawn from ``gen``."""
    specs = block_specs(cfg)
    blocks = []
    for name, c_in, c_out, stride, ident in specs:
        blk = {"conv3": _conv_init(gen, c_in, c_out, 3, stride=stride),
               "conv1": _conv_init(gen, c_in, c_out, 1, stride=stride)}
        if ident:
            blk["id"] = {
                "scale": nn.param(gen, (c_out,), ("conv_out",), init="ones"),
                "bias": nn.param(gen, (c_out,), ("conv_out",), init="zeros"),
            }
        blocks.append(blk)
    return {"blocks": blocks,
            "head": {"w": nn.linear_param(gen, specs[-1][2],
                                          cfg.num_classes,
                                          ("embed", "classes"))}}


def embed_1x1(w1: torch.Tensor, c_in: int, k: int = 3) -> torch.Tensor:
    """Embed a 1x1 conv weight (c_in, c_out) on the center tap of a kxk
    conv in the channel-major flat layout: rows c*k*k + center."""
    kk, center = k * k, (k * k) // 2
    wf = torch.zeros((c_in * kk, w1.shape[1]), dtype=w1.dtype,
                     device=w1.device)
    wf[center::kk] += w1
    return wf


def _val(p):
    return p.value if isinstance(p, nn.Param) else p


def fuse_params(params, cfg: RepVGGConfig):
    """Compile-time branch fusion: fold the 3x3/1x1/identity branches and
    their per-channel scales into ONE 3x3 conv per block (scale = 1, bias
    = sum of the branch biases).  Returns a boxed Param tree ready for
    ``compile_params``; byte-equal to the JAX package's ``fuse_params``
    on the same tree (the same f32 operations in the same order)."""
    fused = []
    for blk, (name, c_in, c_out, stride, ident) in zip(params["blocks"],
                                                       block_specs(cfg)):
        w3, g3 = _val(blk["conv3"]["w"]), _val(blk["conv3"]["scale"])
        w1, g1 = _val(blk["conv1"]["w"]), _val(blk["conv1"]["scale"])
        wf = w3 * g3 + embed_1x1(w1 * g1, c_in)
        bf = _val(blk["conv3"]["bias"]) + _val(blk["conv1"]["bias"])
        if ident:
            gid = _val(blk["id"]["scale"])
            wf[4::9] += torch.diag(gid.to(wf.dtype))
            bf = bf + _val(blk["id"]["bias"])
        fused.append({
            "w": nn.Param(wf, ("conv_in", "conv_out"),
                          kind=nn.conv_kind(3, stride)),
            "scale": nn.Param(torch.ones((c_out,), dtype=wf.dtype),
                              ("conv_out",)),
            "bias": nn.Param(bf, ("conv_out",)),
        })
    return {"blocks": fused, "head": params["head"]}


def repvgg_graph(cfg: RepVGGConfig) -> Graph:
    """The FUSED network as a conv-DAG: a sequential chain of 3x3
    quant-out convs — every block edge is an articulation cut.  Unit
    names equal the JAX package's."""
    specs = block_specs(cfg)
    nodes = [Node("image", "input"),
             Node("in_q", "quant", ("image",), unit=specs[0][0])]
    prev = "in_q"
    for j, (name, c_in, c_out, stride, _) in enumerate(specs):
        nodes.append(Node(name, "conv", (prev,), path=("blocks", j), k=3,
                          stride=stride, c_in=c_in, c_out=c_out,
                          quant_out=True, unit=name))
        prev = name
    nodes.append(Node("head", "head", (prev,), path=("head",)))
    return Graph("repvgg_a0", tuple(nodes), cfg.in_hw, 3, cfg.num_classes)


def apply(params, x: torch.Tensor, cfg: RepVGGConfig) -> torch.Tensor:
    """x: (B, H, W, 3) f32 -> logits (B, num_classes) on x's device.

    Compiled fused params (``fuse_params`` then
    ``compiled_linear.ensure_compiled``) run the graph; unboxed dense
    fused params run the plain 3x3 chain; unboxed dense UNFUSED params
    run the three-branch reference."""
    blk0 = params["blocks"][0]
    if "conv3" not in blk0 and isinstance(blk0["w"], dict):
        return apply_graph(repvgg_graph(cfg), params, x)     # compiled fused
    h = x
    for p, (name, c_in, c_out, stride, ident) in zip(params["blocks"],
                                                     block_specs(cfg)):
        if "conv3" in p:                                     # unfused
            y = _conv_apply(p["conv3"], h, 3, stride, relu=False)
            # the 1x1 branch is DEFINED as its centre-tap 3x3 embedding
            w1 = {"w": embed_1x1(_val(p["conv1"]["w"]), c_in),
                  "scale": p["conv1"]["scale"], "bias": p["conv1"]["bias"]}
            y = y + _conv_apply(w1, h, 3, stride, relu=False)
            if ident:
                y = y + (h * p["id"]["scale"] + p["id"]["bias"])
            h = torch.relu(y)
        else:                                                # fused dense
            h = _conv_apply(p, h, 3, stride)
    pooled = torch.mean(h, dim=(1, 2))
    return apply_linear(params["head"]["w"], pooled)
