"""ResNet50 (He et al., arXiv:1512.03385, Table 1) as the benchmark serves
it: its float weights made from the seed, the program's front door over
them, the plain reference (``reference/resnet50.py``), and the work of
each conv counted from the network's shapes.

A conv's operations are 2 x the kept weights' MACs: every weight under
``int8``, ``keep_rows(K)`` of each column under ``sparse_cfmm``.  Its
bytes are each operand and result moved once: the int8 input map, the
weights as served (``int8``: K x n int8; ``sparse_cfmm``: the bitmap,
K/8 rounded up to whole rows x n, and the kept int8 values), the
Collector's per-image scale row and bias (f32), the shortcut (an f32 map
for a projection, int8 codes and a per-image scale for the identity),
and the f32 output with its per-image max.
"""
from __future__ import annotations

import math

import torch

from portbench import weights
from portbench.reference import resnet50 as ref
from portbench.work import Launch

BN_SCALE = (0.5, 1.5)      # folded-BN scale ~ U(0.5, 1.5)
BN_BIAS_STD = 0.1          # folded-BN bias ~ N(0, 0.1)
CONV_KERNELS = {"conv_implicit": "int8", "conv_sparse": "sparse_cfmm"}


def sparsity(serve: dict):
    """The configuration's sparsity where its mode prunes, else None."""
    return serve["sparsity"] if serve["mode"] == "sparse_cfmm" else None


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def float_weights(model: dict, seed: int, device) -> dict:
    """{conv name: {"w": (c_in*k*k, c_out), "scale": (c_out,),
    "bias": (c_out,)}, "head": {"w": (features, classes)}}, f32 on
    ``device``, in three large calls (one truncated normal for every conv
    and linear weight, one uniform for the folded-BN scales, one normal
    for the biases).  Weights are truncated normals in [-2, 2] times
    1/sqrt(fan_in), as the program's ``ResNetConfig.init`` draws them."""
    convs = ref.convs(model["width_mult"], model["expansion"])
    shapes = [(c.c_in * c.k * c.k, c.c_out) for c in convs]
    shapes.append((convs[-1].c_out, model["num_classes"]))
    g = weights.generator(seed, device)
    n_w = sum(a * b for a, b in shapes)
    n_ch = sum(c.c_out for c in convs)
    flat = torch.empty(n_w, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=g)
    gam = torch.empty(n_ch, device=device).uniform_(*BN_SCALE, generator=g)
    bet = torch.empty(n_ch, device=device).normal_(0.0, BN_BIAS_STD,
                                                   generator=g)
    out, off, ch = {}, 0, 0
    for c, (k_rows, n) in zip(convs, shapes):
        w = flat[off:off + k_rows * n].view(k_rows, n)
        w.mul_(1.0 / math.sqrt(k_rows))
        out[c.name] = {"w": w, "scale": gam[ch:ch + n],
                       "bias": bet[ch:ch + n]}
        off += k_rows * n
        ch += n
    k_rows, n = shapes[-1]
    w = flat[off:off + k_rows * n].view(k_rows, n)
    w.mul_(1.0 / math.sqrt(k_rows))
    out["head"] = {"w": w}
    return out


def input_pool(model: dict, n: int, seed: int, device):
    return weights.image_pool(model, n, seed, device)


# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------

def program_tree(fw: dict, model: dict):
    """The float weights as the boxed tree ``ResNetConfig.init``
    returns (the same tensors, not copies)."""
    from repro_torch import nn

    def leaf(name, c):
        d = fw[name]
        return {"w": nn.Param(d["w"], ("conv_in", "conv_out"),
                              nn.conv_kind(c.k, c.stride)),
                "scale": nn.Param(d["scale"], ("conv_out",)),
                "bias": nn.Param(d["bias"], ("conv_out",))}

    stem, blocks = ref.architecture(model["width_mult"], model["expansion"])
    tree = {"stem": leaf(stem.name, stem)}
    for blk in blocks:
        stage = blk.name.split(".")[0]
        b = {"a": leaf(blk.a.name, blk.a), "b": leaf(blk.b.name, blk.b),
             "c": leaf(blk.c.name, blk.c)}
        if blk.sc is not None:
            b["sc"] = leaf(blk.sc.name, blk.sc)
        tree.setdefault(stage, []).append(b)
    tree["head"] = {"w": nn.Param(fw["head"]["w"], ("embed", "classes"),
                                  "linear")}
    return tree


def front_door(config: dict, fw: dict, device: str, telemetry=None):
    from repro_torch.models.resnet import ResNetConfig
    from repro_torch.serving.frontend import ResNetFrontend
    m, s = config["model"], config["serve"]
    cfg = ResNetConfig(width_mult=m["width_mult"],
                       num_classes=m["num_classes"], in_hw=m["in_hw"],
                       expansion=m["expansion"])
    sp = sparsity(s)
    return ResNetFrontend(
        cfg, program_tree(fw, m), mode=s["mode"],
        **({} if sp is None else {"sparsity": sp}),
        n_replicas=s["replicas"], n_stages=s["stages"],
        microbatch=s["microbatch"], device=device,
        continuous=s["continuous"], slo_p95_s=s["slo_p95_s"],
        telemetry=telemetry)


def request(rid: int, rows):
    from repro_torch.serving.frontend import FrontendRequest
    return FrontendRequest(rid=rid, images=rows)


# ---------------------------------------------------------------------------
# The plain reference
# ---------------------------------------------------------------------------

def reference_logits(config: dict, fw: dict, x: torch.Tensor,
                     act_qmax: int = ref.ACT_QMAX,
                     w_qmax: int = ref.W_QMAX) -> torch.Tensor:
    m, s = config["model"], config["serve"]
    return ref.logits(fw, x, mode=s["mode"], sparsity=sparsity(s),
                      width_mult=m["width_mult"], expansion=m["expansion"],
                      act_qmax=act_qmax, w_qmax=w_qmax)


# ---------------------------------------------------------------------------
# The work
# ---------------------------------------------------------------------------

def conv_work(model: dict, mode: str, sp) -> list:
    """Every conv of the forward as a ``Launch`` with its per-image work,
    in order."""
    stem, blocks = ref.architecture(model["width_mult"], model["expansion"])
    out = []

    def add(c: ref.Conv, hw_in: int, shortcut: str | None) -> int:
        hw = ref.same_pads(hw_in, c.k, c.stride)[2]
        k_rows = c.c_in * c.k * c.k
        if mode == "sparse_cfmm":
            kept = ref.keep_rows(k_rows, sp)
            w_bytes = (-(-k_rows // 8)) * c.c_out + kept * c.c_out
        else:
            kept = k_rows
            w_bytes = k_rows * c.c_out
        pix = hw * hw * c.c_out
        act = hw_in * hw_in * c.c_in + 4 * pix + 4 + 4 * c.c_out
        if shortcut == "projection":
            act += 4 * pix
        elif shortcut == "identity":
            act += pix + 4
        out.append(Launch(c.name, hw * hw * kept * c.c_out, act,
                          w_bytes + 4 * c.c_out))
        return hw

    hw = add(stem, model["in_hw"], None)
    hw = ref.same_pads(hw, 3, 2)[2]                  # the max pool
    for blk in blocks:
        if blk.sc is not None:
            add(blk.sc, hw, None)
        h2 = add(blk.a, hw, None)
        add(blk.b, h2, None)
        add(blk.c, h2, "identity" if blk.sc is None else "projection")
        hw = h2
    return out


def head_macs(model: dict, mode: str, sp) -> int:
    feat = ref.architecture(model["width_mult"],
                            model["expansion"])[1][-1].c.c_out
    kept = ref.keep_rows(feat, sp) if mode == "sparse_cfmm" else feat
    return kept * model["num_classes"]


def ops_per_row(config: dict) -> int:
    """int8 operations of one image's forward: 2 x the kept-weight MACs
    of every conv and of the head."""
    m, s = config["model"], config["serve"]
    sp = sparsity(s)
    return 2 * (sum(c.macs for c in conv_work(m, s["mode"], sp))
                + head_macs(m, s["mode"], sp))


def kernel_launches(config: dict, kernel: str) -> list:
    """Every conv, on the conv kernel of the configuration's mode
    (``conv_sparse`` under ``sparse_cfmm``, ``conv_implicit`` under
    ``int8``); no launch on any other kernel is counted."""
    s = config["serve"]
    if CONV_KERNELS.get(kernel) != s["mode"]:
        return []
    return conv_work(config["model"], s["mode"], sparsity(s))
