"""Throughput-balanced multi-chip partitioning — paper SS III / Fig 7 (ports
``repro/core/partition.py``, the LM partitioner ``partition_lm`` too).

Given a network's layer list and a target throughput, size every layer's
kernel with the calibrated FPGA model (core.fpga_model.plan_layer), then
greedily pack layers into chips in dataflow order subject to:

  * a Residual Block must be fully contained in one chip (keeps the
    shortcut on-chip, paper SS II-C);
  * chip ALM utilization <= util_target;
  * inter-chip links carry 8-bit feature maps at the pipeline rate and
    must stay under max_link_gbps (75 Gbps in Fig 7).

The executable side is ``StagePlan``: contiguous block groups that the
pipeline serving engine (serving/pipeline.py) maps 1:1 onto its stages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import fpga_model
from repro_torch.core.fpga_model import FPGASpec, GX280, GX550, ConvLayerSpec


class PartitionError(ValueError):
    """A layer/block cannot be placed within the chip's usable fabric.

    Raised instead of silently emitting chips above ``util_target`` (the
    old packer gave every oversized kernel instance its own >100%-utilized
    chip and reported success)."""


@dataclasses.dataclass
class Chip:
    index: int
    layers: list
    alms_used: float = 0.0

    def utilization(self, spec: FPGASpec) -> float:
        return self.alms_used / spec.alms


@dataclasses.dataclass
class PartitionResult:
    chips: list
    target_im_s: float
    achieved_im_s: float       # min(target, slowest folded block)
    link_gbps: list            # between consecutive chips
    spec: FPGASpec
    bottleneck: str = ""

    @property
    def n_chips(self) -> int:
        return len(self.chips)

    @property
    def im_s_per_chip(self) -> float:
        return self.achieved_im_s / max(self.n_chips, 1)

    @property
    def max_link_gbps(self) -> float:
        return max(self.link_gbps, default=0.0)

    def summary(self) -> dict:
        return dict(
            n_chips=self.n_chips,
            target_im_s=self.target_im_s,
            achieved_im_s=self.achieved_im_s,
            im_s_per_chip=self.im_s_per_chip,
            bottleneck=self.bottleneck,
            max_link_gbps=self.max_link_gbps,
            chip_utilization=[round(c.utilization(self.spec), 3)
                              for c in self.chips],
        )

    def stage_plans(self, blocks: list, n_stages: int | None = None,
                    edge_bytes: list | None = None) -> list:
        """Executable ``StagePlan``s for this partition (see stage_plans)."""
        return stage_plans(self, blocks, n_stages, edge_bytes)


def partition(blocks: list[list[ConvLayerSpec]], target_im_s: float,
              spec: FPGASpec = GX280, util_target: float = 0.76,
              batch: int = 2) -> PartitionResult:
    """Pack residual blocks into chips in dataflow order.

    Blocks are kept on one chip where they fit (the paper's requirement);
    blocks larger than a whole chip — conv5_1 with its 2048x2048 projection
    shortcut cannot fit a GX280 at any useful fold — are split at layer
    granularity with the shortcut crossing chips (documented deviation:
    DESIGN.md notes the paper's Fig 7 must do the same or de-rate).
    Pipeline throughput = min over kernels of their folded capability.
    """
    cap = spec.usable_alms(util_target)
    achieved, bottleneck = float("inf"), ""
    chips: list[Chip] = [Chip(0, [])]
    for blk in blocks:
        plans = [fpga_model.plan_layer(l, target_im_s, chip=spec,
                                       util_target=util_target) for l in blk]
        for p in plans:
            if p["im_s_capable"] < achieved:
                achieved, bottleneck = p["im_s_capable"], p["layer"]
        blk_alms = sum(p["alms"] for p in plans)
        if blk_alms <= cap:  # atomic placement
            if chips[-1].alms_used + blk_alms > cap and chips[-1].layers:
                chips.append(Chip(len(chips), []))
            chips[-1].layers.extend(
                {**p, "spec": l} for p, l in zip(plans, blk))
            chips[-1].alms_used += blk_alms
        else:                # oversized block: layer/instance-granular split
            for p, l in zip(plans, blk):
                per_inst = p["alms"] / max(p["instances"], 1)
                if per_inst > cap:
                    # even one kernel instance (at the cost model's maximum
                    # useful fold) overflows the usable fabric: error out
                    # rather than emitting a >util_target chip
                    raise PartitionError(
                        f"layer {l.name}: one instance needs "
                        f"{per_inst / 1e3:.0f}k ALMs at fold {p['fold']} "
                        f"but only {cap / 1e3:.0f}k are usable on "
                        f"{spec.name} at util_target={util_target}")
                for _ in range(max(p["instances"], 1)):
                    if (chips[-1].alms_used + per_inst > cap
                            and chips[-1].layers):
                        chips.append(Chip(len(chips), []))
                    chips[-1].layers.append(
                        {**p, "alms": per_inst, "spec": l,
                         "split_block": True})
                    chips[-1].alms_used += per_inst
    achieved = min(achieved, target_im_s)
    # inter-chip links: 8-bit activations at the pipeline rate; double-
    # buffered boundaries (paper SS II-D.1) don't change steady-state rate.
    link_gbps = []
    for chip in chips[:-1]:
        out_layer = chip.layers[-1]["spec"]
        gbps = out_layer.out_bytes * 8 * achieved / 1e9
        link_gbps.append(gbps)
    return PartitionResult(chips, target_im_s, achieved, link_gbps, spec,
                           bottleneck)


def solve_max_throughput(blocks, spec: FPGASpec = GX280,
                         util_target: float = 0.76,
                         max_link_gbps: float = 75.0,
                         lo: float = 1_000.0, hi: float = 200_000.0) -> PartitionResult:
    """Find the highest target im/s whose partition respects the link cap
    and yields the best im/s/chip (bisection over the target)."""
    best = partition(blocks, lo, spec, util_target)
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        r = partition(blocks, mid, spec, util_target)
        if r.max_link_gbps <= max_link_gbps:
            if r.im_s_per_chip >= best.im_s_per_chip:
                best = r
            lo = mid
        else:
            hi = mid
    return best


def fig7_projection(spec: FPGASpec = GX280) -> dict:
    """Reproduce the paper's Fig 7 projection and compare to its claims."""
    from repro_torch.models.resnet import resnet50_conv_blocks
    blocks = resnet50_conv_blocks()
    claimed = fpga_model.FIG7
    ours = partition(blocks, claimed["im_s_total"], spec)
    best = solve_max_throughput(blocks, spec)
    v100 = claimed["v100_sparse_bound"]
    return dict(
        paper_claim=claimed,
        at_paper_target=ours.summary(),
        model_best=best.summary(),
        gx550_scaling=dict(
            im_s_per_chip=best.im_s_per_chip * GX550.alms / spec.alms,
            speedup_vs_v100_bound=(best.im_s_per_chip * GX550.alms
                                   / spec.alms) / v100,
        ),
    )


# ---------------------------------------------------------------------------
# Executable stage plans (the Fig 7 partition as a runnable pipeline)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagePlan:
    """One pipeline stage of the *executable* multi-device serving path.

    ``block_ids`` index the network's block list (``resnet.conv_blocks_for``
    order: 0 = the stem, 1.. = residual blocks); the serving engine maps
    them 1:1 onto its pipeline units, with the classifier head riding the
    last stage.  ``link_bytes`` is the analytic int8 activation payload
    this stage sends downstream per image — the paper's 8-bit inter-chip
    link, cross-checked against the bytes the executed pipeline actually
    moves (tests/test_pipeline.py).
    """

    index: int
    block_ids: tuple
    layer_names: tuple
    link_bytes: int            # int8 bytes/image on the outgoing edge (0: last)
    macs: int = 0
    alms: float = 0.0

    def link_gbps(self, im_s: float) -> float:
        return self.link_bytes * 8 * im_s / 1e9


def edge_bytes_after_block(blocks: list, j: int) -> int:
    """int8 activation bytes per image leaving block ``j`` — the ResNet
    convention: block 0 is a stem whose executable unit max-pools 2x2
    after its conv, so the stem edge carries a quarter of conv1's map.

    DAG-general models don't follow that convention; the planner entry
    points below accept an explicit per-block ``edge_bytes`` list
    (``models.graph.Graph.edge_bytes`` computes it from the graph's real
    cut-edge shapes) and fall back to this legacy accounting when given
    none — for ResNet the two agree exactly (tested).
    """
    spec = blocks[j][-1]
    if j == 0:
        hw = -(-spec.hw // 2)          # SAME stride-2 maxpool
        return hw * hw * spec.c_out
    return spec.out_bytes


def split_stages(costs: list, n_stages: int) -> list:
    """Balanced contiguous split of ``costs`` into ``n_stages`` non-empty
    groups (greedy threshold; never emits fewer groups than asked while
    items remain)."""
    n_stages = max(1, min(n_stages, len(costs)))
    total = float(sum(costs))
    target = total / n_stages
    groups, cur, acc = [], [], 0.0
    for i, c in enumerate(costs):
        # adding item i to cur must leave enough items for the remaining
        # groups; close cur first when it would not
        if cur and len(costs) - i < n_stages - len(groups):
            groups.append(tuple(cur))
            cur, acc = [], 0.0
        cur.append(i)
        acc += float(c)
        if acc >= target and len(groups) < n_stages - 1:
            groups.append(tuple(cur))
            cur, acc = [], 0.0
    if cur:
        groups.append(tuple(cur))
    return groups


def _plans_from_groups(blocks: list, groups: list,
                       alms_per_block: list | None = None,
                       edge_bytes: list | None = None) -> list:
    plans = []
    for s, ids in enumerate(groups):
        names = tuple(l.name for j in ids for l in blocks[j])
        link = 0 if s == len(groups) - 1 else (
            edge_bytes[ids[-1]] if edge_bytes is not None
            else edge_bytes_after_block(blocks, ids[-1]))
        macs = int(sum(l.macs for j in ids for l in blocks[j]))
        alms = (sum(alms_per_block[j] for j in ids)
                if alms_per_block is not None else 0.0)
        plans.append(StagePlan(s, tuple(ids), names, link, macs, alms))
    return plans


def plan_stages(blocks: list, n_stages: int,
                edge_bytes: list | None = None) -> list:
    """MAC-balanced contiguous ``StagePlan``s along block boundaries —
    the explicit-stage-map path (no FPGA cost model involved)."""
    groups = split_stages([sum(l.macs for l in blk) for blk in blocks],
                          n_stages)
    return _plans_from_groups(blocks, groups, edge_bytes=edge_bytes)


def explicit_stage_plans(blocks: list, groups: list,
                         edge_bytes: list | None = None) -> list:
    """``StagePlan``s from an explicit stage map (tuple of block-id tuples
    — must be a contiguous in-order partition of the block list)."""
    flat = [j for g in groups for j in g]
    assert flat == list(range(len(blocks))), (
        "stage map must cover blocks 0..%d contiguously" % (len(blocks) - 1),
        groups)
    return _plans_from_groups(blocks, [tuple(g) for g in groups],
                              edge_bytes=edge_bytes)


def stage_plans(result: PartitionResult, blocks: list,
                n_stages: int | None = None,
                edge_bytes: list | None = None) -> list:
    """Executable stages from a Fig 7 chip packing.

    Chip boundaries are re-aligned to block boundaries (a block whose
    layers were instance-split across chips folds into the stage owning
    its first layer — the executable granularity is the residual block,
    which keeps every shortcut on-stage).  With ``n_stages`` the chip
    grouping is re-balanced by per-block ALMs into that many contiguous
    stages (serving fewer devices than Fig 7 chips).
    """
    chip_of_layer, layer_order = {}, []
    alms_of_layer = {}
    for chip in result.chips:
        for p in chip.layers:
            if p["layer"] not in chip_of_layer:
                chip_of_layer[p["layer"]] = chip.index
                layer_order.append(p["layer"])
            alms_of_layer[p["layer"]] = (alms_of_layer.get(p["layer"], 0.0)
                                         + p["alms"])
    if not all(l.name in chip_of_layer for blk in blocks for l in blk):
        # the result was solved over a structurally-equal block list with
        # different layer names (e.g. a Fig 7 packing of the legacy
        # ResNet-convention specs applied to graph-derived blocks):
        # re-key it positionally — same chain, so the i-th layer of the
        # solve is the i-th layer here
        flat = [l.name for blk in blocks for l in blk]
        if len(flat) != len(layer_order):
            raise ValueError(
                f"partition result covers {len(layer_order)} layers but "
                f"the block list holds {len(flat)}; layer names don't "
                "match and positional alignment is impossible")
        chip_of_layer = {new: chip_of_layer[old]
                         for new, old in zip(flat, layer_order)}
        alms_of_layer = {new: alms_of_layer[old]
                         for new, old in zip(flat, layer_order)}
    block_chip = [chip_of_layer[blk[0].name] for blk in blocks]
    alms_per_block = [sum(alms_of_layer.get(l.name, 0.0) for l in blk)
                      for blk in blocks]
    if n_stages is not None:
        groups = split_stages(alms_per_block, n_stages)
    else:
        groups, cur = [], [0]
        for j in range(1, len(blocks)):
            if block_chip[j] != block_chip[j - 1]:
                groups.append(tuple(cur))
                cur = []
            cur.append(j)
        groups.append(tuple(cur))
    return _plans_from_groups(blocks, groups, alms_per_block, edge_bytes)


# ---------------------------------------------------------------------------
# LM pipeline partitioning (the paper's multi-chip pipeline, for the zoo)
# ---------------------------------------------------------------------------

def partition_lm(cfg, n_stages: int, batch: int = 1, seq: int = 1,
                 serve_mode: str = "sparse_cfmm",
                 link_gbps_budget: float = 75.0) -> dict:
    """Throughput-balanced pipeline stages for an LM (persistent weights).

    The paper's Fig 7 discipline applied to transformers: split the layer
    stack into ``n_stages`` contiguous stages with near-equal per-token
    FLOPs, keep residual blocks atomic, and check the inter-stage link
    bandwidth (activations (B, 1, d_model) per decode step, or (B, S, d)
    for prefill) against the budget.  Weights stay resident per stage —
    the analogue of compiling parameters into each chip.
    """
    from repro_torch.roofline.analytic import BYTES_PER_PARAM

    sigs = cfg.layer_sigs()
    # per-layer forward flops per token (matmul-only; attention excluded as
    # cache-dependent — balancing by linear work matches the paper's
    # MAC-based balance)
    def layer_flops(sig):
        d = cfg.d_model
        f = 0.0
        if sig["kind"] == "attn":
            if cfg.mla:
                m = cfg.mla
                f += 2 * d * cfg.n_heads * (m.qk_nope + m.qk_rope)
                f += 2 * d * (m.kv_lora + m.qk_rope)
                f += 2 * m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_dim)
                f += 2 * cfg.n_heads * m.v_dim * d
            else:
                f += 2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                f += 2 * cfg.n_heads * cfg.head_dim * d
        elif sig["kind"] in ("mamba", "rwkv"):
            di = cfg.ssm.d_inner if cfg.ssm.kind == "mamba" else d
            f += 2 * d * 4 * di
        if sig["moe"]:
            m = cfg.moe
            f += 2 * d * m.d_ff_expert * 3 * (m.top_k + m.n_shared)
        elif sig["kind"] != "rwkv":
            f += 2 * d * cfg.d_ff * 3
        else:
            f += 2 * d * cfg.d_ff * 2
        return f

    flops = [layer_flops(s) for s in sigs]
    stages = split_stages(flops, n_stages)
    bpp = BYTES_PER_PARAM.get(serve_mode, 2.0)
    stage_flops = [sum(flops[i] for i in st) for st in stages]
    # per-stage resident weight bytes (flops/token = 2*params for linears)
    stage_weight_gb = [f / 2.0 * bpp / 1e9 for f in stage_flops]
    # inter-stage activation traffic per step
    act_bytes = batch * max(seq, 1) * cfg.d_model * 2
    return dict(
        n_stages=len(stages),
        layers_per_stage=[len(s) for s in stages],
        stage_flops_per_token=stage_flops,
        balance=min(stage_flops) / max(stage_flops),
        boundary_bytes_per_step=act_bytes,
        link_gbps_at_10k_steps_s=act_bytes * 8 * 10_000 / 1e9,
        link_budget_ok=act_bytes * 8 * 10_000 / 1e9 <= link_gbps_budget,
        stage_weight_gb=stage_weight_gb,
        serve_mode=serve_mode,
    )
