"""Roofline terms and the H100's peaks (ports ``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh), in seconds, on one NVIDIA H100 SXM:

  compute    = per-device FLOPs      / peak FLOP/s   (989 TF/s bf16)
  memory     = per-device HBM bytes  / HBM bandwidth (3.35 TB/s)
  collective = per-device wire bytes / link rate     (50 GB/s)

The counts come from ``from_counts``: the analytic model
(``roofline/analytic.py``, primary, as in the JAX package) or a count
taken on the meta device (``launch/dryrun.py``).  JAX's ``from_compiled``
and ``parse_collectives`` read XLA's cost analysis and HLO text, which
torch does not have.

The peaks are the one place the port keeps them; ``chip_smoke.py``'s
bounds import them.  They assume the full 700 W power limit.
"""
from __future__ import annotations

import dataclasses

from repro_torch import nn

# ---- NVIDIA H100 SXM (H100 data sheet, dense rates, no sparsity) ----
PEAK_BF16 = 989e12        # FLOP/s, bf16 tensor cores
PEAK_INT8 = 1979e12       # OP/s, int8 tensor cores
PEAK_F32 = 67e12          # FLOP/s, f32 outside the tensor cores
HBM_BW = 3.35e12          # B/s, HBM3
# B/s per GPU across nodes: one 400 Gb/s NDR InfiniBand port per H100 in
# a DGX H100 (its data sheet); the 16-way mesh axes span two or more
# eight-GPU nodes, so their collectives cross this link, not NVLink
LINK_BW = 50e9


@dataclasses.dataclass
class Roofline:
    flops: float              # per-device
    hbm_bytes: float          # per-device
    wire_bytes: float         # per-device
    chips: int
    model_flops: float = 0.0  # 6*N*D (train) / 2*N_active*D (serve), global

    @property
    def compute_s(self):
        return self.flops / PEAK_BF16

    @property
    def memory_s(self):
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self):
        return self.wire_bytes / LINK_BW

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self):
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self):
        """MODEL_FLOPS / global FLOPs — remat/redundancy waste."""
        if self.flops <= 0:
            return 0.0
        return self.model_flops / (self.flops * self.chips)

    @property
    def roofline_fraction(self):
        """Achievable MFU bound: useful compute time / bound time."""
        if self.bound_s <= 0:
            return 0.0
        useful_s = self.model_flops / self.chips / PEAK_BF16
        return useful_s / self.bound_s

    def to_dict(self):
        return dict(
            flops_per_device=self.flops, hbm_bytes_per_device=self.hbm_bytes,
            wire_bytes_per_device=self.wire_bytes, chips=self.chips,
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant,
            model_flops=self.model_flops,
            useful_flops_fraction=self.useful_flops_fraction,
            roofline_fraction=self.roofline_fraction,
        )


def from_counts(flops: float, hbm_bytes: float, wire_bytes: float,
                chips: int, model_flops: float) -> Roofline:
    """A roofline from per-device counts taken without XLA."""
    return Roofline(float(flops), float(hbm_bytes), float(wire_bytes),
                    chips, model_flops)


def model_flops_for(cfg, n_params: int, active_params: int, shape: dict,
                    step: str) -> float:
    """6*N*D train; 2*N_active*D forward-only (prefill/decode-step)."""
    if step == "train":
        tokens = shape["batch"] * shape["seq"]
        return 6.0 * active_params * tokens
    if step == "prefill":
        tokens = shape["batch"] * shape["seq"]
        return 2.0 * active_params * tokens
    tokens = shape["batch"] * 1  # one decode step
    return 2.0 * active_params * tokens


def count_params_from_shapes(params) -> int:
    """Elements of every tensor leaf of a (meta) parameter tree."""
    return int(sum(v.numel() for v in nn.tree_leaves(nn.unbox(params))
                   if hasattr(v, "numel")))


def active_param_count(cfg, total: int) -> int:
    """Subtract un-routed expert weight for MoE archs (top-k + shared)."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    sigs = cfg.layer_sigs()
    n_moe_layers = sum(1 for s in sigs if s["moe"])
    per_expert = 3 * cfg.d_model * m.d_ff_expert if m.gated else \
        2 * cfg.d_model * m.d_ff_expert
    all_experts = n_moe_layers * m.n_experts * per_expert
    used = n_moe_layers * m.top_k * per_expert
    return int(total - all_experts + used)
