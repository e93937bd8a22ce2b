"""Analytic roofline model: FLOPs, HBM bytes and wire bytes per device
from first principles (ports ``repro/roofline/analytic.py``).

These terms are the dry run's primary roofline, as in the JAX package:
they depend on no compiler's cost analysis.  The arithmetic is the JAX
package's, term for term; only the hardware constants that turn the
terms into seconds are the H100's (``roofline/analysis.py``).

Strategy-aware: the ``rules_name`` argument mirrors
distributed.sharding.RULES_BY_NAME, so every sharding variant has a
matching analytic prediction.

Conventions (per global step, then / chips for per-device):
  train  : FLOPs = 4 x forward (fwd + 2x bwd + 1x remat fwd); 3 x fwd
           without remat
  prefill: FLOPs = 2 N_active D + attn fwd
  decode : FLOPs = 2 N_active B + attn-vs-cache   (one token)
  weights traffic (serving): bytes/param = dense 2.0 | int8/cfmm ~1.0 |
           sparse_cfmm (1-s) + 1/8 ~ 0.33 at s=0.8
  collectives: ring factors (AR 2x buffer, AG/RS 1x buffer).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.roofline.analysis import Roofline

BYTES_PER_PARAM = {"dense": 2.0, "int8": 1.0, "cfmm": 1.0,
                   "bitserial": 1.0, "sparse_cfmm": 0.2 * 1.0 + 1.0 / 8}


def _linear_params(cfg: ArchConfig, n_params: int) -> float:
    """Matmul-bearing params ~ everything except the embedding table."""
    emb = cfg.vocab * cfg.d_model
    return max(n_params - emb, 1)


def _tp_shardable_fraction(cfg: ArchConfig, tp: int) -> float:
    """Fraction of linear-param volume whose TP-sharded dim divides ``tp``
    (the divisibility guard replicates the rest — e.g. smollm's 15x64
    attention projections on a 16-way axis)."""
    if tp <= 1:
        return 1.0
    d = cfg.d_model
    attn_ok = (cfg.n_heads * cfg.head_dim) % tp == 0 and \
        (cfg.n_kv_heads * cfg.head_dim) % tp == 0
    ffn_ok = cfg.d_ff % tp == 0
    attn_vol = 2 * d * cfg.n_heads * cfg.head_dim + \
        2 * d * cfg.n_kv_heads * cfg.head_dim
    ffn_vol = 3 * d * cfg.d_ff
    total = attn_vol + ffn_vol
    ok = (attn_vol if attn_ok else 0) + (ffn_vol if ffn_ok else 0)
    return ok / total


def _attn_fwd_flops(cfg: ArchConfig, B: int, S: int) -> float:
    """QK^T + AV flops, causal-halved, window-clipped, per forward."""
    total = 0.0
    for sig in cfg.layer_sigs():
        if sig["kind"] != "attn":
            continue
        span = S if sig["attn_type"] != "local" else min(cfg.window or S, S)
        eff = S * span if sig["attn_type"] == "local" else S * S / 2
        total += 4.0 * B * eff * cfg.n_heads * cfg.head_dim
    if cfg.encoder_decoder:
        total *= 2
    return total


def _attn_decode_flops(cfg: ArchConfig, B: int, S: int) -> float:
    total = 0.0
    for sig in cfg.layer_sigs():
        if sig["kind"] != "attn":
            continue
        span = S if sig["attn_type"] != "local" else min(cfg.window or S, S)
        total += 4.0 * B * span * cfg.n_heads * cfg.head_dim
    return total


def _kv_cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    """Decode-step KV/state read volume (global)."""
    total = 0.0
    for sig in cfg.layer_sigs():
        if sig["kind"] == "attn":
            if cfg.mla:
                total += B * S * (cfg.mla.kv_lora + cfg.mla.qk_rope) * 2
            else:
                span = S if sig["attn_type"] != "local" else \
                    min(cfg.window or S, S)
                total += 2 * B * span * cfg.n_kv_heads * cfg.head_dim * 2
        elif sig["kind"] == "mamba":
            total += B * cfg.ssm.d_inner * cfg.ssm.d_state * 4
        elif sig["kind"] == "rwkv":
            hd = cfg.ssm.head_dim
            total += B * (cfg.d_model // hd) * hd * hd * 4
    return total


def _kv_shard_ways(cfg: ArchConfig, B: int, dp: int, tp: int,
                   rules_name: str) -> float:
    """How many ways the KV cache actually shards under the rules."""
    ways = min(dp, B) if B % min(dp, B) == 0 else 1
    if rules_name == "serve_splitkv":
        return ways * tp          # seq dim shards over 'model'
    if cfg.mla:
        return ways               # latent cache has no heads dim
    if cfg.n_kv_heads % tp == 0:
        return ways * tp
    return ways                   # heads not divisible -> replicated


def _expert_params(cfg: ArchConfig) -> float:
    if cfg.moe is None:
        return 0.0
    n_moe = sum(1 for s in cfg.layer_sigs() if s["moe"])
    per = (3 if cfg.moe.gated else 2) * cfg.d_model * cfg.moe.d_ff_expert
    return n_moe * cfg.moe.n_experts * per


def _moe_a2a_bytes(cfg: ArchConfig, B, S, dp) -> float:
    """MoE dispatch+combine all-to-all wire bytes per device per forward."""
    if cfg.moe is None:
        return 0.0
    n_moe = sum(1 for s in cfg.layer_sigs() if s["moe"])
    tokens_local = B * S / max(dp, 1)
    return n_moe * 2 * tokens_local * cfg.d_model * 2


def _tp_ar_bytes(cfg, B_local, S, tp) -> float:
    """TP activation all-reduce wire bytes per device per forward:
    2 ARs/layer x ring 2x buffer."""
    if tp <= 1:
        return 0.0
    n_layers = cfg.n_layers + (cfg.n_enc_layers or 0)
    buf = B_local * S * cfg.d_model * 2
    return n_layers * 2 * 2.0 * buf


@dataclasses.dataclass
class CellModel:
    flops_device: float
    hbm_device: float
    wire_device: float
    breakdown: dict


def model_cell(cfg: ArchConfig, shape_name: str, mesh_shape: dict,
               n_params: int, n_active: int, serve_mode: str = "cfmm",
               rules_name: str | None = None, remat: bool = True) -> CellModel:
    sh = SHAPES[shape_name]
    B, S, step = sh["batch"], sh["seq"], sh["step"]
    chips = int(np.prod(list(mesh_shape.values())))
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    tp = mesh_shape.get("model", 1)
    rules_name = rules_name or ("train" if step == "train" else "serve")
    if rules_name == "dp_only":
        dp, tp = dp * tp, 1
    elif rules_name == "ep_dp":
        tp = 1                    # no TP on non-expert linears
    B_local = max(B // min(dp, B), 1)
    n_lin = _linear_params(cfg, n_params)
    n_lin_active = _linear_params(cfg, n_active)

    if step == "train":
        D = B * S
        fwd = 2.0 * n_lin_active * D + _attn_fwd_flops(cfg, B, S)
        flops = (4.0 if remat else 3.0) * fwd
        # HBM: params ~3 reads bf16 + adam m/v rw f32 (16B) + master (8B);
        # activations ~12 boundary tensors per layer bf16.
        w_bytes = n_params * (3 * 2 + 16 + 8)
        act = 12.0 * cfg.n_layers * D * cfg.d_model * 2
        hbm = w_bytes + act
        # wire per device: FSDP all-gathers move only what this device
        # consumes — its TP/EP column slice when weights are 2D-sharded.
        e_params = _expert_params(cfg)
        ne_params = n_params - e_params
        tp0 = mesh_shape.get("model", 1)      # physical model-axis size
        if rules_name == "train":
            gathered = (ne_params + e_params) / tp0
        elif rules_name == "ep_dp" or rules_name == "dp_only":
            gathered = ne_params + e_params / tp0
        else:
            gathered = n_params
        fsdp = 3 * gathered * 2               # AG fwd + AG remat + RS grads
        pod = gathered * 2 if mesh_shape.get("pod", 1) > 1 else 0
        tp_ar = _tp_ar_bytes(cfg, B_local, S, tp) * 3
        a2a = _moe_a2a_bytes(cfg, B, S, dp if rules_name != "dp_only"
                             else dp) * 3
        wire = fsdp + pod + tp_ar + a2a
        return CellModel(flops / chips, hbm / chips, wire, dict(
            fwd_flops=fwd, attn_flops=_attn_fwd_flops(cfg, B, S),
            weight_bytes=w_bytes, act_bytes=act, fsdp_wire=fsdp,
            pod_wire=pod, tp_wire=tp_ar, a2a_wire=a2a, rules=rules_name))

    bpp = BYTES_PER_PARAM.get(serve_mode, 2.0)
    tp_frac = _tp_shardable_fraction(cfg, tp)
    w_shard = tp_frac * tp + (1 - tp_frac)          # effective shard ways

    if step == "prefill":
        D = B * S
        flops = 2.0 * n_lin_active * D + _attn_fwd_flops(cfg, B, S)
        w_dev = n_lin_active * bpp / w_shard
        act = 8.0 * cfg.n_layers * D * cfg.d_model * 2
        kv_write = _kv_cache_bytes(cfg, B, S)
        hbm_dev = w_dev + (act + kv_write) / chips
        wire = _tp_ar_bytes(cfg, B_local, S, tp)
        return CellModel(flops / chips, hbm_dev, wire, dict(
            weight_bytes_dev=w_dev, act_bytes=act, kv_bytes=kv_write,
            tp_wire=wire, rules=rules_name))

    # decode: one token
    flops = 2.0 * n_lin_active * B + _attn_decode_flops(cfg, B, S)
    kv_ways = _kv_shard_ways(cfg, B, dp, tp, rules_name)
    # compute replicates where KV replicates (same work on each shard)
    flops_dev = (2.0 * n_lin_active * B / min(chips, B * w_shard)
                 + _attn_decode_flops(cfg, B, S) / kv_ways)
    w_dev = n_lin_active * bpp / w_shard
    kv_dev = _kv_cache_bytes(cfg, B, S) / kv_ways
    hbm_dev = w_dev + kv_dev
    wire = _tp_ar_bytes(cfg, B_local, 1, tp)
    if rules_name == "serve_splitkv":
        n_attn = sum(1 for s_ in cfg.layer_sigs() if s_["kind"] == "attn")
        wire += n_attn * 2 * 2.0 * B_local * cfg.n_heads * \
            (cfg.head_dim + 2) * 4          # partial-softmax combines
    return CellModel(flops_dev, hbm_dev, wire, dict(
        weight_bytes_dev=w_dev, kv_bytes_dev=kv_dev, kv_shard_ways=kv_ways,
        tp_wire=wire, bytes_per_param=bpp, tp_shardable_frac=tp_frac,
        rules=rules_name))


def roofline_of(cfg: ArchConfig, shape_name: str, mesh_shape: dict,
                n_params: int, n_active: int, serve_mode="cfmm",
                model_flops: float = 0.0, rules_name: str | None = None,
                remat: bool = True) -> Roofline:
    m = model_cell(cfg, shape_name, mesh_shape, n_params, n_active,
                   serve_mode, rules_name, remat)
    chips = int(np.prod(list(mesh_shape.values())))
    return Roofline(m.flops_device, m.hbm_device, m.wire_device, chips,
                    model_flops)
