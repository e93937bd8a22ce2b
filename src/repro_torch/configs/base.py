"""Architecture config schema and registry of the LM stack (ports
``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig`` built in its own module
(``configs/<id>.py``); ``get_config`` resolves an id to it.  ``reduced()``
gives the family-preserving small config the CPU tests use.  The dry
run's ``SHAPES``, ``input_specs`` and ``cell_applicable`` come with the
launch modules that use them (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    gated: bool = True
    act: str = "silu"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"          # mamba | rwkv6
    d_inner: int = 0
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0
    head_dim: int = 64           # rwkv6
    decay_lora: int = 64         # rwkv6


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # attention
    attn_pattern: tuple = ("global",)   # cycled: 'global' | 'local'
    window: Optional[int] = None
    qk_norm: bool = False
    pos: str = "rope"            # rope | mrope | sinusoidal
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple] = None
    # block mix
    layer_pattern: tuple = ("attn",)    # cycled: 'attn' | 'mamba' | 'rwkv'
    moe: Optional[MoEConfig] = None
    moe_pattern: Optional[tuple] = None  # cycled bools; None -> all dense
    first_layer_dense: bool = False      # deepseek: layer 0 dense FFN
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    dec_len: int = 448
    frontend: Optional[str] = None       # 'audio' | 'vision' (stubbed)
    # misc
    act: str = "silu"
    norm: str = "rmsnorm"
    post_block_norm: bool = False        # gemma-style sandwich
    tie_embeddings: bool = False
    subquadratic: bool = False           # long_500k eligible
    norm_eps: float = 1e-6
    max_seq: int = 8192
    # JAX only (scan vs Python loop, activation checkpointing); kept so
    # both packages' configs compare equal.  The port always loops.
    unroll: bool = False
    remat: bool = True

    def layer_sigs(self):
        """Per-layer structural signature list."""
        sigs = []
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            is_moe = False
            if self.moe is not None:
                if self.moe_pattern is not None:
                    is_moe = self.moe_pattern[i % len(self.moe_pattern)]
                else:
                    is_moe = True
                if self.first_layer_dense and i == 0:
                    is_moe = False
            attn_type = (self.attn_pattern[i % len(self.attn_pattern)]
                         if kind == "attn" else None)
            sigs.append(dict(kind=kind, moe=is_moe, attn_type=attn_type,
                             index=i))
        return sigs

    def reduced(self):
        """Family-preserving tiny config for CPU smoke tests."""
        changes = dict(
            n_layers=max(min(self.n_layers, 4), len(self.layer_pattern),
                         len(self.attn_pattern),
                         len(self.moe_pattern or (True,))),
            d_model=128,
            n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                             // max(self.n_heads, 1))),
            head_dim=32, d_ff=256, vocab=512, max_seq=256, dec_len=16,
        )
        if self.encoder_decoder:
            changes["n_enc_layers"] = 2
            changes["n_layers"] = 2
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64)
        if self.ssm is not None:
            if self.ssm.kind == "mamba":
                changes["ssm"] = dataclasses.replace(
                    self.ssm, d_inner=256, d_state=8, dt_rank=8)
            else:
                changes["ssm"] = dataclasses.replace(self.ssm, head_dim=32,
                                                     decay_lora=16)
        if self.window is not None:
            changes["window"] = 32
        if self.mla is not None:
            changes["mla"] = MLAConfig(kv_lora=64, qk_nope=32, qk_rope=16,
                                       v_dim=32)
            changes["head_dim"] = 48
        if self.mrope_sections is not None:
            changes["mrope_sections"] = (8, 4, 4)
        return dataclasses.replace(self, **changes)


# the LM configs: every one of the JAX package's
ARCH_IDS = ("smollm_360m", "gemma3_1b", "stablelm_3b", "phi3_medium_14b",
            "jamba_v01_52b", "deepseek_v2_lite_16b", "olmoe_1b_7b",
            "rwkv6_7b", "whisper_small", "qwen2_vl_7b")


def get_config(name: str) -> ArchConfig:
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; the configs are "
                         f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
