"""Jamba-v0.1-52B: Mamba+attention 1:7 interleave, MoE 16e top-2 every
second layer [arXiv:2403.19887] (ports ``repro/configs/jamba_v01_52b.py``).

One period of 8 layers holds every kind of block: Mamba with a dense
FFN, Mamba with the MoE, attention with a dense FFN."""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba_v01_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536, act="silu",
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_pattern=(False, True),
    ssm=SSMConfig(kind="mamba", d_inner=8192, d_state=16, d_conv=4,
                  dt_rank=256),
    subquadratic=True,  # attention in 4/32 layers only
)
