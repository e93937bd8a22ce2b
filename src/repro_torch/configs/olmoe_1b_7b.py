"""OLMoE-1B-7B: 64 experts top-8, qk-norm [arXiv:2409.02060] (ports
``repro/configs/olmoe_1b_7b.py``)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe_1b_7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, rope_theta=1e4, act="silu", qk_norm=True,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)
