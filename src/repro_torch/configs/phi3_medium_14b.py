"""Phi-3-medium-14B: RoPE SwiGLU GQA [arXiv:2404.14219] (ports
``repro/configs/phi3_medium_14b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3_medium_14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352, rope_theta=1e4, act="silu",
)
