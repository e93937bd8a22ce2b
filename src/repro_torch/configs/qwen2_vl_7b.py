"""Qwen2-VL-7B backbone: M-RoPE (16/24/24 sections), vision tower stubbed
[arXiv:2409.12191] (ports ``repro/configs/qwen2_vl_7b.py``).  As in the
JAX package, ``frontend="vision"`` has no code: the backbone takes token
ids and, for image tokens, their 3-D (temporal, height, width) positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, pos="mrope", mrope_sections=(16, 24, 24),
    rope_theta=1e6, act="silu", frontend="vision",
)
