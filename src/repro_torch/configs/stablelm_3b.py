"""StableLM-3B: dense MHA (kv=heads), LayerNorm [hf:stabilityai] (ports
``repro/configs/stablelm_3b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm_3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304, rope_theta=1e4, act="silu", norm="layernorm",
)
