"""Gemma3-1B: 5:1 local:global sliding-window, GQA kv=1, huge vocab
[hf:google/gemma-3-1b-pt] (ports ``repro/configs/gemma3_1b.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144, rope_theta=1e6, act="gelu",
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=512, qk_norm=True, post_block_norm=True, tie_embeddings=True,
    subquadratic=True,  # 22/26 layers are 512-token sliding window
)
