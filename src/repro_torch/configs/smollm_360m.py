"""SmolLM-360M: llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-360M]
(ports ``repro/configs/smollm_360m.py``)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm_360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152, rope_theta=1e4, act="silu",
    tie_embeddings=True,
)
