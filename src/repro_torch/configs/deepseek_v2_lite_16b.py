"""DeepSeek-V2-Lite-16B: MLA kv_lora=512, 2 shared + 64 routed top-6
experts, first layer dense [arXiv:2405.04434] (ports
``repro/configs/deepseek_v2_lite_16b.py``).

Assignment-sheet note (DESIGN.md SS4): the free-text says "160 routed";
the structured field and the public config say 64 routed — we follow 64.
cfg.d_ff is the layer-0 dense FFN width (10944); expert width is 1408.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=10944, vocab=102400, rope_theta=1e4, act="silu",
    mla=MLAConfig(kv_lora=512, qk_nope=128, qk_rope=64, v_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    first_layer_dense=True,
)
