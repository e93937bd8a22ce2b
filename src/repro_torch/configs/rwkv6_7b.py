"""RWKV6-7B "Finch": attention-free, data-dependent decay
[arXiv:2404.05892] (ports ``repro/configs/rwkv6_7b.py``)."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6_7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536, pos="none", act="relu",
    layer_pattern=("rwkv",),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora=64),
    subquadratic=True,
)
