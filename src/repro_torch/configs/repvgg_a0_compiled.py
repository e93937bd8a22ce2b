"""RepVGG-A0 Compiled CNN — the compile-time branch-fusion model-zoo
member (models/repvgg.py; serve the ``fuse_params`` output); ports
``repro/configs/repvgg_a0_compiled.py``."""
from repro_torch.models.repvgg import RepVGGConfig

CONFIG = RepVGGConfig(width_mult=1.0)
