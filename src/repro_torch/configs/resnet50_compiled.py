"""ResNet50 Compiled CNN — the paper's own network (models/resnet.py);
ports ``repro/configs/resnet50_compiled.py``."""
from repro_torch.models.resnet import ResNetConfig

CONFIG = ResNetConfig(width_mult=1.0)
